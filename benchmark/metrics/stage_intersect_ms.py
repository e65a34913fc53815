"""Median device ms an iteration of the compiled frame's pt_intersect, summed
over its bounces (the analytic closest hit and, on a mesh, the binned
pipeline), from the program's timed events inside the frame's timed graph:
one sample a timed replay (at most one a second, the last iteration of a
render_chunk call), untraced replays only."""
from benchmark.spans import device_ms


def read(out, cell):
    return device_ms(out, "pt_intersect")
