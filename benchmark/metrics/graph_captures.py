"""CUDA graphs the program captured in the run's process (the recorder's
`captures` counter): 1 where every call after set-up replays one graph."""
from benchmark.spans import counter


def read(out, cell):
    return counter(out, "captures")
