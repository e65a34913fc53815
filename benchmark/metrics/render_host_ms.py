"""Median host ms of the compiled frame's calls that captured nothing
(pt_frame: the frame key, the accumulator copies and the graph launch),
untraced calls only."""
from benchmark.spans import frame_host_s


def read(out, cell):
    s = frame_host_s(out)
    return None if s is None else 1000.0 * s
