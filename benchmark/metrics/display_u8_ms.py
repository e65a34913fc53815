"""Median host ms of to_uint8 (pt_display.u8: the clamp, scale and cast
of the image), untraced calls only."""
from benchmark.spans import host_s


def read(out, cell):
    s = host_s(out, "pt_display.u8")
    return None if s is None else 1000.0 * s
