"""Median host ms of lanes_to_image (pt_display.fetch: the device-to-host
copy of the averaged lanes to the numpy image), untraced calls only."""
from benchmark.spans import host_s


def read(out, cell):
    s = host_s(out, "pt_display.fetch")
    return None if s is None else 1000.0 * s
