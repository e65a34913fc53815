"""Median host seconds of the program's scene load (load_scene,
pt_setup.scene: parse, BVH build and the copies to the card)."""
from benchmark.spans import host_s


def read(out, cell):
    return host_s(out, "pt_setup.scene")
