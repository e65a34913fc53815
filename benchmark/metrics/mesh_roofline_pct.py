"""The mesh kernels' share of their roofline: the least time the closest
hits of an iteration need (benchmark/roofline.py: bytes over the card's
bandwidth) over the mesh kernels' device time an iteration."""
from benchmark import roofline
from benchmark.trace import is_mesh_kernel


def read(out, cell):
    t = out.trace
    live = out.counters.get("live_lanes")
    if not t or not live:
        return None
    s = sum(v for n, v in t["kernel_s"].items() if is_mesh_kernel(n))
    if s <= 0:
        return None
    bound_s = roofline.closest_hit_seconds(live, roofline.n_triangles(cell))
    return 100.0 * bound_s / (s / t["iterations"])
