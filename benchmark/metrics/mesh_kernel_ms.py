"""Device ms an iteration of the program's mesh-intersection kernels (every
route's, by name: cull, stream, support, packet, wide, brute)."""
from benchmark.trace import is_mesh_kernel


def read(out, cell):
    t = out.trace
    if not t:
        return None
    s = sum(v for n, v in t["kernel_s"].items() if is_mesh_kernel(n))
    return 1000.0 * s / t["iterations"] if s > 0 else None
