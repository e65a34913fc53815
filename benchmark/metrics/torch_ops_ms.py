"""Device ms an iteration of every kernel that is not one of the program's
own CUDA kernels (benchmark/trace.py OWN_KERNELS): the torch ops of
raygen, the analytic intersect, shade, gather and the binned glue and
sorts."""
from benchmark.trace import is_own_kernel


def read(out, cell):
    t = out.trace
    if not t:
        return None
    s = sum(v for n, v in t["kernel_s"].items() if not is_own_kernel(n))
    return 1000.0 * s / t["iterations"] if s > 0 else None
