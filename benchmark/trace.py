"""Reading a torch.profiler trace of a steady sub-window of a run.

The program's own CUDA kernels are known by name (a frozen list of the
__global__ functions of pathtracer_tpu_torch/csrc, matched as whole
words); every other device kernel is a torch op. The device-side spans of
the program's profiler ranges are not kernels (they cover kernels) and are
left out, as are the spans of the benchmark's own ranges. The traced
window is the benchmark's range `WINDOW`, on the host's side of the same
clock. Busy is the union of every device interval (kernels, copies,
fills) inside it; the profiler stretches the window's wall time, so the
idle share that follows reads higher than it is untraced.
"""
from __future__ import annotations

import contextlib
import re

WINDOW = "bench.window"
# the program's mesh-intersection kernels (csrc/cull.cu, stream.cu,
# packet.cu, wide.cu, brute.cu) and its scan (csrc/scan.cu)
MESH_KERNELS = ("cull_kernel", "stream_kernel", "support_kernel",
                "packet_kernel_compact", "packet_kernel_walk",
                "wide_compact_kernel", "wide_push_kernel", "wide_mask_kernel",
                "brute_kernel")
OWN_KERNELS = MESH_KERNELS + ("scan_kernel",)
# the program's profiler ranges (engine/wavefront.py, ops/binned.py)
RANGES = frozenset(("pt_raygen", "pt_intersect", "pt_shade", "pt_gather",
                    "pt_mi_sort", "pt_mi_cull", "pt_mi_stream", "pt_mi_fb"))
_WORD = r"(?<![A-Za-z0-9_])({})(?![A-Za-z0-9_])"
_MESH = re.compile(_WORD.format("|".join(MESH_KERNELS)))
_OWN = re.compile(_WORD.format("|".join(OWN_KERNELS)))
TOP = 10
NAME = 160          # characters of a kernel's name kept in the breakdown


def is_mesh_kernel(name: str) -> bool:
    return _MESH.search(name) is not None


def is_own_kernel(name: str) -> bool:
    return _OWN.search(name) is not None


def is_copy(name: str) -> bool:
    """A device copy or fill rather than a kernel."""
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def span(enabled: bool, name: str):
    """A profiler range named `name` where `enabled`, else nothing."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def profiler(device):
    """torch.profiler over the host and, on a CUDA device, the card."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def union(intervals) -> float:
    """The length covered by (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [g for g in out if g[1] > g[0]]


def _events(prof):
    """(host events, device events) as (name, start_us, end_us)."""
    from torch.autograd import DeviceType
    host, dev = [], []
    for e in prof.events():
        rec = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if e.name in RANGES or e.name.startswith("bench.") or getattr(
                    e, "is_user_annotation", False):
                continue
            dev.append(rec)
        elif e.device_type == DeviceType.CPU:
            host.append(rec)
    return host, dev


def summarize(host: list, dev: list, iterations: int) -> dict | None:
    """The traced window's reading from host and device events (name,
    start_us, end_us): None where the window span is missing."""
    wins = [(s, e) for n, s, e in host if n == WINDOW]
    if not wins:
        return None
    lo, hi = wins[-1]
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in dev
              if e > lo and s < hi]
    kernels = [(n, s, e) for n, s, e in inside if not is_copy(n)]
    by_name = {}
    for n, s, e in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    busy = [(s, e) for _, s, e in inside]
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    labels = []
    for s, e in idle:
        mid = 0.5 * (s + e)
        over = [(hs, n) for n, hs, he in host
                if hs <= mid <= he and n != WINDOW]
        labels.append([max(over)[1] if over else "host, untraced",
                       (e - s) * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "iterations": iterations,
        "window_s": (hi - lo) * 1e-6,
        "busy_s": union(busy) * 1e-6,
        "n_kernels": len(kernels),
        "kernel_s": {n: s for n, s in by_name.items() if not is_copy(n)},
        "breakdown": {"device_ops": [[n[:NAME], s] for n, s in top],
                      "idle_gaps": labels},
    }


def read(prof, iterations: int) -> dict | None:
    """summarize() of a finished torch.profiler.profile."""
    host, dev = _events(prof)
    return summarize(host, dev, iterations)
