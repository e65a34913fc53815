"""Per-stage timing of the binned intersector on a bounce-ray pool, for the
port (the counterpart of the repo's tools/profile_binned.py):

    python -m pathtracer_tpu_torch.tools.profile_binned [scene.json] \
        [--res N] [--reps N] [--device cuda]

Prints, each the median ms of `--reps` calls (tools/sweep_mesh.py
time_ms: CUDA events on the card):
  - the pipeline at passes 0 (candidacy, the initial sort and the exact
    finish of every candidate), 1 and 2, and the packet walk alone;
  - the cull alone on the unsorted pool (live = the primary hit);
  - one segmented sort of 16 operands over the pool (binned._seg_sort);
  - every `_seg_sort` call of one default intersection, by call site
    (ops/binned.py line): operands, key dtype, lanes and ms; on the card
    also device ms and device kernels a call by torch.profiler, with the
    kernels' names (`sort_sites`).
"""
from __future__ import annotations

import argparse
import sys
from unittest import mock

import torch

from ..ops import binned
from ..ops.bvh_packet import mesh_intersect_packet
from ..scene.types import TREELET_NONE
from ..utils.device import resolve_device
from .sweep_mesh import REPS, run_binned, time_ms


def padded(a: torch.Tensor, n_pad: int, fill) -> torch.Tensor:
    return torch.cat([a, a.new_full((n_pad - a.shape[0],), fill)])


def pool_planes(pool):
    """The pool's ray planes padded to whole stream blocks: (n_pad, ox, oy,
    oz, dx, dy, dz, bound)."""
    n = pool.o.x.shape[0]
    n_pad = -(-n // binned.POOL_ALIGN) * binned.POOL_ALIGN
    o = [padded(c, n_pad, 0.0) for c in pool.o]
    d = [padded(c, n_pad, 1.0) for c in pool.d]
    return (n_pad, *o, *d, padded(pool.tb, n_pad, 0.0))


def device_kernels(fn, reps: int = 5) -> dict:
    """torch.profiler over `reps` calls of fn() on the card: {device kernel
    or memset name: (ms a call, launches a call)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1000.0 / reps,
                    e.count / reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def sort_calls(pool, **kw) -> list:
    """Every binned._seg_sort call of one intersection of the pool
    (`kw`: mesh_intersect_binned's arguments), in order: (call site
    "binned.py:LINE", key, payloads)."""
    calls = []
    orig = binned._seg_sort

    def recording(key, *arrays):
        calls.append((f"binned.py:{sys._getframe(1).f_lineno}", key, arrays))
        return orig(key, *arrays)

    with torch.inference_mode(), mock.patch.object(binned, "_seg_sort",
                                                   recording):
        binned.mesh_intersect_binned(pool.scene, pool.roots, pool.o, pool.d,
                                     active=pool.hit, t_bound=pool.tb, **kw)
    return calls


def sort_sites(pool, reps: int = REPS, out=print, **kw) -> list:
    """Times each _seg_sort call of one intersection on its own inputs;
    prints one line a call and returns a record a call."""
    recs = []
    for site, key, arrays in sort_calls(pool, **kw):
        call = lambda k=key, a=arrays: binned._seg_sort(k, *a)
        with torch.inference_mode():
            rec = {"site": site, "operands": 1 + len(arrays),
                   "key_dtype": str(key.dtype).replace("torch.", ""),
                   "lanes": key.shape[0],
                   "ms": time_ms(call, pool.device, reps)}
            if pool.device.type == "cuda":
                kern = device_kernels(call)
                rec["device_ms"] = sum(ms for ms, _ in kern.values())
                rec["device_kernels"] = sum(n for _, n in kern.values())
                rec["kernels"] = {k: v for k, v in sorted(
                    kern.items(), key=lambda kv: -kv[1][0])}
        recs.append(rec)
        line = (f"  {rec['site']:15s} {rec['operands']:3d} operands, key "
                f"{rec['key_dtype']}, {rec['lanes']} lanes: "
                f"{rec['ms']:8.3f} ms")
        if "device_ms" in rec:
            line += (f", {rec['device_ms']:.3f} device ms in "
                     f"{rec['device_kernels']:.0f} kernels")
        out(line)
        for name, (ms, n) in rec.get("kernels", {}).items():
            out(f"      {ms:8.4f} ms {n:5.1f}x  {name[:100]}")
    return recs


def profile(pool, reps: int = REPS, out=print) -> dict:
    """Every timing of the module docstring; returns them by label."""
    res = {}

    def row(label, ms):
        res[label] = ms
        out(f"{label:38s}{ms:9.3f} ms")

    dev = pool.device
    row("passes=0 (cand sort + FULL fallback)",
        run_binned(pool, reps, passes=0))
    row("passes=1", run_binned(pool, reps, passes=1))
    row("passes=2", run_binned(pool, reps, passes=2))
    with torch.inference_mode():
        row("packet alone", time_ms(lambda: mesh_intersect_packet(
            pool.scene, pool.roots[0], pool.o, pool.d, active=pool.hit,
            t_bound=pool.tb), dev, reps))
        n_pad, ox, oy, oz, dx, dy, dz, tb = pool_planes(pool)
        live = padded(pool.hit.to(torch.int32), n_pad, 0)
        pt0 = torch.full((n_pad,), binned.NEG_MAX, device=dev)
        pid = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
        sc = pool.scene
        row("cull alone (unsorted pool, live=hit)", time_ms(
            lambda: binned.cull(sc.treelet_f, sc.treelet_super, ox, oy, oz,
                                dx, dy, dz, tb, pt0, pid, live), dev, reps))
        lane = torch.arange(n_pad, dtype=torch.int32, device=dev) // 128
        payload = [ox, oy, oz, dx, dy, dz, tb] + [lane] * 8
        key = torch.where(live > 0, 0, TREELET_NONE).to(torch.int32)
        row("seg sort 16 operands", time_ms(
            lambda: binned._seg_sort(key, ox, *payload), dev, reps))
    out("the _seg_sort calls of one default intersection:")
    res["sort_sites"] = sort_sites(pool, reps, out)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.tools.profile_binned")
    ap.add_argument("scene", nargs="?", default=None,
                    help="scene JSON (default: the teapot)")
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    from ..scene.fixtures import scene_path
    from .sweep_mesh import make_pool
    device = resolve_device(args.device)
    pool = make_pool(args.scene or scene_path("teapot"), device,
                     {"RES": [args.res, args.res]} if args.res else None)
    print(f"{pool.path}: {pool.o.x.shape[0]} rays", flush=True)
    return profile(pool, args.reps, out=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
