"""Stage-prefix timing of the binned pipeline, for the port (the
counterpart of the repo's tools/profile_binned2.py): time the pipeline run
up to successive cut points; differences attribute cost a stage.

    python -m pathtracer_tpu_torch.tools.profile_binned2 [scene.json] \
        [passes] [--res N] [--reps N] [--device cuda]

`pipeline` is a replica of ops/binned.py mesh_intersect_binned's default
shape (the candidate sort keyed by pid, `passes` cull -> bin -> stream
rounds, the final cull, the compaction sort above PASSES_BIG_TRIS
triangles, the exact packet walk, the unsort) that stops at `stop`:
0 after the initial sort; 1000 + p after pass p + 1's cull; p + 1 after
pass p + 1's stream; 100 after the final cull; 200 after the exact finish;
300 the whole pipeline, whose (t, normal, mat) equal mesh_intersect_binned's
bit for bit (tests/test_torch_measure_tools.py). A replica is kept, as the
JAX tool keeps one: the ablation flags can cut whole stages (FALLBACK,
STREAM_OFF, CULL_CHEAP; tools/sweep_mesh.py `split`), but not stop after
a pass's cull or before the unsort. It calls the pipeline's own kernel
wrappers and sort (binned.cull, binned.stream, binned._seg_sort,
binned._packet_fallback). Each cut is the median ms of `--reps` calls
(tools/sweep_mesh.py time_ms).
"""
from __future__ import annotations

import argparse

import torch

from ..ops import binned
from ..ops.bvh_packet import root_candidates
from ..scene.types import TREELET_NONE, TRIS_PER_ROW
from ..utils.device import resolve_device
from ..utils.vec import Vec3
from .sweep_mesh import REPS, time_ms

NAMES = {0: "cand+sort0", 1000: "  +cull1", 1: "  +bin1+stream1",
         1001: "  +cull2", 2: "  +bin2+stream2", 1002: "  +cull3",
         3: "  +bin3+stream3", 100: "  +final cull", 200: "  +fallback",
         300: "  +unsort (full)"}


def pipeline(scene, mesh_roots, origin: Vec3, direction: Vec3, active,
             t_bound, passes: int | None = None, stop: int = 300):
    """The default binned pipeline cut at `stop` (module docstring). Returns
    the live state at the cut; at 300, (t, normal Vec3, mat); at 100, the
    residual lane mask first."""
    n_tris = scene.tris_packed.shape[0] * TRIS_PER_ROW
    big = n_tris > binned.PASSES_BIG_TRIS
    if passes is None:
        passes = 3 if big else 2
    n = origin.x.shape[0]
    dev = origin.x.device
    n_pad = -(-n // binned.POOL_ALIGN) * binned.POOL_ALIGN

    def prep(a, fill):
        return torch.cat([a, a.new_full((n_pad - n,), fill)])

    def cull(bound, pt0, pid):
        live = (pid < TREELET_NONE).to(torch.int32)
        return binned.cull(scene.treelet_f, scene.treelet_super, ox, oy, oz,
                           dx, dy, dz, bound, pt0, pid, live)

    act = root_candidates(scene, mesh_roots, origin, direction, active,
                          t_bound)
    ox, oy, oz = (prep(c, 0.0) for c in origin)
    dx, dy, dz = (prep(c, 1.0) for c in direction)
    bound = prep(t_bound, 0.0)
    lane = torch.arange(n_pad, dtype=torch.int32, device=dev) // 128
    pt0 = torch.full((n_pad,), binned.NEG_MAX, device=dev)
    pid = torch.where(prep(act, False), -1, TREELET_NONE).to(torch.int32)
    (pid, ox, oy, oz, dx, dy, dz, bound, pt0, lane) = binned._seg_sort(
        pid, ox, oy, oz, dx, dy, dz, bound, pt0, lane)
    best = [torch.full((n_pad,), -1.0, device=dev)] + [
        torch.zeros(n_pad, device=dev) for _ in range(3)] + [
        torch.full((n_pad,), -1, dtype=torch.int32, device=dev)]
    if stop == 0:
        return [pid, ox, oy, oz, dx, dy, dz, bound, pt0, lane, *best]
    for p in range(passes):
        tid, tt0 = cull(bound, pt0, pid)
        if stop == 1000 + p:
            return [tid, tt0, ox, oy, oz, dx, dy, dz, bound, lane, *best]
        (tid, ox, oy, oz, dx, dy, dz, bound, tt0, lane,
         *best) = binned._seg_sort(tid, ox, oy, oz, dx, dy, dz, bound, tt0,
                                   lane, *best)
        t, *outs = binned.stream(scene.treelet_i, scene.tris_packed,
                                 scene.tre_rows, ox, oy, oz, dx, dy, dz,
                                 bound, tid)
        hit = t > 0.0
        best = [torch.where(hit, a, b) for a, b in zip([t] + outs, best)]
        bound = torch.where(hit, t, bound)
        pt0, pid = tt0, tid
        if stop == p + 1:
            return [ox, oy, oz, dx, dy, dz, bound, pt0, pid, lane, *best]
    bt, bnx, bny, bnz, bmat = best
    tid_f, _ = cull(bound, pt0, pid)
    remaining = (pid < TREELET_NONE) & (tid_f < TREELET_NONE)
    if big:
        key = torch.where(remaining, 0, 1).to(torch.int32)
        (key, ox, oy, oz, dx, dy, dz, bound, lane,
         bt, bnx, bny, bnz, bmat) = binned._seg_sort(
            key, ox, oy, oz, dx, dy, dz, bound, lane, bt, bnx, bny, bnz,
            bmat)
        remaining = key == 0
    if stop == 100:
        return [remaining, ox, oy, oz, dx, dy, dz, bound, lane,
                bt, bnx, bny, bnz, bmat]
    t, nrm, mat = binned._packet_fallback(
        scene, mesh_roots, Vec3(ox, oy, oz), Vec3(dx, dy, dz), remaining,
        bound)
    hit = t > 0.0
    bt = torch.where(hit, t, bt)
    bnx = torch.where(hit, nrm.x, bnx)
    bny = torch.where(hit, nrm.y, bny)
    bnz = torch.where(hit, nrm.z, bnz)
    bmat = torch.where(hit, mat, bmat)
    if stop == 200:
        return [bt, bnx, bny, bnz, bmat, lane]
    lane, bt, bnx, bny, bnz, bmat = binned._seg_sort(lane, bt, bnx, bny,
                                                     bnz, bmat)
    return bt[:n], Vec3(bnx[:n], bny[:n], bnz[:n]), bmat[:n]


def cuts(passes: int) -> list:
    """The cut points in pipeline order."""
    out = [0]
    for p in range(passes):
        out += [1000 + p, p + 1]
    return out + [100, 200, 300]


def prefix_times(pool, passes: int | None = None, reps: int = REPS,
                 out=print) -> dict:
    """{cut: median ms} for every cut of the pool's pipeline, and the
    residual lanes at the fallback under "remaining"."""
    if passes is None:
        n_tris = pool.scene.tris_packed.shape[0] * TRIS_PER_ROW
        passes = 3 if n_tris > binned.PASSES_BIG_TRIS else 2
    res = {}
    with torch.inference_mode():
        for c in cuts(passes):
            res[c] = time_ms(lambda c=c: pipeline(
                pool.scene, pool.roots, pool.o, pool.d, pool.hit, pool.tb,
                passes, c), pool.device, reps)
            out(f"{NAMES.get(c, str(c)):20s}: {res[c]:9.3f} ms")
        rem = pipeline(pool.scene, pool.roots, pool.o, pool.d, pool.hit,
                       pool.tb, passes, 100)[0]
        res["remaining"] = int(rem.sum())
    out(f"remaining lanes at fallback: {res['remaining']}")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.tools.profile_binned2")
    ap.add_argument("scene", nargs="?", default=None,
                    help="scene JSON (default: the teapot)")
    ap.add_argument("passes", nargs="?", type=int, default=None,
                    help="passes (default: the pipeline's adaptive count)")
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
    return prefix_times(pool, args.passes, args.reps,
                        out=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
