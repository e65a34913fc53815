"""Distinct-id and support diagnostics of the binned intersector's stream,
for the port (the counterpart of the repo's tools/diag_bins.py):

    python -m pathtracer_tpu_torch.tools.diag_bins [scene.json] [--res N] \
        [--device cuda]

Feeds a bounce-ray pool (tools/sweep_mesh.py make_bounce_rays) through the
default pipeline with the `debug_tids` tap (ops/binned.py
mesh_intersect_binned: each pass's want ids after its bin sort) and
prints, per pass:
  - the live want count (lanes with a want this pass);
  - the distinct ids of each stream block of SUPPORT_LANES (2,048) pool
    lanes, the block csrc/stream.cu serves and the JAX kernel's 16 x 128:
    mean / p50 / p90 / max over the blocks with a want;
  - the support CDF: of the (block, id) visits, the share wanted by at most
    q lanes of the block;
  - the visit-cost model: the stream's total visits (the sum of distinct
    ids over the blocks) against the contiguous-runs ideal (live / 2,048
    + one straddle a block).
The lines are the JAX tool's, number for number.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.binned import SUPPORT_LANES, mesh_intersect_binned
from ..scene.types import TREELET_NONE
from ..utils.device import resolve_device

SUPPORT_QS = (1, 2, 4, 8, 16, 64, 256, 2048)


def pass_stats(tid: np.ndarray, block: int = SUPPORT_LANES) -> dict | None:
    """One pass's statistics from its post-bin want ids (the pool's lanes in
    order; a stream block is `block` consecutive lanes): None when no lane
    has a want."""
    tid = np.asarray(tid)
    live = int((tid < TREELET_NONE).sum())
    distinct, supports = [], []
    for b in range(tid.shape[0] // block):
        blk = tid[b * block:(b + 1) * block]
        ids, counts = np.unique(blk[blk < TREELET_NONE], return_counts=True)
        if len(ids) == 0:
            continue
        distinct.append(len(ids))
        supports.extend(counts.tolist())
    if not distinct:
        return None
    distinct = np.asarray(distinct)
    supports = np.asarray(supports)
    return {
        "live": live, "blocks": len(distinct),
        "mean": float(distinct.mean()),
        "p50": float(np.percentile(distinct, 50)),
        "p90": float(np.percentile(distinct, 90)),
        "max": int(distinct.max()), "visits": int(distinct.sum()),
        "ideal": live / block + len(distinct),
        "support_cdf": [float((supports <= q).mean()) for q in SUPPORT_QS],
    }


def pass_lines(p: int, st: dict | None) -> list:
    """The JAX tool's lines for pass `p` (diag_bins.py:60-84)."""
    if st is None:
        return [f"pass {p}: no live wants"]
    return [
        f"pass {p}: live {st['live']:7d}  blocks {st['blocks']:3d}  "
        f"distinct/blk mean {st['mean']:5.1f} "
        f"p50 {st['p50']:4.0f} "
        f"p90 {st['p90']:4.0f} "
        f"max {st['max']:4d}  total visits {st['visits']:6d} "
        f"(contig ideal ~{st['ideal']:6.0f})",
        "        support CDF " + "  ".join(
            f"<={q}:{f * 100:3.0f}%"
            for q, f in zip(SUPPORT_QS, st["support_cdf"]))]


def pass_tids(pool, **kw) -> list:
    """Each pass's post-bin want ids of the pool's default binned
    intersection, as numpy arrays."""
    with torch.inference_mode():
        out = mesh_intersect_binned(pool.scene, pool.roots, pool.o, pool.d,
                                    active=pool.hit, t_bound=pool.tb,
                                    debug_tids=True, **kw)
    return [t.cpu().numpy() for t in out[3]]


def diagnose(pool, out=print) -> list:
    """Prints the pool's per-pass lines; returns the per-pass stats."""
    tids = pass_tids(pool)
    out(f"{pool.path}: {pool.o.x.shape[0]} bounce rays, {len(tids)} passes, "
        f"stream block = {SUPPORT_LANES} lanes")
    stats = [pass_stats(t) for t in tids]
    for p, st in enumerate(stats):
        for line in pass_lines(p, st):
            out(line)
    return stats


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.tools.diag_bins")
    ap.add_argument("scene", nargs="?", default=None,
                    help="scene JSON (default: animal.json)")
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    from ..scene.fixtures import scene_path
    from .sweep_mesh import make_pool
    device = resolve_device(args.device)
    pool = make_pool(args.scene or scene_path("animal"), device,
                     {"RES": [args.res, args.res]} if args.res else None)
    return diagnose(pool, out=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
