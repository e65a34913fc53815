"""Within-run A/Bs of the bin-sort layout, for the port (the counterpart of
the repo's tools/exp_r5.py):

    python -m pathtracer_tpu_torch.tools.exp_r5 [mode] [scene.json] \
        [--res N] [--reps N] [--device cuda]

Modes:
  contig  the column-binned pipeline at passes 3, against BIN_CONTIGUOUS
          (65,536-lane sort runs) at passes 2 and 3, then the column one
          again, each the median ms of `--reps` intersections of the
          bounce-ray pool (tools/sweep_mesh.py);
  sorts   one segmented sort of 15 operands (an int32 key and 14 float32
          payloads) over the pool padded to whole 65,536-lane runs: column
          segments against contiguous runs (binned._seg_sort with
          BIN_CONTIGUOUS off and on);
  diag    per pass, the stream visits (distinct ids summed over the
          2,048-lane blocks), the blocks with a want and the most ids in a
          block, under both layouts at passes 3.
The JAX tool's `repart` and `repart_engine` modes are left out: they switch
the JAX package's treelet repartition (scene/types.py REPARTITION), which
the port's tables have no counterpart of.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import binned
from ..ops.binned import SUPPORT_LANES
from ..scene.types import TREELET_NONE
from ..utils.device import resolve_device
from .diag_bins import pass_tids
from .sweep_mesh import REPS, flags, run_binned, time_ms

MODES = ("contig", "sorts", "diag")


def contig(pool, reps: int = REPS, out=print) -> list:
    rows = []

    def row(label, ms):
        rows.append((label, ms))
        out(f"{label:20s}{ms:9.3f} ms")

    row("column p3 (prod)", run_binned(pool, reps, passes=3))
    with flags(BIN_CONTIGUOUS=True):
        for p in (2, 3):
            row(f"contiguous p{p}", run_binned(pool, reps, passes=p))
    row("column p3 (again)", run_binned(pool, reps, passes=3))
    return rows


def sort_operands(pool):
    """The sorts mode's key and 14 payloads, padded to whole 65,536-lane
    runs (exp_r5.py:76-84)."""
    n = pool.o.x.shape[0]
    n_pad = -(-n // binned.CONTIGUOUS) * binned.CONTIGUOUS
    dev = pool.device

    def pad(a, fill):
        return torch.cat([a, a.new_full((n_pad - n,), fill)])

    lane = torch.arange(n_pad, dtype=torch.int32, device=dev)
    payload = [pad(a, 0.0) for a in (pool.o.x, pool.o.y, pool.o.z,
                                     pool.d.x, pool.d.y, pool.d.z,
                                     pool.tb)] + [lane.float()] * 7
    key = (pad(pool.hit.to(torch.int32), 0) * 77 + lane % 163) % 163
    return key.to(torch.int32), payload


def sorts(pool, reps: int = REPS, out=print) -> dict:
    key, payload = sort_operands(pool)
    res = {}
    with torch.inference_mode():
        for on, tag in ((False, "column"), (True, "contiguous")):
            with flags(BIN_CONTIGUOUS=on):
                res[tag] = time_ms(lambda: binned._seg_sort(key, *payload),
                                   pool.device, reps)
            out(f"seg sort 15-op {tag:10s}: {res[tag]:8.3f} ms")
    return res


def visits(tid: np.ndarray, block: int = SUPPORT_LANES) -> list:
    """Distinct wanted ids in each `block`-lane stream block."""
    return [len(np.unique(b[b < TREELET_NONE]))
            for b in np.asarray(tid).reshape(-1, block)]


def diag(pool, out=print) -> dict:
    res = {}
    for on in (False, True):
        with flags(BIN_CONTIGUOUS=on):
            tids = pass_tids(pool, passes=3)
        tot = 0
        for p, tid in enumerate(tids):
            dist = visits(tid)
            out(f"contig={on} pass{p}: visits={sum(dist)} "
                f"live_blocks={sum(1 for x in dist if x)}/{len(dist)} "
                f"max_ids={max(dist)}")
            tot += sum(dist)
        out(f"contig={on} TOTAL visits={tot}")
        res[on] = tot
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.tools.exp_r5")
    ap.add_argument("mode", nargs="?", default="contig", choices=MODES)
    ap.add_argument("scene", nargs="?", default=None,
                    help="scene JSON (default: animal.json)")
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    from ..scene.fixtures import scene_path
    from .sweep_mesh import make_pool
    device = resolve_device(args.device)
    pool = make_pool(args.scene or scene_path("animal"), device,
                     {"RES": [args.res, args.res]} if args.res else None)
    out = lambda s: print(s, flush=True)
    out(f"{pool.path}: {pool.o.x.shape[0]} rays")
    if args.mode == "contig":
        return contig(pool, args.reps, out)
    if args.mode == "sorts":
        return sorts(pool, args.reps, out)
    return diag(pool, out)


if __name__ == "__main__":
    main()
