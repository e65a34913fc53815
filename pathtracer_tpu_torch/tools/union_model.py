"""NumPy cost model of packet-walk block unions under sort keys, for the
port (the counterpart of the repo's tools/union_model.py):

    python -m pathtracer_tpu_torch.tools.union_model [scene.json] \
        [max_leaf] [--res N] [--device cuda]

Counts, on the host, the work the packet walk would do if each block of
rays walked the UNION of its rays' wanted nodes: node steps and leaf-row
tests, for a strided sample of SAMPLE bounce rays (tools/sweep_mesh.py
make_bounce_rays, made on `--device`) sorted within chunks by two keys (a
direction-octant key, and octant over an origin Morton cell) at three block
sizes. A node is wanted when the ray enters its box closer than the
analytic bound (no tightening inside the mesh, so the counts are an upper
bound; the ranking between keys and block sizes is the point). The model
ms is the JAX tool's linear model of those counts, whose constants were
set for another chip's vector unit: it ranks keys and block sizes, and is
no time of this port. The scene's tables come from the port's load_scene
(`max_leaf`: the binary tree's leaf size).
"""
from __future__ import annotations

import argparse

import numpy as np

SAMPLE = 65536
CONFIGS = ((65536, 1024), (65536, 256), (65536, 128))   # (chunk, block)


def host_rays(o, d, hit, tb):
    """The pool as numpy arrays (ox, oy, oz, dx, dy, dz, act, tb)."""
    return tuple(np.asarray(a.cpu()) for a in (*o, *d, hit, tb))


def union_lines(path: str, scene, ox, oy, oz, dx, dy, dz, act, tb) -> list:
    """The JAX tool's output lines (union_model.py:50-121) for the rays
    (numpy [N], N >= SAMPLE) and the scene's binary BVH."""
    n_all = ox.shape[0]
    scale = n_all / SAMPLE
    step = n_all // SAMPLE
    sl = slice(None, SAMPLE * step, step)   # strided: spatially representative
    ox, oy, oz, dx, dy, dz, act, tb = (a[sl] for a in (ox, oy, oz, dx, dy,
                                                       dz, act, tb))
    n = ox.shape[0]
    bvh = scene.bvh
    h = lambda t: np.asarray(t.cpu())
    bmin = np.stack([h(bvh.min_x), h(bvh.min_y), h(bvh.min_z)], 1)
    bmax = np.stack([h(bvh.max_x), h(bvh.max_y), h(bvh.max_z)], 1)
    tri_count = h(bvh.tri_count)
    nn = bmin.shape[0]
    lines = [f"{path}: {nn} nodes, {int(tri_count.sum())} tris, "
             f"{n} rays ({act.mean():.2f} active)"]

    # per-(ray, node) want: slab test with the static bound  [n, nn]
    O = np.stack([ox, oy, oz], 1)[:, None, :]
    D = np.stack([dx, dy, dz], 1)[:, None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / D
        tn = (bmin[None] - O) * inv
        tf = (bmax[None] - O) * inv
    t0 = np.minimum(tn, tf).max(axis=2)
    t1 = np.maximum(tn, tf).min(axis=2)
    want = act[:, None] & (t0 <= t1) & (t1 > 0) & (t0 < tb[:, None])
    lines.append(f"mean wanted nodes/ray (active): "
                 f"{want.sum(1)[act].mean():.1f} of {nn}")

    leaf_rows = np.where(tri_count > 0, -(-tri_count // 6), 0)
    octant = (dx < 0) * 4 + (dy < 0) * 2 + (dz < 0) * 1
    fine = ((dx < 0) * 4 + (dy < 0) * 2 + (dz < 0)) * 8 + \
        (np.abs(dx) > np.abs(dy)) * 4 + (np.abs(dy) > np.abs(dz)) * 2 + \
        (np.abs(dx) > np.abs(dz))
    # origin cell: Morton-interleaved 4-bit quantization over the origins'
    # box; the composite key puts the direction octant above the cell
    lo = np.stack([ox, oy, oz], 1).min(0)
    hi = np.stack([ox, oy, oz], 1).max(0)
    q = np.clip(((np.stack([ox, oy, oz], 1) - lo) / np.maximum(hi - lo, 1e-9)
                 * 16).astype(np.int64), 0, 15)

    def spread2(v):
        v = (v | (v << 8)) & 0x00F00F
        v = (v | (v << 4)) & 0x0C30C3
        v = (v | (v << 2)) & 0x249249
        return v

    morton = spread2(q[:, 0]) | (spread2(q[:, 1]) << 1) | \
        (spread2(q[:, 2]) << 2)
    oct_morton = octant.astype(np.int64) << 12 | morton

    for key_name, key in (("fine6", fine.astype(np.int64)),
                          ("oct_morton", oct_morton)):
        for chunk, block in CONFIGS:
            nodes, rows, ms = block_union_cost(want, leaf_rows, act, key,
                                               chunk, block, scale)
            lines.append(f"  key={key_name:12s} chunk={chunk:6d} "
                         f"block={block:5d}: nodes={nodes:9d} "
                         f"leaf_rows={rows:9d} model={ms:7.1f} ms")
    return lines


def block_union_cost(want, leaf_rows, act, key, chunk: int, block: int,
                     scale: float):
    """Sort within chunks by (dead?, key); each block walks the union of its
    rays' wants. Returns (node steps, leaf rows, model ms)."""
    n = want.shape[0]
    tot_nodes = tot_rows = 0
    order = np.arange(n)
    k = np.where(act, key, key.max() + 1)
    for c0 in range(0, n, chunk):
        seg = order[c0:c0 + chunk]
        seg = seg[np.argsort(k[seg], kind="stable")]
        w = want[seg]
        nb = len(seg) // block
        u = w[:nb * block].reshape(nb, block, -1).any(axis=1)
        u = u[u[:, 0]]                       # blocks that enter the root
        tot_nodes += int(u.sum()) * 2        # ENTER + ADVANCE
        tot_rows += int((u @ leaf_rows).sum())
    step_ns = 50 + 6.25 * block / 1024
    row_ns = 6 * 70 * (block / 128) / 4
    ms = (tot_nodes * step_ns + tot_rows * row_ns) * 1e-6 * scale
    return tot_nodes, tot_rows, ms


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.tools.union_model")
    ap.add_argument("scene", nargs="?", default=None,
                    help="scene JSON (default: the teapot)")
    ap.add_argument("max_leaf", nargs="?", type=int, default=96)
    ap.add_argument("--res", type=int, default=None,
                    help="square resolution (at least 256: SAMPLE rays)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the rays are made on (default cuda)")
    args = ap.parse_args(argv)
    from ..scene.fixtures import scene_path
    from ..utils.device import resolve_device
    from .sweep_mesh import make_pool
    path = args.scene or scene_path("teapot")
    pool = make_pool(path, resolve_device(args.device),
                     {"RES": [args.res, args.res]} if args.res else None,
                     max_leaf=args.max_leaf)
    lines = union_lines(path, pool.scene,
                        *host_rays(pool.o, pool.d, pool.hit, pool.tb))
    for line in lines:
        print(line, flush=True)
    return lines


if __name__ == "__main__":
    main()
