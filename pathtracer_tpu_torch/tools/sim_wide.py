"""Pop-count simulator of the 8-wide walk, for the port (the counterpart of
the repo's tools/sim_wide.py):

    python -m pathtracer_tpu_torch.tools.sim_wide [scene.json] [--res 256] \
        [--rays N] [--packets N] [--no-sort] [--device cuda]

Replays, in NumPy on the host, the JAX kernel's control flow for 128-ray
packets (ops/wide.py: one stack a packet, far-to-near pushes, culling at
pop, leaves of 8-triangle groups) and counts its work units: node pops
(one 8-child slab tile), leaf pops (its groups' Moller-Trumbore tests) and
dead pops (culled at pop). The rays are a bounce-ray pool
(tools/sweep_mesh.py make_bounce_rays, made on `--device`; `--rays N`
keeps a strided sample of N of them), ordered by direction octant as the
JAX kernel's wrapper orders them; the tree is the port's wide build of
every mesh (scene/bvh8.py, as load_scene(wide_tables=True) builds it).
It ranks build and traversal variants by their counts; it measures no
time.
"""
from __future__ import annotations

import argparse

import numpy as np

FLT_MAX = 3.402823466e38
EPS = 1e-6


def pack_host_tables(wide_nodes, tris8):
    """Host mirror of the kernel's tables: per node the child boxes (8, 6),
    child records (8, 3) and split axis; the triangles' (T, 3) corners."""
    n = len(wide_nodes)
    boxes = np.full((n, 8, 6), np.nan, np.float32)
    recs = np.zeros((n, 8, 3), np.int64)
    axes = np.zeros((n,), np.int64)
    for i, nd in enumerate(wide_nodes):
        axes[i] = nd["axis"]
        for c, ((mn, mx), (k, a, b)) in enumerate(
                zip(nd["boxes"], nd["children"])):
            boxes[i, c, 0:3] = mn
            boxes[i, c, 3:6] = mx
            recs[i, c] = (k, a, b)
    tri = {k: np.asarray(v, np.float64) for k, v in tris8.items()}
    return boxes.astype(np.float64), recs, axes, tri


def simulate_packet(boxes, recs, axes, tri, root, o, d, act, tb):
    """One 128-ray packet through the walk: (node_pops, leaf_pops,
    dead_pops, t_min), t_min for checking."""
    inv = np.where(d != 0.0, 1.0 / d, np.copysign(np.inf, 1.0))
    t_min = np.where(act, tb, -FLT_MAX)
    sdir = d.sum(axis=1)   # the packet's direction sum on each axis

    stack = [(root, -FLT_MAX, False)]   # (entry, entry t, is a leaf)
    node_pops = leaf_pops = dead_pops = 0
    while stack:
        entry, te, is_leaf = stack.pop()
        if te >= t_min.max():
            dead_pops += 1
            continue
        if is_leaf:
            leaf_pops += 1
            g0, ng = entry
            for g in range(ng):
                t_min = mt_group(tri, g0 + g, o, d, t_min)
            continue
        node_pops += 1
        b = boxes[entry]
        tn = (b[:, None, 0:3] - o[None]) * inv[None]
        tf = (b[:, None, 3:6] - o[None]) * inv[None]
        t0 = np.minimum(tn, tf).max(axis=2)
        t1 = np.maximum(tn, tf).min(axis=2)
        want = (t0 <= t1) & (t1 > 0.0) & (t0 < t_min[None])
        wcnt = want.sum(axis=1)
        t0c = np.where(want, t0, FLT_MAX).min(axis=1)
        dsum = sdir[axes[entry]]
        order = range(8) if dsum >= 0 else range(7, -1, -1)
        # push far-to-near: visit near-to-far, push reversed
        pushes = []
        for c in order:
            if wcnt[c] == 0:
                continue
            k, a, bb = recs[entry, c]
            if k == 2:
                pushes.append(((a, bb), t0c[c], True))
            elif k == 1:
                pushes.append((a, t0c[c], False))
        stack.extend(reversed(pushes))
    return node_pops, leaf_pops, dead_pops, t_min


def mt_group(tri, g, o, d, t_min):
    """Moller-Trumbore of one 8-triangle group against the packet (hit t
    only)."""
    s = slice(g * 8, g * 8 + 8)
    v0, v1, v2 = tri["v0"][s], tri["v1"][s], tri["v2"][s]
    e1 = v1 - v0
    e2 = v2 - v0
    h = np.cross(d[None, :, :], e2[:, None, :])
    a = (e1[:, None, :] * h).sum(2)
    par = np.abs(a) < EPS
    f = 1.0 / np.where(par, 1.0, a)
    sv = o[None, :, :] - v0[:, None, :]
    u = f * (sv * h).sum(2)
    q = np.cross(sv, e1[:, None, :])
    v = f * (d[None, :, :] * q).sum(2)
    t = f * (e2[:, None, :] * q).sum(2)
    valid = (~par) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= EPS)
    t = np.where(valid, t, FLT_MAX).min(axis=0)
    return np.where(t < t_min, t, t_min)


def host_wide_tree(path: str):
    """The scene's wide forest built on the host as load_scene builds it:
    (tris8 dict of (T, 3) corners, wide_nodes, root)."""
    from ..scene import loader
    from ..scene.bvh8 import concat_wide

    meshes = []
    orig = loader.build_wide_bvh

    def capture(tris, *a, **k):
        meshes.append(orig(tris, *a, **k))
        return meshes[-1]

    loader.build_wide_bvh = capture
    try:
        loader.load_scene(path, "cpu", wide_tables=True)
    finally:
        loader.build_wide_bvh = orig
    wide_nodes, tris8, root = concat_wide(meshes)
    return tris8, wide_nodes, root


def octant_order(d, act):
    """The wrapper's coherence order: live lanes by direction octant, dead
    lanes last."""
    octant = ((d[:, 0] < 0) * 4 + (d[:, 1] < 0) * 2
              + (d[:, 2] < 0)).astype(np.int64)
    return np.argsort(np.where(act, octant, 8), kind="stable")


def simulate(tables, root, o, d, act, tb, packets: int = 0) -> dict:
    """Every 128-ray packet of the rays (numpy (N, 3) float64 o, d; [N]
    act, tb), the first `packets` where nonzero: totals of node, leaf and
    dead pops, and the packets with no live ray (skipped)."""
    boxes, recs, axes, tri = tables
    npk = o.shape[0] // 128
    if packets:
        npk = min(npk, packets)
    tot = np.zeros(3, np.int64)
    skipped = 0
    for p in range(npk):
        s = slice(p * 128, p * 128 + 128)
        if not act[s].any():
            skipped += 1
            continue
        r = simulate_packet(boxes, recs, axes, tri, root, o[s], d[s],
                            act[s], tb[s])
        tot += np.array(r[:3])
    return {"packets": npk, "skipped": skipped, "node": int(tot[0]),
            "leaf": int(tot[1]), "dead": int(tot[2]),
            "live_frac": float(act[:npk * 128].mean())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.tools.sim_wide")
    ap.add_argument("scene", nargs="?", default=None,
                    help="scene JSON (default: the teapot)")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--rays", type=int, default=0,
                    help="keep a strided sample of this many rays (0 = all)")
    ap.add_argument("--packets", type=int, default=0,
                    help="cap simulated packets (0 = all)")
    ap.add_argument("--no-sort", action="store_true",
                    help="skip the octant coherence sort")
    ap.add_argument("--device", default="cuda",
                    help="torch device the rays are made on (default cuda)")
    args = ap.parse_args(argv)
    from ..scene.fixtures import scene_path
    from ..utils.device import resolve_device
    from .sweep_mesh import make_pool
    path = args.scene or scene_path("teapot")
    pool = make_pool(path, resolve_device(args.device),
                     {"RES": [args.res, args.res]})
    h = lambda t: np.asarray(t.cpu())
    o = np.stack([h(c) for c in pool.o], 1).astype(np.float64)
    d = np.stack([h(c) for c in pool.d], 1).astype(np.float64)
    act, tb = h(pool.hit), h(pool.tb).astype(np.float64)
    if args.rays and args.rays < o.shape[0]:
        sl = slice(None, None, o.shape[0] // args.rays)
        o, d, act, tb = (a[sl][:args.rays] for a in (o, d, act, tb))
    if not args.no_sort:
        order = octant_order(d, act)
        o, d, act, tb = o[order], d[order], act[order], tb[order]
    tris8, wide_nodes, root = host_wide_tree(path)
    res = simulate(pack_host_tables(wide_nodes, tris8), root, o, d, act, tb,
                   args.packets)
    live = max(res["packets"] - res["skipped"], 1)
    print(f"{path}: {res['packets']} packets ({res['skipped']} all-dead "
          f"skipped), {res['live_frac']:.2f} live frac")
    print(f"node pops {res['node']}  leaf pops {res['leaf']}  dead pops "
          f"{res['dead']}")
    print(f"per live packet: node {res['node'] / live:.1f}  leaf "
          f"{res['leaf'] / live:.1f}  dead {res['dead'] / live:.1f}")
    return res


if __name__ == "__main__":
    main()
