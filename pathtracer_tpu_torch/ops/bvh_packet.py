"""Packet BVH walk: the port of pathtracer_tpu/ops/bvh_pallas.py
(`_packet_kernel`, :70, and `mesh_intersect_packet`, :252-308).

Contract, as in the JAX package: per active lane, the TRUE closest hit
strictly below t_bound over one mesh's BVH (no reference pruning quirk),
normal normalized and faced toward the ray; t = -1, mat = -1 on a miss.
Inactive lanes report a miss (the TPU kernel may record stray hits for them,
which no caller reads).

`packet_walk` launches csrc/packet.cu for CUDA tensors and runs
`packet_walk_plain`, the same per-ray stackless walk in plain PyTorch, for CPU
tensors. The binned intersector (ops/binned.py) runs it as its exact fallback.
"""
from __future__ import annotations

import torch

from ..scene.types import TRI_STRIDE, TRIS_PER_ROW
from ..utils.vec import Vec3
from . import kernels

FLT_MAX = 3.402823466e38
LANE_CHUNK = 1 << 15   # lanes per block of [lanes, triangles] work


def tri_table(tris_packed: torch.Tensor) -> torch.Tensor:
    """[rows, 128] packed triangles -> [rows * 6, 20] records."""
    return tris_packed[:, :TRIS_PER_ROW * TRI_STRIDE].reshape(-1, TRI_STRIDE)


def closest_hit(tri_tab, idx, mask, ox, oy, oz, dx, dy, dz, t_min):
    """Moller-Trumbore of lane l against triangles tri_tab[idx[l, k]]
    (where mask[l, k]), keeping the first triangle of smallest t strictly
    below t_min[l]: the result of testing them one after another in k order
    with strict `<`, as the kernels do. Returns (hit, t, raw nx, ny, nz,
    mat) of the winner; the other values are don't-cares where ~hit."""
    rec = tri_tab[idx]                      # [L, K, 20]
    f = lambda c: rec[..., c]
    o = [a[:, None] for a in (ox, oy, oz)]
    d = [a[:, None] for a in (dx, dy, dz)]
    e1x, e1y, e1z, e2x, e2y, e2z = (f(c) for c in range(3, 9))
    hx = d[1] * e2z - d[2] * e2y
    hy = d[2] * e2x - d[0] * e2z
    hz = d[0] * e2y - d[1] * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    parallel = torch.abs(a) < 1e-6
    inv = 1.0 / torch.where(parallel, 1.0, a)
    sx, sy, sz = o[0] - f(0), o[1] - f(1), o[2] - f(2)
    u = inv * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = inv * (d[0] * qx + d[1] * qy + d[2] * qz)
    t = inv * (e2x * qx + e2y * qy + e2z * qz)
    ok = (mask & ~parallel & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & ((u + v) <= 1.0) & (t >= 1e-6) & (t > 0.0)
          & (t < t_min[:, None]))
    tk = torch.where(ok, t, float("inf"))
    k = torch.argmin(tk, dim=1, keepdim=True)   # first of the smallest
    hit = ok.any(dim=1)
    pick = lambda x: torch.gather(x, 1, k)[:, 0]
    uw, vw = pick(u), pick(v)
    w = 1.0 - uw - vw
    nrm = [w * pick(f(9 + c)) + uw * pick(f(12 + c)) + vw * pick(f(15 + c))
           for c in range(3)]
    return (hit, pick(t), nrm[0], nrm[1], nrm[2],
            pick(f(18)).to(torch.int32))


def finish_hits(t_min, nx, ny, nz, mat, dx, dy, dz, bound):
    """The kernels' epilogue: normalize and face the winning normal toward
    the ray; t = -1 and mat = -1 where nothing beat the bound."""
    inv_len = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                           min=1e-30))
    fl = torch.where(dx * nx + dy * ny + dz * nz > 0.0, -inv_len, inv_len)
    missed = t_min >= bound
    return (torch.where(missed, -1.0, t_min), nx * fl, ny * fl, nz * fl,
            torch.where(missed, -1, mat))


def packet_walk_plain(nodes_f, nodes_i, tris_packed, root: int,
                      ox, oy, oz, dx, dy, dz, act, tb):
    """Plain PyTorch version of csrc/packet.cu: the per-ray stackless
    ENTER/ADVANCE walk over parent/sibling links (bvh_pallas.py:168-218),
    vectorized over the lanes still walking."""
    nf = nodes_f.reshape(-1, 8)
    ni = nodes_i.reshape(-1, 4)
    n_nodes = nf.shape[0]
    tri_tab = tri_table(tris_packed)
    n = ox.shape[0]
    dev = ox.device
    t_min = tb.clone()
    nx, ny, nz = (torch.zeros(n, device=dev) for _ in range(3))
    mat = torch.full((n,), -1, dtype=torch.int32, device=dev)
    node = torch.full((n,), root, dtype=torch.int64, device=dev)
    enter = torch.ones(n, dtype=torch.bool, device=dev)
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    lanes = torch.nonzero(act > 0).reshape(-1)
    if not 0 <= root < n_nodes:
        lanes = lanes[:0]
    for _ in range(2 * n_nodes + 2):
        if lanes.numel() == 0:
            break
        nd = node[lanes]
        fv, iv = nf[nd], ni[nd]
        o = [a[lanes] for a in (ox, oy, oz)]
        inv = [a[lanes] for a in (ix, iy, iz)]
        tn = [(fv[:, c] - o[c]) * inv[c] for c in range(3)]
        tf = [(fv[:, 3 + c] - o[c]) * inv[c] for c in range(3)]
        t0 = torch.maximum(torch.maximum(torch.minimum(tn[0], tf[0]),
                                         torch.minimum(tn[1], tf[1])),
                           torch.minimum(tn[2], tf[2]))
        t1 = torch.minimum(torch.minimum(torch.maximum(tn[0], tf[0]),
                                         torch.maximum(tn[1], tf[1])),
                           torch.maximum(tn[2], tf[2]))
        want = (enter[lanes] & (t0 <= t1) & (t1 > 0.0)
                & (t0 < t_min[lanes]))
        tri_first, tri_count = iv[:, 0], iv[:, 1]
        is_leaf = tri_count > 0
        leaf = want & is_leaf
        if bool(leaf.any()):
            sel = torch.nonzero(leaf).reshape(-1)
            k_max = int(tri_count[sel].max())
            ks = torch.arange(k_max, device=dev)
            for c0 in range(0, sel.numel(), LANE_CHUNK):
                s = sel[c0:c0 + LANE_CHUNK]
                L = lanes[s]
                idx = tri_first[s].long()[:, None] + ks[None, :]
                mask = ks[None, :] < tri_count[s][:, None]
                idx = torch.where(mask, idx, 0)
                hit, t, hx, hy, hz, hm = closest_hit(
                    tri_tab, idx, mask, ox[L], oy[L], oz[L], dx[L], dy[L],
                    dz[L], t_min[L])
                t_min[L] = torch.where(hit, t, t_min[L])
                nx[L] = torch.where(hit, hx, nx[L])
                ny[L] = torch.where(hit, hy, ny[L])
                nz[L] = torch.where(hit, hz, nz[L])
                mat[L] = torch.where(hit, hm, mat[L])
        descend = want & ~is_leaf
        sib, par = iv[:, 2].long(), iv[:, 3].long()
        nxt = torch.where(descend, nd + 1, torch.where(sib >= 0, sib, par))
        node[lanes] = nxt
        enter[lanes] = descend | (sib >= 0)
        lanes = lanes[(nxt >= 0) & (nxt < n_nodes)]
    return finish_hits(t_min, nx, ny, nz, mat, dx, dy, dz, tb)


def packet_walk(nodes_f, nodes_i, tris_packed, root: int,
                ox, oy, oz, dx, dy, dz, act, tb):
    """(t, nx, ny, nz, mat) per lane: csrc/packet.cu on CUDA tensors, the
    plain version on CPU tensors."""
    if ox.device.type == "cpu":
        return packet_walk_plain(nodes_f, nodes_i, tris_packed, root,
                                 ox, oy, oz, dx, dy, dz, act, tb)
    n = ox.shape[0]
    dev = kernels.check(
        "packet", n, nodes_f32=nodes_f, nodes_i32=nodes_i,
        tris_f32=tris_packed, ray_ox_f32=ox, ray_oy_f32=oy, ray_oz_f32=oz,
        ray_dx_f32=dx, ray_dy_f32=dy, ray_dz_f32=dz, ray_act_i32=act,
        ray_tb_f32=tb)
    t = torch.empty(n, dtype=torch.float32, device=ox.device)
    nx, ny, nz = (torch.empty_like(t) for _ in range(3))
    mat = torch.empty(n, dtype=torch.int32, device=ox.device)
    if n:
        p = kernels.ptr
        kernels.launch("packet", dev, p(nodes_f), p(nodes_i),
                       min(nodes_f.numel() // 8, nodes_i.numel() // 4),
                       p(tris_packed), int(root), p(ox), p(oy), p(oz), p(dx),
                       p(dy), p(dz), p(act), p(tb), p(t), p(nx), p(ny),
                       p(nz), p(mat), n)
    return t, nx, ny, nz, mat


def mesh_intersect_packet(scene, root_node: int, origin: Vec3,
                          direction: Vec3, active=None, t_bound=None):
    """Packet-walk mesh intersection over the whole ray pool
    (bvh_pallas.py:252): (t [N], normal Vec3, mat [N]), t = -1 where nothing
    is closer than `t_bound`. The per-ray walk needs no block padding."""
    n = origin.x.shape[0]
    dev = origin.x.device
    act = (torch.ones(n, dtype=torch.int32, device=dev) if active is None
           else active.to(torch.int32).contiguous())
    tb = (torch.full((n,), FLT_MAX, device=dev) if t_bound is None
          else t_bound.contiguous())
    o = [c.contiguous() for c in origin]
    d = [c.contiguous() for c in direction]
    t, nx, ny, nz, mat = packet_walk(scene.bvh_packed_f, scene.bvh_packed_i,
                                     scene.tris_packed, root_node, *o, *d,
                                     act, tb)
    return t, Vec3(nx, ny, nz), mat
