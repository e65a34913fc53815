"""Packet BVH walk: the port of pathtracer_tpu/ops/bvh_pallas.py
(`_packet_kernel`, :70, and `mesh_intersect_packet`, :252-308).

Contract, as in the JAX package: per active lane, the TRUE closest hit
strictly below t_bound over one mesh's BVH (no reference pruning quirk),
normal normalized and faced toward the ray; t = -1, mat = -1 on a miss.
Inactive lanes report a miss (the TPU kernel may record stray hits for them,
which no caller reads).

`packet_walk` launches csrc/packet.cu for CUDA tensors (a compaction of the
active lanes, then a persistent walk over them with warp-cooperative leaf
tests; see the note there) and runs `packet_walk_plain`, the same per-ray
stackless walk in plain PyTorch, for CPU tensors. The binned intersector
(ops/binned.py) runs it as its exact fallback; `mesh_intersect_packet` is
bvh_impl="pallas" and
`mesh_intersect_packet_sorted` (bvh_pallas.py:330) is bvh_impl="sorted".

`coherence_sorted` runs a walk over coherence-sorted chunks, for this
module's and the 8-wide walk's (ops/wide.py) sorted wrappers; `slab` is the
plain versions' box test.
"""
from __future__ import annotations

import torch

from ..scene.types import TRI_STRIDE, TRIS_PER_ROW
from ..utils.vec import Vec3
from . import kernels

FLT_MAX = 3.402823466e38
LANE_CHUNK = 1 << 15   # lanes per block of [lanes, triangles] work
SORT_CHUNK = 8192      # lanes per coherence-sort chunk (bvh_pallas.py:316)
# csrc/packet.cu stages node tables of at most SMEM_NODES nodes (48 bytes
# each, 48 KB) in shared memory
SMEM_NODES = 1024


def tri_table(tris_packed: torch.Tensor) -> torch.Tensor:
    """[rows, 128] packed triangles -> [rows * 6, 20] records."""
    return tris_packed[:, :TRIS_PER_ROW * TRI_STRIDE].reshape(-1, TRI_STRIDE)


def slab(lo, hi, o, inv):
    """Entry and exit t (t0, t1) of boxes lo..hi (3 tensors each) for rays
    o + t d with inv = 1/d, in the kernels' order (common.cuh slab); the
    torch min/max propagate NaN, as jnp's do, so an empty slot's NaN box is
    never entered. All arguments broadcast."""
    tn = [(lo[c] - o[c]) * inv[c] for c in range(3)]
    tf = [(hi[c] - o[c]) * inv[c] for c in range(3)]
    t0 = torch.maximum(torch.maximum(torch.minimum(tn[0], tf[0]),
                                     torch.minimum(tn[1], tf[1])),
                       torch.minimum(tn[2], tf[2]))
    t1 = torch.minimum(torch.minimum(torch.maximum(tn[0], tf[0]),
                                     torch.maximum(tn[1], tf[1])),
                       torch.maximum(tn[2], tf[2]))
    return t0, t1


def closest_hit(tri_tab, idx, mask, ox, oy, oz, dx, dy, dz, t_min,
                uv: bool = False):
    """Moller-Trumbore of lane l against triangles tri_tab[idx[l, k]]
    (where mask[l, k]), keeping the first triangle of smallest t strictly
    below t_min[l]: the result of testing them one after another in k order
    with strict `<`, as the kernels do. Returns (hit, t, raw nx, ny, nz,
    mat) of the winner, or with `uv` (hit, t, u, v, 0, its triangle index
    idx[l, k]); the other values are don't-cares where ~hit."""
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
    if uv:
        return (hit, pick(t), uw, vw, torch.zeros_like(uw),
                pick(idx).to(torch.int32))
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
                      ox, oy, oz, dx, dy, dz, act, tb, counts=None):
    """Plain PyTorch version of csrc/packet.cu: the per-ray stackless
    ENTER/ADVANCE walk over parent/sibling links (bvh_pallas.py:168-218),
    vectorized over the lanes still walking. `counts`, when given, is a
    dict that gains the box tests ("box_tests") and triangle tests
    ("tri_tests") the kernel does on these inputs."""
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
        if counts is not None:
            count(counts, "box_tests", enter[lanes].sum())
        t0, t1 = slab(fv[:, 0:3].T, fv[:, 3:6].T, o, inv)
        want = (enter[lanes] & (t0 <= t1) & (t1 > 0.0)
                & (t0 < t_min[lanes]))
        tri_first, tri_count = iv[:, 0], iv[:, 1]
        is_leaf = tri_count > 0
        leaf = want & is_leaf
        if bool(leaf.any()):
            sel = torch.nonzero(leaf).reshape(-1)
            if counts is not None:
                count(counts, "tri_tests", tri_count[sel].sum())
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


def count(counts: dict, key: str, n) -> None:
    """Add n (an int or a 0-d tensor) to counts[key]."""
    counts[key] = counts.get(key, 0) + int(n)


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
    if not n:
        return kernels.hit_outputs(0, dev)
    # two allocations: the four float outputs; mat, then the kernel's
    # scratch ([0] the active count, [1] the walk's fetch counter, [2:] the
    # list)
    t, nx, ny, nz = torch.empty((4, n), device=dev).unbind(0)
    ints = torch.empty(2 * n + 2, dtype=torch.int32, device=dev)
    mat = ints[:n]
    kernels.launch("packet", dev, *(a.data_ptr() for a in (
        nodes_f, nodes_i)), min(nodes_f.numel() // 8, nodes_i.numel() // 4),
        tris_packed.data_ptr(), int(root), *(a.data_ptr() for a in (
            ox, oy, oz, dx, dy, dz, act, tb, t, nx, ny, nz, mat)),
        ints.data_ptr() + 4 * n, SMEM_NODES, n)
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


def root_candidates(scene, roots, origin: Vec3, direction: Vec3, active,
                    t_bound):
    """Active lanes whose ray enters the box of any of the binary BVH roots
    `roots` closer than t_bound: exactly the walks' root want-test (entry
    t0, not aabb_intersect's inside-origin exit t), so no lane a walk would
    enter is left out."""
    cand = torch.zeros(origin.x.shape[0], dtype=torch.bool,
                       device=origin.x.device)
    inv_dir = 1.0 / direction
    bvh = scene.bvh
    for root in roots:
        bmin = Vec3(bvh.min_x[root], bvh.min_y[root], bvh.min_z[root])
        bmax = Vec3(bvh.max_x[root], bvh.max_y[root], bvh.max_z[root])
        t_near = (bmin - origin) * inv_dir
        t_far = (bmax - origin) * inv_dir
        t0 = Vec3.minimum(t_near, t_far).max_component()
        t1 = Vec3.maximum(t_near, t_far).min_component()
        cand = cand | ((t0 <= t1) & (t1 > 0.0) & (t0 < t_bound))
    return active & cand


def coherence_sorted(walk, scene, roots, origin: Vec3, direction: Vec3,
                     active=None, t_bound=None, sort_chunk: int = SORT_CHUNK):
    """`walk` over coherence-sorted chunks, the scheme of the JAX package's
    sorted wrappers (bvh_pallas.py:343-412, wide.py:539-603):
      1. key each lane: candidates (active, and a mesh root box in `roots`
         entered closer than the bound) get their direction octant, the
         rest 8, so they trail;
      2. stable sort of every `sort_chunk`-lane run by that key (the pool is
         padded to whole runs, key 9);
      3. walk(origin, direction, active, t_bound) on the sorted pool, with
         the candidates as the active lanes;
      4. back to lane order by the ride-along lane index.
    On the TPU the sort gave each packet a coherent set of rays; here each
    lane walks alone, so it changes which lanes share a warp, never a lane's
    result."""
    n = origin.x.shape[0]
    dev = origin.x.device
    act = (torch.ones(n, dtype=torch.bool, device=dev) if active is None
           else active)
    tb = (torch.full((n,), FLT_MAX, device=dev) if t_bound is None
          else t_bound)
    cand = root_candidates(scene, roots, origin, direction, act, tb)
    chunk = min(sort_chunk, -(-n // 128) * 128)
    n_pad = -(-n // chunk) * chunk

    def prep(a, fill):
        return torch.cat([a, a.new_full((n_pad - n,), fill)])

    octant = ((direction.x < 0).to(torch.int32) * 4
              + (direction.y < 0).to(torch.int32) * 2
              + (direction.z < 0).to(torch.int32))
    key = prep(torch.where(cand, octant, 8), 9).reshape(-1, chunk)
    _, perm = torch.sort(key, dim=1, stable=True)

    def take(a, fill):
        return torch.gather(prep(a, fill).reshape(-1, chunk), 1,
                            perm).reshape(-1)

    def back(a):
        a = a.reshape(perm.shape)
        return torch.empty_like(a).scatter_(1, perm, a).reshape(-1)[:n]

    t, nrm, mat = walk(Vec3(*(take(c, 0.0) for c in origin)),
                       Vec3(*(take(c, 1.0) for c in direction)),
                       take(cand, False), take(tb, 0.0))
    return back(t), Vec3(*map(back, nrm)), back(mat)


def mesh_intersect_packet_sorted(scene, root_node: int, origin: Vec3,
                                 direction: Vec3, active=None, t_bound=None,
                                 sort_chunk: int = SORT_CHUNK):
    """The packet walk over coherence-sorted chunks (bvh_pallas.py:330,
    bvh_impl="sorted"): the same (t, normal, mat) as
    mesh_intersect_packet."""
    def walk(o, d, act, tb):
        return mesh_intersect_packet(scene, root_node, o, d, active=act,
                                     t_bound=tb)
    return coherence_sorted(walk, scene, (root_node,), origin, direction,
                            active, t_bound, sort_chunk)
