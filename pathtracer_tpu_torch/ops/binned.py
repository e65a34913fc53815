"""Binned-treelet mesh intersection: the port of pathtracer_tpu/ops/binned.py,
the production mesh intersector of mesh scenes.

The pipeline (mesh_intersect_binned) moves rays to their triangles:
  1. root candidacy: lanes whose ray misses every mesh root box, or meets it
     only beyond its bound, are dead to the whole pipeline;
  2. per pass: CULL (csrc/cull.cu) finds each lane's nearest not-yet-
     enumerated wanted treelet; a segmented sort BINS lanes by that id;
     STREAM (csrc/stream.cu) tests the treelet's triangle rows and tightens
     the lane's bound;
  3. a final cull finds the lanes that still have wants; an exact walk
     finishes them under the tightened bound: the packet walk
     (csrc/packet.cu, ops/bvh_packet.py) by default, or the 8-wide walk
     (csrc/wide.cu, ops/wide.py) with fallback_impl="wide";
  4. one last sort restores lane order.
Passes are adaptive, as in the JAX package: 3 above PASSES_BIG_TRIS
triangles, else 2; so is the pre-fallback compaction sort (FB_COMPACT). The
result is the true closest hit under t_bound, whatever the pass count.

Only the default pipeline is ported: the expansion and slot pipelines,
minority-want deferral, the chunk gate, the uv stream contract, the octcell
candidate key, contiguous bins and the diagnostic flags that give wrong
results on purpose are not.

Each kernel wrapper (`cull`, `stream`) launches its CUDA kernel for CUDA
tensors and runs the plain PyTorch version beside it for CPU tensors.
"""
from __future__ import annotations

import torch

from ..scene.types import TREELET_NONE, TRIS_PER_ROW
from ..utils.vec import Vec3
from . import kernels
from .bvh_packet import (closest_hit, finish_hits, mesh_intersect_packet,
                         root_candidates, slab, tri_table)

FLT_MAX = 3.402823466e38
NEG_MAX = -3.402823466e38
POOL_ALIGN = 128 * 16      # pool padding: whole (16, 128) stream blocks
PASSES_BIG_TRIS = 24000    # tri count above which passes = 3, FB_COMPACT on
CULL_CHUNK = 1 << 22       # (lane, treelet) pairs per block of plain cull work
FALLBACK_IMPL = "packet"   # the exact finish: "packet" (binary packet walk
#                            per mesh) or "wide" (one 8-wide walk over all
#                            meshes; needs the scene's wide tables)
STREAM_CHUNK = 1 << 15     # lanes per block of plain stream work


# ---------------------------------------------------------------------------
# Cull: nearest remaining wanted treelet per ray
# ---------------------------------------------------------------------------

def cull_plain(treelet_f, treelet_super, ox, oy, oz, dx, dy, dz,
               bound, pt0, pid, live):
    """Plain PyTorch version of csrc/cull.cu: per lane, the lexicographic
    minimum (entry_t, id) over the treelets whose box the ray enters closer
    than `bound`, strictly after (pt0, pid); (TREELET_NONE, FLT_MAX) if none
    or the lane is not live. The super-row gate only skips work, so it is
    left out here."""
    tab = treelet_f.reshape(-1, 8)
    T = tab.shape[0]
    ids = torch.arange(T, dtype=torch.int32, device=ox.device)[None, :]
    out_id = torch.full_like(pid, TREELET_NONE)
    out_t0 = torch.full_like(bound, FLT_MAX)
    step = max(1, CULL_CHUNK // T)
    for c0 in range(0, ox.shape[0], step):
        sl = slice(c0, c0 + step)
        t0, t1 = slab(tab[None, :, 0:3].unbind(-1),
                      tab[None, :, 3:6].unbind(-1),
                      [a[sl, None] for a in (ox, oy, oz)],
                      [1.0 / a[sl, None] for a in (dx, dy, dz)])
        b, p_t0, p_id = bound[sl, None], pt0[sl, None], pid[sl, None]
        cand = ((live[sl, None] > 0) & (t0 <= t1) & (t1 > 0.0) & (t0 < b)
                & ((t0 > p_t0) | ((t0 == p_t0) & (ids > p_id))))
        best_t0 = torch.where(cand, t0, float("inf")).amin(dim=1,
                                                           keepdim=True)
        best_id = torch.where(cand & (t0 == best_t0), ids,
                              TREELET_NONE).amin(dim=1)
        out_id[sl] = best_id
        out_t0[sl] = torch.where(best_id < TREELET_NONE, best_t0[:, 0],
                                 FLT_MAX)
    return out_id, out_t0


def cull(treelet_f, treelet_super, ox, oy, oz, dx, dy, dz,
         bound, pt0, pid, live):
    """(id int32, t0 f32) per lane: csrc/cull.cu on CUDA tensors, the plain
    version on CPU tensors."""
    if ox.device.type == "cpu":
        return cull_plain(treelet_f, treelet_super, ox, oy, oz, dx, dy, dz,
                          bound, pt0, pid, live)
    n = ox.shape[0]
    dev = kernels.check(
        "cull", n, treelet_f32=treelet_f, super_f32=treelet_super,
        ray_ox_f32=ox, ray_oy_f32=oy, ray_oz_f32=oz, ray_dx_f32=dx,
        ray_dy_f32=dy, ray_dz_f32=dz, ray_bound_f32=bound, ray_pt0_f32=pt0,
        ray_pid_i32=pid, ray_live_i32=live)
    if treelet_super.shape != treelet_f.shape:
        raise ValueError("cull: treelet_super must have one row per "
                         "treelet_f row")
    out_id = torch.empty(n, dtype=torch.int32, device=ox.device)
    out_t0 = torch.empty(n, dtype=torch.float32, device=ox.device)
    if n:
        p = kernels.ptr
        kernels.launch("cull", dev, p(treelet_f), p(treelet_super),
                       treelet_f.shape[0], p(ox), p(oy), p(oz), p(dx),
                       p(dy), p(dz), p(bound), p(pt0), p(pid), p(live),
                       p(out_id), p(out_t0), n)
    return out_id, out_t0


# ---------------------------------------------------------------------------
# Stream: triangle rows of each lane's binned treelet
# ---------------------------------------------------------------------------

def stream_plain(treelet_i, tris_packed, max_rows: int,
                 ox, oy, oz, dx, dy, dz, bound, tid):
    """Plain PyTorch version of csrc/stream.cu: per lane, the closest hit
    strictly below `bound` among the triangle rows of treelet `tid`
    (a miss for TREELET_NONE), normal normalized and faced toward the
    ray."""
    ti = treelet_i.reshape(-1, 4)
    rows = tris_packed.shape[0]
    tri_tab = tri_table(tris_packed)
    n = ox.shape[0]
    dev = ox.device
    t_min = bound.clone()
    nx, ny, nz = (torch.zeros(n, device=dev) for _ in range(3))
    mat = torch.full((n,), -1, dtype=torch.int32, device=dev)
    valid = (tid >= 0) & (tid < ti.shape[0])
    g = torch.where(valid, tid, 0).long()
    row0 = ti[g, 0].long()
    n_rows = torch.where(valid, torch.clamp(ti[g, 1], max=max_rows), 0)
    slot = torch.arange(max_rows * TRIS_PER_ROW, device=dev)[None, :]
    r, j = slot // TRIS_PER_ROW, slot % TRIS_PER_ROW
    for c0 in range(0, n, STREAM_CHUNK):
        sl = slice(c0, c0 + STREAM_CHUNK)
        mask = r < n_rows[sl, None]
        idx = torch.clamp(row0[sl, None] + r, max=rows - 1) * TRIS_PER_ROW + j
        hit, t, hx, hy, hz, hm = closest_hit(
            tri_tab, idx, mask, ox[sl], oy[sl], oz[sl], dx[sl], dy[sl],
            dz[sl], t_min[sl])
        t_min[sl] = torch.where(hit, t, t_min[sl])
        nx[sl] = torch.where(hit, hx, 0.0)
        ny[sl] = torch.where(hit, hy, 0.0)
        nz[sl] = torch.where(hit, hz, 0.0)
        mat[sl] = torch.where(hit, hm, -1)
    return finish_hits(t_min, nx, ny, nz, mat, dx, dy, dz, bound)


def stream(treelet_i, tris_packed, max_rows: int,
           ox, oy, oz, dx, dy, dz, bound, tid):
    """(t, nx, ny, nz, mat) per lane: csrc/stream.cu on CUDA tensors, the
    plain version on CPU tensors."""
    if ox.device.type == "cpu":
        return stream_plain(treelet_i, tris_packed, max_rows,
                            ox, oy, oz, dx, dy, dz, bound, tid)
    n = ox.shape[0]
    dev = kernels.check(
        "stream", n, treelet_i32=treelet_i, tris_f32=tris_packed,
        ray_ox_f32=ox, ray_oy_f32=oy, ray_oz_f32=oz, ray_dx_f32=dx,
        ray_dy_f32=dy, ray_dz_f32=dz, ray_bound_f32=bound, ray_tid_i32=tid)
    t, nx, ny, nz, mat = kernels.hit_outputs(n, ox.device)
    if n:
        p = kernels.ptr
        kernels.launch("stream", dev, p(treelet_i), treelet_i.numel() // 4,
                       p(tris_packed), tris_packed.shape[0], int(max_rows),
                       p(ox), p(oy), p(oz), p(dx), p(dy), p(dz), p(bound),
                       p(tid), p(t), p(nx), p(ny), p(nz), p(mat), n)
    return t, nx, ny, nz, mat


# ---------------------------------------------------------------------------
# Host-side pipeline
# ---------------------------------------------------------------------------

def _seg_sort(key, *arrays):
    """Stable sort of each of the 128 columns of the (rows, 128) view by
    `key`, every payload riding the same permutation (the JAX package's
    column-segmented lax.sort, binned.py:689, which XLA runs outside any
    kernel). Lanes stripe over columns, so every column sees the same id
    distribution and rank-aligned rows hold nearly the same ids."""
    sk, perm = torch.sort(key.reshape(-1, 128), dim=0, stable=True)
    return (sk.reshape(-1),) + tuple(
        torch.gather(a.reshape(-1, 128), 0, perm).reshape(-1)
        for a in arrays)


def mesh_intersect_binned(scene, mesh_roots, origin: Vec3, direction: Vec3,
                          active=None, t_bound=None,
                          passes: int | None = None,
                          fb_compact: bool | None = None,
                          fallback_impl: str | None = None):
    """Binned-treelet mesh intersection over the whole ray pool, all meshes
    in one pass (binned.py:723). Returns (t [N], normal Vec3, mat [N]),
    t = -1 where nothing is closer than `t_bound`: the true closest hit.
    `passes` / `fb_compact` = None choose by triangle count, as the JAX
    package does; `fallback_impl` = None takes FALLBACK_IMPL."""
    if fallback_impl is None:
        fallback_impl = FALLBACK_IMPL
    if fallback_impl not in ("packet", "wide"):
        raise ValueError(f"fallback_impl {fallback_impl!r}: expected "
                         "'packet' or 'wide'")
    n_tris = scene.tris_packed.shape[0] * TRIS_PER_ROW
    if passes is None:
        passes = 3 if n_tris > PASSES_BIG_TRIS else 2
    if fb_compact is None:
        fb_compact = n_tris > PASSES_BIG_TRIS
    n = origin.x.shape[0]
    dev = origin.x.device
    n_pad = -(-n // POOL_ALIGN) * POOL_ALIGN

    def prep(a, fill):
        return torch.cat([a, a.new_full((n_pad - n,), fill)])

    act = (torch.ones(n, dtype=torch.bool, device=dev) if active is None
           else active)
    tb = torch.full((n,), FLT_MAX, device=dev) if t_bound is None else t_bound

    # root candidacy (union over meshes): every treelet box lies inside its
    # mesh's root box, so a lane that misses all roots has no wants
    act = root_candidates(scene, mesh_roots, origin, direction, act, tb)

    ox, oy, oz = (prep(c, 0.0) for c in origin)
    dx, dy, dz = (prep(c, 1.0) for c in direction)
    bound = prep(tb, 0.0)
    # unsort key: a lane's row within its column
    lane = torch.arange(n_pad, dtype=torch.int32, device=dev) // 128

    # enumeration state; pid doubles as the liveness carrier: TREELET_NONE
    # marks a lane dead (non-candidates now, later lanes whose cull found no
    # further want)
    pt0 = torch.full((n_pad,), NEG_MAX, device=dev)
    pid = torch.where(prep(act, False), -1, TREELET_NONE).to(torch.int32)

    # initial bin: candidates (pid -1) before dead lanes (NONE)
    (pid, ox, oy, oz, dx, dy, dz, bound, pt0, lane) = _seg_sort(
        pid, ox, oy, oz, dx, dy, dz, bound, pt0, lane)

    # best-so-far (t, nx, ny, nz, mat) follows the rays through every sort
    best = [torch.full((n_pad,), -1.0, device=dev)] + [
        torch.zeros(n_pad, device=dev) for _ in range(3)] + [
        torch.full((n_pad,), -1, dtype=torch.int32, device=dev)]

    for _ in range(passes):
        live = (pid < TREELET_NONE).to(torch.int32)
        tid, tt0 = cull(scene.treelet_f, scene.treelet_super,
                        ox, oy, oz, dx, dy, dz, bound, pt0, pid, live)
        # bin: sort by wanted id (NONE lanes cluster at column ends)
        (tid, ox, oy, oz, dx, dy, dz, bound, tt0, lane, *best) = _seg_sort(
            tid, ox, oy, oz, dx, dy, dz, bound, tt0, lane, *best)
        t, nx, ny, nz, mat = stream(scene.treelet_i, scene.tris_packed,
                                    scene.tre_rows, ox, oy, oz, dx, dy, dz,
                                    bound, tid)
        hit = t > 0.0
        best = [torch.where(hit, a, b)
                for a, b in zip((t, nx, ny, nz, mat), best)]
        bound = torch.where(hit, t, bound)
        pt0, pid = tt0, tid

    # one more cull after the last stream: lanes with a want left under the
    # tightened bound finish in the exact packet walk
    bt, bnx, bny, bnz, bmat = best
    live = (pid < TREELET_NONE).to(torch.int32)
    tid_f, _ = cull(scene.treelet_f, scene.treelet_super,
                    ox, oy, oz, dx, dy, dz, bound, pt0, pid, live)
    remaining = (live > 0) & (tid_f < TREELET_NONE)
    if fb_compact:
        # cluster the residual lanes at the head of every column
        key = torch.where(remaining, 0, 1).to(torch.int32)
        (key, ox, oy, oz, dx, dy, dz, bound, lane,
         bt, bnx, bny, bnz, bmat) = _seg_sort(
            key, ox, oy, oz, dx, dy, dz, bound, lane, bt, bnx, bny, bnz, bmat)
        remaining = key == 0
    t, nrm, mat = _packet_fallback(scene, mesh_roots, Vec3(ox, oy, oz),
                                   Vec3(dx, dy, dz), remaining, bound,
                                   fallback_impl)
    hit = t > 0.0
    bt = torch.where(hit, t, bt)
    bnx = torch.where(hit, nrm.x, bnx)
    bny = torch.where(hit, nrm.y, bny)
    bnz = torch.where(hit, nrm.z, bnz)
    bmat = torch.where(hit, mat, bmat)

    # restore lane order
    lane, bt, bnx, bny, bnz, bmat = _seg_sort(lane, bt, bnx, bny, bnz, bmat)
    return bt[:n], Vec3(bnx[:n], bny[:n], bnz[:n]), bmat[:n]


def _packet_fallback(scene, mesh_roots, origin, direction, active, bound,
                     fallback_impl: str = "packet"):
    """Exact finish for lanes with unenumerated wants, under the tightened
    bound (binned.py:1158-1192): one packet walk per mesh, or with
    fallback_impl="wide" one 8-wide walk over every mesh."""
    if fallback_impl == "wide":
        from .wide import mesh_intersect_wide
        return mesh_intersect_wide(scene, origin, direction, active=active,
                                   t_bound=bound)
    n = origin.x.shape[0]
    dev = origin.x.device
    t_best = torch.full((n,), FLT_MAX, device=dev)
    n_best = Vec3.zeros(n, dev)
    m_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    any_hit = torch.zeros(n, dtype=torch.bool, device=dev)
    for root in mesh_roots:
        t, nrm, mat = mesh_intersect_packet(
            scene, root, origin, direction, active=active,
            t_bound=torch.minimum(bound, t_best))
        upd = (t > 0.0) & (t < t_best)
        t_best = torch.where(upd, t, t_best)
        n_best = Vec3.where(upd, nrm, n_best)
        m_best = torch.where(upd, mat, m_best)
        any_hit = any_hit | upd
    return torch.where(any_hit, t_best, -1.0), n_best, m_best

