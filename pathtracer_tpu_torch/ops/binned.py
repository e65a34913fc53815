"""Binned-treelet mesh intersection: the port of pathtracer_tpu/ops/binned.py,
the production mesh intersector of mesh scenes.

The pipeline (mesh_intersect_binned) moves rays to their triangles:
  1. root candidacy: lanes whose ray misses every mesh root box, or meets it
     only beyond its bound, are dead to the whole pipeline; an initial sort
     puts the candidates first (CAND_KEY "pid"), or orders them by direction
     octant and origin cell ("octcell", a locality knob only);
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
result is the true closest hit under t_bound, whatever the pipeline's shape.

The JAX package's other pipeline shapes and kernel forms are ported too,
chosen by the same arguments and module flags, which are read at call time
(the JAX package reads them at trace time):
  expand=K / EXPAND   one K-want cull, the pool expanded K-fold into
                      (ray, want) pairs, one bin sort and one stream, the K
                      slots merged by strict `<` (binned.py:955-999);
  slots=K / SLOTS     one K-want cull, then K bin + stream rounds with the
                      bound tightened between them (binned.py:1001-1048);
                      `expand` wins when both are set, and values < 1 mean
                      off;
  MIN_SUPPORT > 1     minority-want deferral: the stream skips a visit that
                      fewer than MIN_SUPPORT lanes of its 2,048-lane block
                      want; its lanes carry `inc` through the sorts and
                      finish in the exact fallback;
  STREAM_UV           the stream returns (t, u, v, triangle index), and one
                      gather of scene.tri_attrs rebuilds the normal and the
                      material after the passes;
  CHUNK_GATE          the stream slab-tests each 4-row chunk's box
                      (scene.treelet_chunk) before its triangles;
  BIN_CONTIGUOUS      bin sorts over contiguous 65,536-lane runs in place of
                      the 128 columns (the pool padded to whole runs);
  PASSES, FB_COMPACT  the pass count and the compaction, None = adaptive;
  CAND_SORT, CAND_KEY the initial sort, and its key.
debug_tids=True also returns each pass's post-bin want ids. The expansion
pipeline takes neither STREAM_UV nor BIN_CONTIGUOUS, and the slot pipeline
not STREAM_UV, as in the JAX package.

Three ablation flags GIVE WRONG RESULTS ON PURPOSE. They exist only so that
the measurement tools (tools/sweep_mesh.py `split` and `csplit`,
tools/profile_binned2.py) can split the pipeline's cost by stage, as the
JAX package's do (binned.py:188, 209-210); no entry point, CLI flag or
RenderSettings field reaches them:
  CULL_CHEAP = True   each pass's cull is skipped: a live lane wants
                      treelet 0 at t0 0 (binned.py:1055);
  STREAM_OFF = True   each pass's stream is skipped: t -1, zero normals,
                      material -1 (binned.py:1072);
  FALLBACK = False    no final cull, compaction or exact finish, and no
                      minority-want deferral (binned.py:1118, 950).
Left out: the TPU tiling knobs (CULL_ROWS, STREAM_ROWS, FB_ROWS,
SORT_CHUNK, STREAM_ROW_CHUNK, DEFER_NORMAL), which change no result and
have no counterpart in the kernels' designs here.

Each kernel wrapper (`cull`, `stream`) launches its CUDA kernel for CUDA
tensors and runs the plain PyTorch version beside it for CPU tensors. The
sort, cull, stream and fallback stages run under torch.profiler ranges named
as the JAX package's scopes (pt_mi_sort, pt_mi_cull, pt_mi_stream,
pt_mi_fb): they show in a torch.profiler trace, and as NVTX ranges under
torch.autograd.profiler.emit_nvtx.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from ..scene.types import CHUNK_GATE_ROWS, TREELET_NONE, TRIS_PER_ROW
from ..utils.vec import Vec3
from . import kernels
from .bvh_packet import (closest_hit, finish_hits, mesh_intersect_packet,
                         root_candidates, slab, tri_table)

FLT_MAX = 3.402823466e38
NEG_MAX = -3.402823466e38
POOL_ALIGN = 128 * 16      # pool padding: whole (16, 128) stream blocks
CONTIGUOUS = 65536         # BIN_CONTIGUOUS: lanes a sort run
PASSES_BIG_TRIS = 24000    # tri count above which passes = 3, FB_COMPACT on
CULL_CHUNK = 1 << 22       # (lane, treelet) pairs per block of plain cull work
MAX_WANTS = 8              # the most wants a cull call may ask for
FALLBACK_IMPL = "packet"   # the exact finish: "packet" (binary packet walk
#                            per mesh) or "wide" (one 8-wide walk over all
#                            meshes; needs the scene's wide tables)
STREAM_CHUNK = 1 << 15     # lanes per block of plain stream work
SUPPORT_LANES = 2048       # the deferral's block: the TPU kernel's 16 x 128
GATE_ROWS = 16             # the gated stream reads a ray's best once per
#                            16 triangle rows (csrc/stream.cu: a batch of
#                            96 triangles, 4 chunks)

# module flags, read at call time (see the module docstring)
PASSES = None
EXPAND = None
SLOTS = None
FB_COMPACT = None
MIN_SUPPORT = 1
STREAM_UV = False
CHUNK_GATE = False
BIN_CONTIGUOUS = False
CAND_SORT = True
CAND_KEY = "pid"
# the ablations that give wrong results on purpose (module docstring)
FALLBACK = True
STREAM_OFF = False
CULL_CHEAP = False


# ---------------------------------------------------------------------------
# Cull: the K nearest remaining wanted treelets per ray
# ---------------------------------------------------------------------------

def cull_plain(treelet_f, treelet_super, ox, oy, oz, dx, dy, dz,
               bound, pt0, pid, live, k: int = 1):
    """Plain PyTorch version of csrc/cull.cu: per lane, the `k`
    lexicographically least (entry_t, id) over the treelets whose box the
    ray enters closer than `bound`, strictly after (pt0, pid); the slots
    left over hold (TREELET_NONE, FLT_MAX), all of them where the lane is
    not live. Returns (id, t0) planes [n] for k = 1, else [k, n] tensors of
    k planes each, nearest first. The super-row gate only skips work, so it
    is left out here."""
    _check_k(k)
    tab = treelet_f.reshape(-1, 8)
    T = tab.shape[0]
    ids = torch.arange(T, dtype=torch.int32, device=ox.device)[None, :]
    n = ox.shape[0]
    out_id = torch.full((k, n), TREELET_NONE, dtype=torch.int32,
                        device=ox.device)
    out_t0 = torch.full((k, n), FLT_MAX, device=ox.device)
    step = max(1, CULL_CHUNK // T)
    for c0 in range(0, n, step):
        sl = slice(c0, c0 + step)
        t0, t1 = slab(tab[None, :, 0:3].unbind(-1),
                      tab[None, :, 3:6].unbind(-1),
                      [a[sl, None] for a in (ox, oy, oz)],
                      [1.0 / a[sl, None] for a in (dx, dy, dz)])
        b, p_t0, p_id = bound[sl, None], pt0[sl, None], pid[sl, None]
        cand = ((live[sl, None] > 0) & (t0 <= t1) & (t1 > 0.0) & (t0 < b)
                & ((t0 > p_t0) | ((t0 == p_t0) & (ids > p_id))))
        for s in range(k):
            # the next least (t0, id), and its own t0 (its zero sign)
            best_t0 = torch.where(cand, t0, float("inf")).amin(
                dim=1, keepdim=True)
            best_id = torch.where(cand & (t0 == best_t0), ids,
                                  TREELET_NONE).amin(dim=1)
            found = best_id < TREELET_NONE
            own = torch.gather(t0, 1, torch.where(found, best_id, 0)
                               .long()[:, None])[:, 0]
            out_id[s, sl] = best_id
            out_t0[s, sl] = torch.where(found, own, FLT_MAX)
            if s + 1 < k:
                cand = cand & (ids != best_id[:, None])
    if k == 1:
        return out_id[0], out_t0[0]
    return out_id, out_t0


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_WANTS:
        raise ValueError(f"cull: k={k}, expected 1..{MAX_WANTS}")


def cull(treelet_f, treelet_super, ox, oy, oz, dx, dy, dz,
         bound, pt0, pid, live, k: int = 1):
    """(id int32, t0 f32) planes per lane, [n] for k = 1 and [k, n] for
    k > 1: csrc/cull.cu on CUDA tensors, the plain version on CPU
    tensors."""
    with record_function("pt_mi_cull"):
        if ox.device.type == "cpu":
            return cull_plain(treelet_f, treelet_super, ox, oy, oz, dx, dy,
                              dz, bound, pt0, pid, live, k)
        _check_k(k)
        n = ox.shape[0]
        dev = kernels.check(
            "cull", n, treelet_f32=treelet_f, super_f32=treelet_super,
            ray_ox_f32=ox, ray_oy_f32=oy, ray_oz_f32=oz, ray_dx_f32=dx,
            ray_dy_f32=dy, ray_dz_f32=dz, ray_bound_f32=bound,
            ray_pt0_f32=pt0, ray_pid_i32=pid, ray_live_i32=live)
        if treelet_super.shape != treelet_f.shape:
            raise ValueError("cull: treelet_super must have one row per "
                             "treelet_f row")
        out_id = torch.empty((k, n), dtype=torch.int32, device=ox.device)
        out_t0 = torch.empty((k, n), dtype=torch.float32, device=ox.device)
        if n:
            p = kernels.ptr
            kernels.launch("cull", dev, p(treelet_f), p(treelet_super),
                           treelet_f.shape[0], p(ox), p(oy), p(oz), p(dx),
                           p(dy), p(dz), p(bound), p(pt0), p(pid), p(live),
                           p(out_id), p(out_t0), n, k, form=f"cull_k{k}")
        if k == 1:
            return out_id[0], out_t0[0]
        return out_id, out_t0


# ---------------------------------------------------------------------------
# Stream: triangle rows of each lane's binned treelet
# ---------------------------------------------------------------------------

def deferred_lanes(tid, n_treelets: int, min_support: int):
    """The deferral's `inc` plane (int32): 1 where the lane's treelet is
    wanted by fewer than `min_support` lanes of its block of SUPPORT_LANES
    pool lanes (the TPU kernel's 16 x 128 block, binned.py:629-639), 0
    elsewhere and on lanes without a treelet."""
    valid = (tid >= 0) & (tid < n_treelets)
    lanes = torch.arange(tid.shape[0], device=tid.device)
    key = torch.where(valid, (lanes // SUPPORT_LANES) * (n_treelets + 1)
                      + tid.long(), -1)
    _, inverse, counts = torch.unique(key, return_inverse=True,
                                      return_counts=True)
    return (valid & (counts[inverse] < min_support)).to(torch.int32)


def stream_plain(treelet_i, tris_packed, max_rows: int,
                 ox, oy, oz, dx, dy, dz, bound, tid, uv: bool = False,
                 min_support: int = 1, treelet_chunk=None):
    """Plain PyTorch version of csrc/stream.cu: per lane, the closest hit
    strictly below `bound` among the triangle rows of treelet `tid` (a miss
    for TREELET_NONE). Returns (t, nx, ny, nz, mat), the normal normalized
    and faced toward the ray; with `uv`, (t, u, v, 0, triangle index)
    (scene.tri_attrs' row of the winner). With min_support > 1, a lane
    whose treelet fewer than min_support lanes of its block want tests
    nothing, and a sixth plane `inc` marks those lanes (deferred_lanes).
    With `treelet_chunk`, a chunk of CHUNK_GATE_ROWS rows is tested only
    where the ray enters its box closer than its best so far, read once
    every GATE_ROWS rows (csrc/stream.cu: a batch)."""
    ti = treelet_i.reshape(-1, 4)
    rows = tris_packed.shape[0]
    tri_tab = tri_table(tris_packed)
    n = ox.shape[0]
    dev = ox.device
    t_min = bound.clone()
    a0, a1, a2 = (torch.zeros(n, device=dev) for _ in range(3))
    a3 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    work = (tid >= 0) & (tid < ti.shape[0])
    inc = None
    if min_support > 1:
        inc = deferred_lanes(tid, ti.shape[0], min_support)
        work = work & (inc == 0)
    g = torch.where(work, tid, 0).long()
    row0 = ti[g, 0].long()
    n_rows = torch.where(work, torch.clamp(ti[g, 1], max=max_rows), 0)
    group = GATE_ROWS if treelet_chunk is not None else max_rows
    for c0 in range(0, n, STREAM_CHUNK):
        sl = slice(c0, c0 + STREAM_CHUNK)
        o = (ox[sl], oy[sl], oz[sl])
        d = (dx[sl], dy[sl], dz[sl])
        for r0 in range(0, max_rows, group):
            slot = torch.arange(min(group, max_rows - r0) * TRIS_PER_ROW,
                                device=dev)[None, :]
            r, j = r0 + slot // TRIS_PER_ROW, slot % TRIS_PER_ROW
            mask = r < n_rows[sl, None]
            if treelet_chunk is not None:
                mask = mask & _chunks_entered(treelet_chunk, g[sl], o, d,
                                              t_min[sl], r)
            idx = (torch.clamp(row0[sl, None] + r, max=rows - 1)
                   * TRIS_PER_ROW + j)
            hit, t, h0, h1, h2, h3 = closest_hit(tri_tab, idx, mask, *o, *d,
                                                 t_min[sl], uv=uv)
            t_min[sl] = torch.where(hit, t, t_min[sl])
            a0[sl] = torch.where(hit, h0, a0[sl])
            a1[sl] = torch.where(hit, h1, a1[sl])
            a2[sl] = torch.where(hit, h2, a2[sl])
            a3[sl] = torch.where(hit, h3, a3[sl])
    if uv:
        missed = t_min >= bound
        out = (torch.where(missed, -1.0, t_min), a0, a1,
               torch.zeros(n, device=dev), torch.where(missed, -1, a3))
    else:
        out = finish_hits(t_min, a0, a1, a2, a3, dx, dy, dz, bound)
    return out if inc is None else out + (inc,)


def _chunks_entered(treelet_chunk, g, o, d, t_best, r):
    """[L, K] mask: row r[0, k] of lane l's treelet g[l] lies in a chunk
    whose box the ray enters closer than t_best[l] (the TPU kernel's chunk
    gate, binned.py:583-604)."""
    c = r[0] // CHUNK_GATE_ROWS
    cs = torch.unique(c)
    box = treelet_chunk[g].reshape(-1, treelet_chunk.shape[1] // 8, 8)[
        :, cs.long()]                                      # [L, C, 8]
    t0, t1 = slab(box[..., 0:3].unbind(-1), box[..., 3:6].unbind(-1),
                  [a[:, None] for a in o], [1.0 / a[:, None] for a in d])
    enters = (t0 <= t1) & (t1 > 0.0) & (t0 < t_best[:, None])
    return enters[:, c - cs[0]]


def stream(treelet_i, tris_packed, max_rows: int,
           ox, oy, oz, dx, dy, dz, bound, tid, uv: bool = False,
           min_support: int = 1, treelet_chunk=None):
    """stream_plain's outputs: csrc/stream.cu on CUDA tensors, the plain
    version on CPU tensors."""
    with record_function("pt_mi_stream"):
        if ox.device.type == "cpu":
            return stream_plain(treelet_i, tris_packed, max_rows, ox, oy,
                                oz, dx, dy, dz, bound, tid, uv, min_support,
                                treelet_chunk)
        n = ox.shape[0]
        tables = dict(treelet_i32=treelet_i, tris_f32=tris_packed)
        if treelet_chunk is not None:
            tables["chunk_f32"] = treelet_chunk
        dev = kernels.check(
            "stream", n, **tables, ray_ox_f32=ox, ray_oy_f32=oy,
            ray_oz_f32=oz, ray_dx_f32=dx, ray_dy_f32=dy, ray_dz_f32=dz,
            ray_bound_f32=bound, ray_tid_i32=tid)
        n_treelets = treelet_i.numel() // 4
        if (treelet_chunk is not None
                and -(-max_rows // CHUNK_GATE_ROWS) * 8 > 128):
            raise ValueError(f"stream: max_rows {max_rows} has more chunks "
                             "than a treelet_chunk row holds")
        t, nx, ny, nz, mat = kernels.hit_outputs(n, ox.device)
        inc = (torch.empty(n, dtype=torch.int32, device=ox.device)
               if min_support > 1 else None)
        form = "".join(f"_{name}" for name, on in (
            ("uv", uv), ("defer", inc is not None),
            ("gate", treelet_chunk is not None)) if on)
        if n:
            p = kernels.ptr
            kernels.launch(
                "stream", dev, p(treelet_i), n_treelets, p(tris_packed),
                tris_packed.shape[0], int(max_rows),
                None if treelet_chunk is None else p(treelet_chunk),
                int(uv), int(min_support), p(ox), p(oy), p(oz), p(dx),
                p(dy), p(dz), p(bound), p(tid), p(t), p(nx), p(ny), p(nz),
                p(mat), None if inc is None else p(inc), n,
                form="stream" + (form or "_default"))
        out = (t, nx, ny, nz, mat)
        return out if inc is None else out + (inc,)


# ---------------------------------------------------------------------------
# Host-side pipeline
# ---------------------------------------------------------------------------

def _seg_sort(key, *arrays):
    """Stable sort of each of the 128 columns of the (rows, 128) view by
    `key`, every payload riding the same permutation (the JAX package's
    column-segmented lax.sort, binned.py:689, which XLA runs outside any
    kernel). Lanes stripe over columns, so every column sees the same id
    distribution and rank-aligned rows hold nearly the same ids. With
    BIN_CONTIGUOUS the segments are contiguous runs of CONTIGUOUS lanes
    (binned.py:704-709)."""
    with record_function("pt_mi_sort"):
        if BIN_CONTIGUOUS:
            view, dim = (-1, min(CONTIGUOUS, key.shape[0])), 1
        else:
            view, dim = (-1, 128), 0
        sk, perm = torch.sort(key.reshape(view), dim=dim, stable=True)
        return (sk.reshape(-1),) + tuple(
            torch.gather(a.reshape(view), dim, perm).reshape(-1)
            for a in arrays)


def _octcell_key(scene, mesh_roots, pid, ox, oy, oz, dx, dy, dz):
    """The "octcell" candidate key (binned.py:891-927): direction octant
    (3 bits) over a 12-bit Morton cell of the origin in the union box of
    the mesh roots; TREELET_NONE for dead lanes. Results do not depend on
    it: it orders candidates for locality only."""
    b = scene.bvh
    roots = torch.tensor(mesh_roots, dtype=torch.long, device=ox.device)
    lo = [c[roots].amin() for c in (b.min_x, b.min_y, b.min_z)]
    hi = [c[roots].amax() for c in (b.max_x, b.max_y, b.max_z)]

    def q4(c, lo, hi):
        u = torch.clamp((c - lo) / torch.clamp(hi - lo, min=1e-20),
                        0.0, 0.999)
        return (u * 16.0).to(torch.int32)

    def spread3(v):          # bit i of a 4-bit value -> bit 3i
        out = torch.zeros_like(v)
        for i in range(4):
            out = out | (((v >> i) & 1) << (3 * i))
        return out

    morton = (spread3(q4(ox, lo[0], hi[0]))
              | (spread3(q4(oy, lo[1], hi[1])) << 1)
              | (spread3(q4(oz, lo[2], hi[2])) << 2))
    octant = ((dx > 0.0).to(torch.int32) * 4 + (dy > 0.0).to(torch.int32) * 2
              + (dz > 0.0).to(torch.int32))
    return torch.where(pid < TREELET_NONE, (octant << 12) | morton,
                       TREELET_NONE).to(torch.int32)


def mesh_intersect_binned(scene, mesh_roots, origin: Vec3, direction: Vec3,
                          active=None, t_bound=None,
                          passes: int | None = None,
                          fb_compact: bool | None = None,
                          fallback_impl: str | None = None,
                          expand: int | None = None,
                          slots: int | None = None,
                          debug_tids: bool = False):
    """Binned-treelet mesh intersection over the whole ray pool, all meshes
    in one pass (binned.py:723). Returns (t [N], normal Vec3, mat [N]),
    t = -1 where nothing is closer than `t_bound`: the true closest hit.
    `passes` / `fb_compact` = None take PASSES / FB_COMPACT, and where those
    are None choose by triangle count, as the JAX package does;
    `fallback_impl` = None takes FALLBACK_IMPL; `expand` / `slots` = None
    take EXPAND / SLOTS (the module docstring). With `debug_tids` (the
    pass-sequential pipeline) a fourth output lists each pass's post-bin
    want ids."""
    if fallback_impl is None:
        fallback_impl = FALLBACK_IMPL
    if fallback_impl not in ("packet", "wide"):
        raise ValueError(f"fallback_impl {fallback_impl!r}: expected "
                         "'packet' or 'wide'")
    if expand is None:
        expand = EXPAND
    if expand is not None and expand < 1:
        expand = None
    if slots is None:
        slots = SLOTS
    if slots is not None and slots < 1:
        slots = None
    if expand is not None:
        slots = None         # expand wins if both are set
    uv, contiguous = STREAM_UV, BIN_CONTIGUOUS
    if (expand or slots) and uv:
        raise ValueError("the expansion and slot pipelines take the inline "
                         "stream contract, not STREAM_UV")
    if expand and contiguous:
        raise ValueError("the expansion pipeline's unsort key assumes "
                         "column segments, not BIN_CONTIGUOUS")
    if CAND_KEY not in ("pid", "octcell"):
        raise ValueError(f"CAND_KEY {CAND_KEY!r}: expected 'pid' or "
                         "'octcell'")
    n_tris = scene.tris_packed.shape[0] * TRIS_PER_ROW
    if passes is None:
        passes = PASSES
    if passes is None:
        passes = 3 if n_tris > PASSES_BIG_TRIS else 2
    if fb_compact is None:
        fb_compact = FB_COMPACT
    if fb_compact is None:
        fb_compact = n_tris > PASSES_BIG_TRIS
    defer = MIN_SUPPORT > 1 and FALLBACK
    # the stream's forms; the default one is called with no keywords
    s_kw = {}
    if uv:
        s_kw["uv"] = True
    if defer:
        s_kw["min_support"] = MIN_SUPPORT
    if CHUNK_GATE:
        s_kw["treelet_chunk"] = scene.treelet_chunk
    n = origin.x.shape[0]
    dev = origin.x.device
    align = CONTIGUOUS if contiguous else POOL_ALIGN
    n_pad = -(-n // align) * align

    def prep(a, fill):
        return torch.cat([a, a.new_full((n_pad - n,), fill)])

    def cull_k(k, ox, oy, oz, dx, dy, dz, bound, pt0, pid):
        """The k-want cull of the live lanes: (ids, t0s), lists of k
        planes."""
        live = (pid < TREELET_NONE).to(torch.int32)
        args = (scene.treelet_f, scene.treelet_super, ox, oy, oz, dx, dy,
                dz, bound, pt0, pid, live)
        if k == 1:
            i, t = cull(*args)
            return [i], [t]
        ids, t0s = cull(*args, k=k)
        return list(ids), list(t0s)

    def run_stream(ox, oy, oz, dx, dy, dz, bound, tid):
        """(t, o1, o2, o3, o4, inc or None)"""
        out = stream(scene.treelet_i, scene.tris_packed, scene.tre_rows,
                     ox, oy, oz, dx, dy, dz, bound, tid, **s_kw)
        return tuple(out) + ((None,) if len(out) == 5 else ())

    act = (torch.ones(n, dtype=torch.bool, device=dev) if active is None
           else active)
    tb = torch.full((n,), FLT_MAX, device=dev) if t_bound is None else t_bound

    # root candidacy (union over meshes): every treelet box lies inside its
    # mesh's root box, so a lane that misses all roots has no wants
    act = root_candidates(scene, mesh_roots, origin, direction, act, tb)

    ox, oy, oz = (prep(c, 0.0) for c in origin)
    dx, dy, dz = (prep(c, 1.0) for c in direction)
    bound = prep(tb, 0.0)
    # unsort key: a lane's position within its sort segment
    lane = torch.arange(n_pad, dtype=torch.int32, device=dev)
    lane = lane % min(CONTIGUOUS, n_pad) if contiguous else lane // 128

    # enumeration state; pid doubles as the liveness carrier: TREELET_NONE
    # marks a lane dead (non-candidates now, later lanes whose cull found no
    # further want)
    pt0 = torch.full((n_pad,), NEG_MAX, device=dev)
    pid = torch.where(prep(act, False), -1, TREELET_NONE).to(torch.int32)

    # initial bin: candidates (pid -1) before dead lanes (NONE), or the
    # octcell key's order
    if CAND_SORT:
        if CAND_KEY == "octcell":
            key = _octcell_key(scene, mesh_roots, pid, ox, oy, oz, dx, dy,
                               dz)
            (key, pid, ox, oy, oz, dx, dy, dz, bound, pt0,
             lane) = _seg_sort(key, pid, ox, oy, oz, dx, dy, dz, bound, pt0,
                               lane)
        else:
            (pid, ox, oy, oz, dx, dy, dz, bound, pt0, lane) = _seg_sort(
                pid, ox, oy, oz, dx, dy, dz, bound, pt0, lane)

    # best-so-far follows the rays through every sort: (t, nx, ny, nz, mat),
    # or with STREAM_UV (t, u, v, triangle index)
    best = [torch.full((n_pad,), -1.0, device=dev)] + [
        torch.zeros(n_pad, device=dev) for _ in range(2 if uv else 3)] + [
        torch.full((n_pad,), -1, dtype=torch.int32, device=dev)]
    # deferred lanes (MIN_SUPPORT): recomputed by the exact fallback
    inc = torch.zeros(n_pad, dtype=torch.int32, device=dev)

    if expand:
        # one K-want cull; the pool expanded into (ray, want) pairs, slot
        # major; one bin sort and one stream; pairs unsorted to slot-major
        # order and merged in enumeration order by strict `<`, so ties keep
        # the earlier slot, as the sequential passes would
        K = expand
        ids, t0s = cull_k(K, ox, oy, oz, dx, dy, dz, bound, pt0, pid)
        pos = torch.arange(K * n_pad, dtype=torch.int32, device=dev) // 128
        (e_tid, e_ox, e_oy, e_oz, e_dx, e_dy, e_dz, e_bound,
         pos) = _seg_sort(torch.cat(ids), *(a.repeat(K) for a in (
             ox, oy, oz, dx, dy, dz, bound)), pos)
        t, *outs, o5 = run_stream(e_ox, e_oy, e_oz, e_dx, e_dy, e_dz,
                                  e_bound, e_tid)
        extra = [o5] if defer else []
        pos, t, *rest = _seg_sort(pos, t, *outs, *extra)
        outs = rest[:4]
        for s in range(K):
            sl = slice(s * n_pad, (s + 1) * n_pad)
            t_s = t[sl]
            better = (t_s > 0.0) & ((best[0] <= 0.0) | (t_s < best[0]))
            best = [torch.where(better, a[sl], b)
                    for a, b in zip([t] + outs, best)]
        bound = torch.where(best[0] > 0.0, best[0], bound)
        if defer:
            inc = rest[4].reshape(K, n_pad).amax(dim=0)
        # residual enumeration: lanes with fewer than K wants are exhausted
        # (slot K-1 is NONE); the rest resume after slot K-1
        pt0, pid = t0s[K - 1], ids[K - 1]
        passes = 0

    if slots:
        # one K-want cull, then K bin + stream rounds under the tightened
        # bound; a want already behind the bound is dropped, and the
        # future slots ride every sort
        K = slots
        ids, t0s = cull_k(K, ox, oy, oz, dx, dy, dz, bound, pt0, pid)
        for s in range(K):
            tid = torch.where(t0s[s] < bound, ids[s], TREELET_NONE)
            rem_i = ids[s + 1:] if s < K - 1 else [ids[K - 1]]
            rem_t = t0s[s + 1:] if s < K - 1 else [t0s[K - 1]]
            extra = [inc] if defer else []
            (tid, ox, oy, oz, dx, dy, dz, bound, lane, *rest) = _seg_sort(
                tid, ox, oy, oz, dx, dy, dz, bound, lane, *best, *extra,
                *rem_i, *rem_t)
            best = rest[:len(best)]
            rest = rest[len(best):]
            if defer:
                inc, rest = rest[0], rest[1:]
            if s < K - 1:
                ids[s + 1:] = rest[:K - 1 - s]
                t0s[s + 1:] = rest[K - 1 - s:]
            else:
                ids[K - 1], t0s[K - 1] = rest
            t, *outs, o5 = run_stream(ox, oy, oz, dx, dy, dz, bound, tid)
            hit = t > 0.0
            best = [torch.where(hit, a, b) for a, b in zip([t] + outs, best)]
            bound = torch.where(hit, t, bound)
            if defer:
                inc = torch.maximum(inc, o5)
        pt0, pid = t0s[K - 1], ids[K - 1]
        passes = 0

    dbg_tids = []
    for _ in range(passes):
        if CULL_CHEAP:
            tid = torch.where(pid < TREELET_NONE, 0, TREELET_NONE).to(
                torch.int32)
            tt0 = torch.zeros_like(pt0)
        else:
            [tid], [tt0] = cull_k(1, ox, oy, oz, dx, dy, dz, bound, pt0,
                                  pid)
        # bin: sort by wanted id (NONE lanes cluster at segment ends)
        extra = [inc] if defer else []
        (tid, ox, oy, oz, dx, dy, dz, bound, tt0, lane, *rest) = _seg_sort(
            tid, ox, oy, oz, dx, dy, dz, bound, tt0, lane, *best, *extra)
        best = rest[:len(best)]
        if defer:
            inc = rest[-1]
        if debug_tids:
            dbg_tids.append(tid)
        if STREAM_OFF:
            t = torch.full_like(bound, -1.0)
            outs = [torch.zeros_like(bound) for _ in range(3)] + [
                torch.full_like(tid, -1)]
        else:
            t, *outs, o5 = run_stream(ox, oy, oz, dx, dy, dz, bound, tid)
            if defer:
                inc = torch.maximum(inc, o5)
        hit = t > 0.0
        new = [t, outs[0], outs[1], outs[3]] if uv else [t] + outs
        best = [torch.where(hit, a, b) for a, b in zip(new, best)]
        bound = torch.where(hit, t, bound)
        pt0, pid = tt0, tid

    if uv:
        # the gather epilogue (binned.py:1096-1115): one row gather of
        # tri_attrs by the winning triangle rebuilds the normal, with the
        # stream's formula on the same values, and the material
        bt, bu, bv, btri = best
        at = scene.tri_attrs[torch.clamp(btri, min=0).long()]
        w = 1.0 - bu - bv
        bnx = w * at[:, 0] + bu * at[:, 3] + bv * at[:, 6]
        bny = w * at[:, 1] + bu * at[:, 4] + bv * at[:, 7]
        bnz = w * at[:, 2] + bu * at[:, 5] + bv * at[:, 8]
        inv_len = 1.0 / torch.sqrt(torch.clamp(
            bnx * bnx + bny * bny + bnz * bnz, min=1e-30))
        fl = torch.where(dx * bnx + dy * bny + dz * bnz > 0.0, -inv_len,
                         inv_len)
        hit_uv = btri >= 0
        bnx = torch.where(hit_uv, bnx * fl, 0.0)
        bny = torch.where(hit_uv, bny * fl, 0.0)
        bnz = torch.where(hit_uv, bnz * fl, 0.0)
        bmat = torch.where(hit_uv, at[:, 9].to(torch.int32), -1)
    else:
        bt, bnx, bny, bnz, bmat = best

    # one more cull after the last stream: lanes with a want left under the
    # tightened bound, and the deferred lanes, finish in the exact walk
    if FALLBACK:
        [tid_f], _ = cull_k(1, ox, oy, oz, dx, dy, dz, bound, pt0, pid)
        remaining = (pid < TREELET_NONE) & (tid_f < TREELET_NONE)
        if defer:
            remaining = remaining | (inc > 0)
        if fb_compact:
            # cluster the residual lanes at the head of every segment
            key = torch.where(remaining, 0, 1).to(torch.int32)
            (key, ox, oy, oz, dx, dy, dz, bound, lane,
             bt, bnx, bny, bnz, bmat) = _seg_sort(
                key, ox, oy, oz, dx, dy, dz, bound, lane, bt, bnx, bny, bnz,
                bmat)
            remaining = key == 0
        t, nrm, mat = _packet_fallback(scene, mesh_roots,
                                       Vec3(ox, oy, oz), Vec3(dx, dy, dz),
                                       remaining, bound, fallback_impl)
        hit = t > 0.0
        bt = torch.where(hit, t, bt)
        bnx = torch.where(hit, nrm.x, bnx)
        bny = torch.where(hit, nrm.y, bny)
        bnz = torch.where(hit, nrm.z, bnz)
        bmat = torch.where(hit, mat, bmat)

    # restore lane order
    lane, bt, bnx, bny, bnz, bmat = _seg_sort(lane, bt, bnx, bny, bnz, bmat)
    out = bt[:n], Vec3(bnx[:n], bny[:n], bnz[:n]), bmat[:n]
    return out + (dbg_tids,) if debug_tids else out


def _packet_fallback(scene, mesh_roots, origin, direction, active, bound,
                     fallback_impl: str = "packet"):
    """Exact finish for lanes with unenumerated wants, under the tightened
    bound (binned.py:1158-1192): one packet walk per mesh, or with
    fallback_impl="wide" one 8-wide walk over every mesh."""
    with record_function("pt_mi_fb"):
        if fallback_impl == "wide":
            from .wide import mesh_intersect_wide
            return mesh_intersect_wide(scene, origin, direction,
                                       active=active, t_bound=bound)
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
