"""8-wide BVH walk: the port of pathtracer_tpu/ops/wide.py (`_wide_kernel`,
:177, `_wide_kernel_mask`, :319, `mesh_intersect_wide`, :461, and
`mesh_intersect_wide_sorted`, :539).

Contract, as in the JAX package: per active lane, the TRUE closest hit
strictly below t_bound over the wide forest (scene/bvh8.py), which covers
every mesh; normal normalized and faced toward the ray; t = -1, mat = -1 and
a zero normal on a miss and on inactive lanes.

The TPU kernels walk one stack per 128-ray packet and test each popped
node's 8 children against the whole packet. Here each ray walks alone
(csrc/wide.cu), with one of the JAX package's two stack disciplines:
  "push": one stack entry (entry, entry-t) per wanted child, pushed far to
      near, so the nearest child is popped first (bvh_pallas.py's design,
      the reference's per-thread stack, src/intersections.cu:167-213);
  "mask": one packed entry per node on the DFS path, (node, wanted-children
      mask, direction bit), whose nearest remaining child is taken each
      step.
Both visit the same children in the same order, so their results are
equal bit for bit. "Near to far" is along the node's sort axis by the sign
of the lane's own direction (the TPU used the packet's summed direction),
and a lane tests only the leaves whose boxes its own ray enters (the TPU
tested a leaf for the whole packet once any lane wanted it); either can
change a result only through an exact tie between two triangles, or a ray
that grazes a box edge in float arithmetic.

`wide_walk` launches csrc/wide.cu for CUDA tensors and runs
`wide_walk_plain`, the same per-ray walk in plain PyTorch (all lanes in
lockstep, each with its own stack), for CPU tensors. `packet_rows`, a TPU
block size with no meaning for a per-thread walk, is not ported.
"""
from __future__ import annotations

import torch

from ..scene.bvh8 import MAX_DEPTH, MAX_WIDE_GROUPS
from ..scene.types import TRI_STRIDE, WIDE_GROUPS_PER_BLOCK, \
    WIDE_NODES_PER_BLOCK
from ..utils.vec import Vec3
from . import kernels
from .bvh_packet import SORT_CHUNK, closest_hit, coherence_sorted, count, slab

FLT_MAX = 3.402823466e38
NEG_MAX = -3.402823466e38
STACK = 7 * MAX_DEPTH + 8   # push-stack bound (scene/bvh8.py MAX_DEPTH)
MASK_STACK = MAX_DEPTH + 1  # mask-stack bound: one entry per DFS level
LEAF_TAG = 1 << 30          # push entries >= LEAF_TAG encode (group, count)
MAX_MASK_NODES = 1 << 22    # mask entries hold the node id in bits 8..29
VARIANT = "push"            # the JAX package's default (wide.py:71)
VARIANTS = ("push", "mask")


def _records(nodes8_f, nodes8_i, tris8):
    """The packed (8, 128) blocks as per-record tables: child boxes
    [W, 8, 8] (node, slot, field), child records [W, 8, 4] (kind, a, b,
    axis) and triangles [G*8, 20] (group g's triangle k at row g*8 + k)."""
    per = WIDE_NODES_PER_BLOCK
    nf = nodes8_f.reshape(-1, 8, per, 8).permute(0, 2, 1, 3).reshape(-1, 8, 8)
    ni = nodes8_i.reshape(-1, 8, per, 8).permute(0, 2, 1, 3).reshape(-1, 8, 8)
    gpb = WIDE_GROUPS_PER_BLOCK
    tris = tris8.reshape(-1, 8, 128)[:, :, :gpb * TRI_STRIDE].reshape(
        -1, 8, gpb, TRI_STRIDE).permute(0, 2, 1, 3).reshape(-1, TRI_STRIDE)
    return nf, ni[..., :4], tris


def _slab8(nf, ni, node, o, inv, t_min, counts):
    """Slab test of the 8 children of wide node node[l] against lane l's
    ray (bvh_pallas.py's slab order, NaN-propagating min/max): returns the
    want mask [L, 8] (kind != 0, entered closer than t_min), the entry t
    [L, 8] and the child records [L, 8, 4]."""
    if counts is not None:
        count(counts, "box_tests", 8 * node.shape[0])
    fv, iv = nf[node], ni[node]
    t0, t1 = slab(fv[..., 0:3].unbind(-1), fv[..., 3:6].unbind(-1),
                  [a[:, None] for a in o], [a[:, None] for a in inv])
    want = ((iv[..., 0] != 0) & (t0 <= t1) & (t1 > 0.0)
            & (t0 < t_min[:, None]))
    return want, t0, iv


def _near_first(iv, d):
    """True where ascending child slots run near to far for the lane: the
    sign of its direction along the node's sort axis (slot 0's axis)."""
    axis = iv[:, 0, 3]
    dsum = torch.where(axis == 0, d[0], torch.where(axis == 1, d[1], d[2]))
    return dsum >= 0.0


def _leaf(tris, n_groups, g0, ng, lanes, best, o, d, counts):
    """Moller-Trumbore of lanes[l] against the 8-triangle groups
    g0[l] .. g0[l] + max(ng[l], 1) - 1, in order, keeping the first of the
    closest hits strictly below its t_min (wide.py `_mt_group8`)."""
    t_min, nx, ny, nz, mat = best
    g = torch.arange(MAX_WIDE_GROUPS, device=g0.device)
    grp = g0[:, None] + g[None, :]                                 # [L, 2]
    use = (((g[None, :] == 0) | (g[None, :] < ng[:, None])) & (grp >= 0)
           & (grp < n_groups))
    k = torch.arange(8, device=g0.device)
    idx = (grp[:, :, None] * 8 + k).reshape(len(lanes), -1)       # [L, 16]
    mask = use[:, :, None].expand(-1, -1, 8).reshape(len(lanes), -1)
    if counts is not None:
        count(counts, "tri_tests", mask.sum())
    idx = torch.where(mask, idx, 0)
    hit, t, hx, hy, hz, hm = closest_hit(
        tris, idx, mask, *(a[lanes] for a in o), *(a[lanes] for a in d),
        t_min[lanes])
    t_min[lanes] = torch.where(hit, t, t_min[lanes])
    nx[lanes] = torch.where(hit, hx, nx[lanes])
    ny[lanes] = torch.where(hit, hy, ny[lanes])
    nz[lanes] = torch.where(hit, hz, nz[lanes])
    mat[lanes] = torch.where(hit, hm, mat[lanes])


def _walk_push(nf, ni, tris, root, o, d, inv, best, lanes, cull, counts):
    """The push-stack walk of every lane in `lanes`, in lockstep."""
    n = o[0].shape[0]
    n_wide, n_groups = nf.shape[0], tris.shape[0] // 8
    dev = o[0].device
    t_min = best[0]
    stack = torch.zeros((n, STACK + 1), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((n, STACK + 1), device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stack[lanes, 0] = root
    stack_t[lanes, 0] = NEG_MAX
    sp[lanes] = 1
    for _ in range(8 * n_wide + 1):
        if lanes.numel() == 0:
            break
        top = sp[lanes] - 1
        sp[lanes] = top
        e = stack[lanes, top]
        live = (stack_t[lanes, top] < t_min[lanes] if cull
                else torch.ones_like(e, dtype=torch.bool))
        node = live & (e < LEAF_TAG) & (e >= 0) & (e < n_wide)
        if bool(node.any()):
            ln, en = lanes[node], e[node]
            want, t0, iv = _slab8(nf, ni, en, [a[ln] for a in o],
                                  [a[ln] for a in inv], t_min[ln], counts)
            centry = torch.where(iv[..., 0] == 2,
                                 LEAF_TAG + iv[..., 1].long() * 4
                                 + iv[..., 2].long(), iv[..., 1].long())
            # far to near: the nearest wanted child lands on top
            w = want.long()
            total = w.sum(dim=1, keepdim=True)
            fwd = torch.cumsum(w, dim=1) - w      # wanted before the slot
            bwd = total - fwd - w                 # wanted after it
            near_first = _near_first(iv, [a[ln] for a in d])
            pos = sp[ln][:, None] + torch.where(near_first[:, None], bwd, fwd)
            pos = torch.where(want & (pos < STACK), pos, STACK)   # dummy slot
            stack[ln[:, None], pos] = centry
            stack_t[ln[:, None], pos] = t0
            sp[ln] = torch.clamp(sp[ln] + total[:, 0], max=STACK)
        leaf = live & (e >= LEAF_TAG)
        if bool(leaf.any()):
            code = e[leaf] - LEAF_TAG
            _leaf(tris, n_groups, code // 4, code % 4, lanes[leaf], best, o,
                  d, counts)
        lanes = lanes[sp[lanes] > 0]


def _walk_mask(nf, ni, tris, root, o, d, inv, best, lanes, counts):
    """The mask-stack walk of every lane in `lanes`, in lockstep. Entry
    layout as wide.py:327-329: bits 0..7 the wanted children not yet
    taken, bits 8..29 the node, bit 30 set when ascending slots run near
    to far."""
    n = o[0].shape[0]
    n_wide, n_groups = nf.shape[0], tris.shape[0] // 8
    dev = o[0].device
    t_min = best[0]
    stack = torch.zeros((n, MASK_STACK + 1), dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    slot_bit = 1 << torch.arange(8, device=dev)

    def push(ln, node):
        """Slab-test node[l]'s children for lanes ln and push an entry
        where any is wanted."""
        want, _, iv = _slab8(nf, ni, node, [a[ln] for a in o],
                             [a[ln] for a in inv], t_min[ln], counts)
        bits = (want.long() * slot_bit).sum(dim=1)
        dpos = _near_first(iv, [a[ln] for a in d]).long()
        pos = torch.where((bits != 0) & (sp[ln] < MASK_STACK), sp[ln],
                          MASK_STACK)
        stack[ln, pos] = (node << 8) | bits | (dpos << 30)
        sp[ln] = torch.where(pos < MASK_STACK, sp[ln] + 1, sp[ln])

    if lanes.numel():
        push(lanes, torch.full_like(lanes, root))
    lanes = lanes[sp[lanes] > 0]
    for _ in range(8 * n_wide + 1):
        if lanes.numel() == 0:
            break
        top = sp[lanes] - 1
        e = stack[lanes, top]
        mask = e & 0xFF
        parent = (e >> 8) & 0x3FFFFF
        # nearest remaining child: the lowest set bit when ascending slots
        # run near to far, else the highest
        iso_lo = mask & -mask
        h = mask | (mask >> 1)
        h = h | (h >> 2)
        h = h | (h >> 4)
        iso = torch.where(((e >> 30) & 1) == 1, iso_lo, h - (h >> 1))
        cix = ((iso & 0xAA) != 0).long() + ((iso & 0xCC) != 0).long() * 2 \
            + ((iso & 0xF0) != 0).long() * 4
        mask2 = mask & ~iso
        stack[lanes, top] = (e & ~0xFF) | mask2
        sp[lanes] = torch.where(mask2 == 0, top, top + 1)
        rec = ni[parent, cix]                                     # [L, 4]
        kind, a, b = rec[:, 0], rec[:, 1].long(), rec[:, 2].long()
        leaf = kind == 2
        if bool(leaf.any()):
            _leaf(tris, n_groups, a[leaf], b[leaf], lanes[leaf], best, o, d,
                  counts)
        node = ~leaf & (a >= 0) & (a < n_wide)
        if bool(node.any()):
            push(lanes[node], a[node])
        lanes = lanes[sp[lanes] > 0]


def wide_walk_plain(nodes8_f, nodes8_i, tris8, root, ox, oy, oz, dx, dy,
                    dz, act, tb, variant: str = VARIANT, cull: bool = False,
                    counts=None):
    """Plain PyTorch version of csrc/wide.cu: (t, nx, ny, nz, mat) per lane.
    `root` is a [1] int32 tensor (the scene's wide_root); `cull` (push
    only) skips a popped entry whose entry t is at or beyond the lane's
    closest hit so far, which changes no result. `counts`, when given,
    gains the box and triangle tests the kernel does on these inputs."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: expected one of {VARIANTS}")
    nf, ni, tris = _records(nodes8_f, nodes8_i, tris8)
    n = ox.shape[0]
    dev = ox.device
    o, d = [ox, oy, oz], [dx, dy, dz]
    inv = [1.0 / a for a in d]
    active = act > 0
    best = [torch.where(active, tb, NEG_MAX)] + [
        torch.zeros(n, device=dev) for _ in range(3)] + [
        torch.full((n,), -1, dtype=torch.int32, device=dev)]
    r = int(root.reshape(-1)[0])
    lanes = torch.nonzero(active).reshape(-1)
    if not 0 <= r < nf.shape[0]:
        lanes = lanes[:0]
    if variant == "push":
        _walk_push(nf, ni, tris, r, o, d, inv, best, lanes, cull, counts)
    else:
        _walk_mask(nf, ni, tris, r, o, d, inv, best, lanes, counts)
    t_min, nx, ny, nz, mat = best
    # normalize and face the winner's normal toward the ray (the TPU kernel
    # does it per candidate before choosing: the same arithmetic on the same
    # triangle); a miss keeps the zero normal
    inv_len = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                           min=1e-30))
    fl = torch.where(dx * nx + dy * ny + dz * nz > 0.0, -inv_len, inv_len)
    return (torch.where(mat < 0, -1.0, t_min), nx * fl, ny * fl, nz * fl,
            mat)


def wide_walk(nodes8_f, nodes8_i, tris8, root, ox, oy, oz, dx, dy, dz,
              act, tb, variant: str = VARIANT, cull: bool = False):
    """(t, nx, ny, nz, mat) per lane: csrc/wide.cu (pt_wide_push or
    pt_wide_mask by `variant`) on CUDA tensors, the plain version on CPU
    tensors."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: expected one of {VARIANTS}")
    if variant == "mask" and cull:
        raise ValueError("cull applies to the push variant only")
    if ox.device.type == "cpu":
        return wide_walk_plain(nodes8_f, nodes8_i, tris8, root, ox, oy, oz,
                               dx, dy, dz, act, tb, variant=variant,
                               cull=cull)
    n = ox.shape[0]
    dev = kernels.check(
        "wide_" + variant, n, nodes_f32=nodes8_f, nodes_i32=nodes8_i,
        tris_f32=tris8, ray_ox_f32=ox, ray_oy_f32=oy, ray_oz_f32=oz,
        ray_dx_f32=dx, ray_dy_f32=dy, ray_dz_f32=dz, ray_act_i32=act,
        ray_tb_f32=tb, one_root_i32=root)
    if (nodes8_f.shape != nodes8_i.shape or nodes8_f.shape[0] % 8
            or tris8.shape[0] % 8):
        raise ValueError(
            f"wide_{variant}: nodes8 {tuple(nodes8_f.shape)} / "
            f"{tuple(nodes8_i.shape)} and tris8 {tuple(tris8.shape)} must "
            "be whole (8, 128) blocks")
    n_wide = nodes8_f.shape[0] // 8 * WIDE_NODES_PER_BLOCK
    if variant == "mask" and n_wide >= MAX_MASK_NODES:
        raise ValueError("wide forest too large for packed mask entries")
    n_groups = tris8.shape[0] // 8 * WIDE_GROUPS_PER_BLOCK
    t, nx, ny, nz, mat = kernels.hit_outputs(n, ox.device)
    if n:
        p = kernels.ptr
        extra = (int(cull),) if variant == "push" else ()
        kernels.launch("wide_" + variant, dev, p(nodes8_f), p(nodes8_i),
                       n_wide, p(tris8), n_groups, p(root), p(ox), p(oy),
                       p(oz), p(dx), p(dy), p(dz), p(act), p(tb), *extra,
                       p(t), p(nx), p(ny), p(nz), p(mat), n)
    return t, nx, ny, nz, mat


def mesh_intersect_wide(scene, origin: Vec3, direction: Vec3, active=None,
                        t_bound=None, cull: bool = False,
                        variant: str | None = None):
    """8-wide mesh intersection over the whole ray pool, every mesh in one
    walk (wide.py:461): (t [N], normal Vec3, mat [N]), t = -1 where no hit
    is strictly closer than `t_bound`. `cull` and `variant` (None: VARIANT)
    change speed only, never a result. Needs the scene's wide tables
    (load_scene(wide_tables=True))."""
    if not scene.wide_built:
        # the placeholder forest has no slot to enter: reject a scene loaded
        # without the tables rather than miss every triangle
        raise ValueError("the 8-wide walk (bvh_impl 'wide' / 'wide_nosort', "
                         "fallback_impl 'wide') needs "
                         "load_scene(wide_tables=True)")
    n = origin.x.shape[0]
    dev = origin.x.device
    act = (torch.ones(n, dtype=torch.int32, device=dev) if active is None
           else active.to(torch.int32).contiguous())
    tb = (torch.full((n,), FLT_MAX, device=dev) if t_bound is None
          else t_bound.contiguous())
    o = [c.contiguous() for c in origin]
    d = [c.contiguous() for c in direction]
    t, nx, ny, nz, mat = wide_walk(scene.nodes8_f, scene.nodes8_i,
                                   scene.tris8, scene.wide_root, *o, *d,
                                   act, tb, variant=variant or VARIANT,
                                   cull=cull)
    return t, Vec3(nx, ny, nz), mat


def mesh_intersect_wide_sorted(scene, mesh_roots, origin: Vec3,
                               direction: Vec3, active=None, t_bound=None,
                               sort_chunk: int = SORT_CHUNK,
                               variant: str | None = None):
    """The 8-wide walk over coherence-sorted chunks (wide.py:539,
    bvh_impl="wide"): the candidates are the lanes that enter any binary
    mesh-root box closer than the bound (bvh_packet.coherence_sorted). The
    same (t, normal, mat) as mesh_intersect_wide."""
    def walk(o, d, act, tb):
        return mesh_intersect_wide(scene, o, d, active=act, t_bound=tb,
                                   variant=variant)
    return coherence_sorted(walk, scene, mesh_roots, origin, direction,
                            active, t_bound, sort_chunk)
