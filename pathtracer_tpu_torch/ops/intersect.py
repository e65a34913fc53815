"""Ray-primitive intersection over the ray pool (Vec3 SoA).

The port of pathtracer_tpu/ops/intersect.py (reference src/intersections.cu):
the analytic box and sphere tests, the slab test, and the scene-level closest
hit `intersect_scene`: its boxes and spheres by one launch of
csrc/analytic.cu on CUDA (`analytic_hit`; `analytic_plain`, the plain twin,
on the CPU and for the gradients), then its mesh intersectors, named
as in the JAX package: "binned" (ops/binned.py, the default for mesh
scenes), "pallas" (the packet walk alone, ops/bvh_packet.py), "sorted" (the
packet walk over coherence-sorted chunks), "wide" / "wide_nosort" (the
8-wide walk, ops/wide.py, with or without that sort), "brute" (every
triangle, ops/brute.py) and "jnp" (`mesh_intersect`, the stackless reference
walk of the JAX package, differentiable end to end). Every t is the
world-ray parameter; t <= 0 encodes a miss.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from ..scene.types import MESH, SPHERE, SceneArrays
from ..utils.vec import Vec3, mat4_apply
from . import kernels

FLT_MAX = 3.402823466e38
BVH_IMPLS = ("binned", "wide", "wide_nosort", "pallas", "sorted", "brute",
             "jnp")


def box_intersect(transform, inverse_transform, inv_transpose,
                  origin: Vec3, direction: Vec3
                  ) -> Tuple[torch.Tensor, Vec3]:
    """Unit-cube intersection for one geom against [N] rays
    (intersections.cu:3-57, with the JAX package's unnormalized object-space
    direction). Returns (t [N], normal Vec3); t = -1 on miss."""
    qo = mat4_apply(inverse_transform, origin, 1.0)
    qd = mat4_apply(inverse_transform, direction, 0.0)

    tmin = torch.full_like(qo.x, -FLT_MAX)
    tmax = torch.full_like(qo.x, FLT_MAX)
    zeros = torch.zeros_like(qo.x)
    nmin = [zeros, zeros, zeros]
    nmax = [zeros, zeros, zeros]
    for axis, (oc, dc) in enumerate(((qo.x, qd.x), (qo.y, qd.y),
                                     (qo.z, qd.z))):
        # |dc| clamped away from zero as in the JAX package (its gradient
        # guard); 1e-20 keeps t beyond any scene scale
        dc = torch.where(torch.abs(dc) < 1e-20,
                         torch.where(dc < 0, -1e-20, 1e-20), dc)
        t1 = (-0.5 - oc) / dc
        t2 = (0.5 - oc) / dc
        ta = torch.minimum(t1, t2)
        tb = torch.maximum(t1, t2)
        sgn = torch.where(t2 < t1, 1.0, -1.0)
        upd_min = torch.logical_and(ta > 0.0, ta > tmin)
        tmin = torch.where(upd_min, ta, tmin)
        # the axis one-hot times sgn (the off-axis zeros keep their sign,
        # as in the JAX package)
        n_ax = [sgn * float(c == axis) for c in range(3)]
        nmin = [torch.where(upd_min, n_ax[c], nmin[c]) for c in range(3)]
        upd_max = tb < tmax
        tmax = torch.where(upd_max, tb, tmax)
        nmax = [torch.where(upd_max, n_ax[c], nmax[c]) for c in range(3)]

    hit = torch.logical_and(tmax >= tmin, tmax > 0.0)
    inside = tmin <= 0.0
    t_world = torch.where(inside, tmax, tmin)
    n_obj = Vec3.where(inside, Vec3(*nmax), Vec3(*nmin))

    normal = mat4_apply(inv_transpose, n_obj, 0.0).normalize()
    return torch.where(hit, t_world, -1.0), normal


def sphere_intersect(transform, inverse_transform, inv_transpose,
                     origin: Vec3, direction: Vec3
                     ) -> Tuple[torch.Tensor, Vec3]:
    """r=0.5 sphere for one geom against [N] rays (intersections.cu:59-113,
    full quadratic on the unnormalized object-space direction)."""
    radius = 0.5
    ro = mat4_apply(inverse_transform, origin, 1.0)
    rd = mat4_apply(inverse_transform, direction, 0.0)

    a = rd.dot(rd)
    b = ro.dot(rd)
    c = ro.dot(ro) - radius * radius
    radicand = b * b - a * c
    has_root = radicand >= 0.0
    sq = torch.sqrt(torch.where(has_root, torch.clamp(radicand, min=0.0),
                                1.0))
    inv_a = 1.0 / a
    t1 = (-b + sq) * inv_a
    t2 = (-b - sq) * inv_a

    both_neg = torch.logical_and(t1 < 0.0, t2 < 0.0)
    both_pos = torch.logical_and(t1 > 0.0, t2 > 0.0)
    t_world = torch.where(both_pos, torch.minimum(t1, t2),
                          torch.maximum(t1, t2))
    hit = torch.logical_and(has_root, torch.logical_not(both_neg))

    p_obj = ro + rd * t_world
    normal = mat4_apply(inv_transpose, p_obj, 0.0).normalize()
    normal = normal * torch.where(both_pos, 1.0, -1.0)
    return torch.where(hit, t_world, -1.0), normal


def aabb_intersect(bmin: Vec3, bmax: Vec3, origin: Vec3, inv_dir: Vec3
                   ) -> torch.Tensor:
    """Branchless slab test (intersections.cu:116-129). Returns entry t
    (exit t if the origin is inside), -1 on miss."""
    t_near = (bmin - origin) * inv_dir
    t_far = (bmax - origin) * inv_dir
    t0 = Vec3.minimum(t_near, t_far).max_component()
    t1 = Vec3.maximum(t_near, t_far).min_component()
    return torch.where(t0 > t1, -1.0,
                       torch.where(t0 > 0.0, t0,
                                   torch.where(t1 > 0.0, t1, -1.0)))


def triangle_intersect(v0: Vec3, v1: Vec3, v2: Vec3,
                       n0: Vec3, n1: Vec3, n2: Vec3,
                       origin: Vec3, direction: Vec3
                       ) -> Tuple[torch.Tensor, Vec3]:
    """Moller-Trumbore with smooth normals (intersections.cu:132-163).
    Returns (t, normal) with t = -1 on miss; the normal faces the ray."""
    t, u, v = _triangle_t_uv(v0, v1, v2, origin, direction)
    w = 1.0 - u - v
    n = (n0 * w + n1 * u + n2 * v).normalize()
    return t, n * torch.where(direction.dot(n) > 0.0, -1.0, 1.0)


def _triangle_t_uv(v0: Vec3, v1: Vec3, v2: Vec3, origin: Vec3,
                   direction: Vec3):
    """Moller-Trumbore hit test returning (t, u, v); t = -1 on miss. The
    normal interpolation is left to the caller (mesh_intersect does it once
    a ray, on the winning triangle)."""
    eps = 1e-6
    e1 = v1 - v0
    e2 = v2 - v0
    h = direction.cross(e2)
    a = e1.dot(h)
    parallel = torch.abs(a) < eps
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = origin - v0
    u = f * s.dot(h)
    q = s.cross(e1)
    v = f * direction.dot(q)
    t = f * e2.dot(q)

    valid = torch.logical_not(parallel)
    valid = torch.logical_and(valid, torch.logical_and(u >= 0.0, u <= 1.0))
    valid = torch.logical_and(valid,
                              torch.logical_and(v >= 0.0, (u + v) <= 1.0))
    valid = torch.logical_and(valid, t >= eps)
    return torch.where(valid, t, -1.0), u, v


def mesh_intersect(scene: SceneArrays, root_node: int,
                   origin: Vec3, direction: Vec3
                   ) -> Tuple[torch.Tensor, Vec3, torch.Tensor]:
    """The stackless ENTER/ADVANCE walk of one mesh, every lane in lockstep
    (pathtracer_tpu/ops/intersect.py:215, bvh_impl "jnp"):

      ENTER(n):   slab test (+ the leaf's triangles); a visited interior
                  node -> ENTER its left child n+1; else -> ADVANCE(n).
      ADVANCE(n): a left child -> ENTER(sibling[n]); a right child ->
                  ADVANCE(parent[n]); the root -> done.

    It keeps the reference's prune quirk: a node is visited when its slab
    t (the EXIT t where the origin is inside the box) is below the closest
    hit so far, so an inside-origin subtree can be pruned. The walk is
    left-first. A leaf's triangles are tested together: the first of those
    with the smallest t under the bound wins, which is the JAX package's
    sequential strict-less update. The loop ends when every lane is done
    (a host read a step).

    The walk finds each lane's winning triangle without autograd; t, u, v
    and the smooth normal are then computed once more, on that triangle,
    with autograd (the same operations on the same values, so the same
    bits): the result is differentiable in the rays, as the JAX walk is.
    Needs the scene's triangle table (load_scene(bvh_impl="jnp")).
    Returns (t [N], normal Vec3, material_id [N]); t = -1 on miss.
    """
    tris = scene.triangles
    if tris.count == 0:
        raise ValueError("bvh_impl='jnp' needs the triangle table: "
                         "load_scene(..., bvh_impl='jnp')")
    bvh = scene.bvh
    n = origin.x.shape[0]
    dev = origin.x.device
    n_tris = tris.count
    with torch.no_grad():
        o = Vec3(*(c.detach() for c in origin))
        d = Vec3(*(c.detach() for c in direction))
        inv_dir = 1.0 / d
        node = torch.full((n,), int(root_node), dtype=torch.int64,
                          device=dev)
        enter = torch.ones(n, dtype=torch.bool, device=dev)
        done = torch.zeros(n, dtype=torch.bool, device=dev)
        t_min = torch.full((n,), FLT_MAX, device=dev)
        best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
        while not bool(done.all()):
            bmin = Vec3(bvh.min_x[node], bvh.min_y[node], bvh.min_z[node])
            bmax = Vec3(bvh.max_x[node], bvh.max_y[node], bvh.max_z[node])
            tri_count = bvh.tri_count[node]
            sib = bvh.sibling[node].long()
            par = bvh.parent[node].long()

            entering = torch.logical_and(enter, torch.logical_not(done))
            box_t = aabb_intersect(bmin, bmax, o, inv_dir)
            visit = torch.logical_and(
                entering, torch.logical_and(box_t >= 0.0, box_t < t_min))
            is_leaf = tri_count > 0

            lanes = torch.nonzero(torch.logical_and(visit, is_leaf))[:, 0]
            if lanes.numel():
                count = tri_count[lanes]
                j = torch.arange(int(count.max()), device=dev)
                first = torch.clamp(bvh.tri_first[node[lanes]], min=0).long()
                ti = torch.clamp(first[:, None] + j[None, :],
                                 max=n_tris - 1)                  # [L, K]
                ol = Vec3(*(c[lanes, None] for c in o))
                dl = Vec3(*(c[lanes, None] for c in d))
                t_tri, _, _ = _triangle_t_uv(
                    tris.vertex("v0", ti), tris.vertex("v1", ti),
                    tris.vertex("v2", ti), ol, dl)
                cand = torch.logical_and(j[None, :] < count[:, None],
                                         t_tri > 0.0)
                t_leaf, k = torch.where(cand, t_tri, torch.inf).min(dim=1)
                upd = t_leaf < t_min[lanes]
                t_min[lanes] = torch.where(upd, t_leaf, t_min[lanes])
                best_tri[lanes] = torch.where(
                    upd, ti.gather(1, k[:, None])[:, 0], best_tri[lanes])

            descend = torch.logical_and(visit, torch.logical_not(is_leaf))
            has_sib = sib >= 0
            next_node = torch.where(descend, node + 1,
                                    torch.where(has_sib, sib,
                                                torch.clamp(par, min=0)))
            next_enter = torch.logical_or(descend, has_sib)
            finished = torch.logical_and(
                torch.logical_not(descend),
                torch.logical_and(torch.logical_not(has_sib), par < 0))
            done = torch.logical_or(done, finished)
            node = torch.where(done, node, next_node)
            enter = torch.where(done, enter, next_enter)
        hit = torch.logical_and(best_tri >= 0, t_min < FLT_MAX)
        ti = torch.clamp(best_tri, min=0)

    # the winner's t, u, v and smooth normal, with autograd
    t, u, v = _triangle_t_uv(tris.vertex("v0", ti), tris.vertex("v1", ti),
                             tris.vertex("v2", ti), origin, direction)
    u = torch.where(hit, u, 0.0)
    v = torch.where(hit, v, 0.0)
    w = 1.0 - u - v
    nrm = (tris.vertex("n0", ti) * w + tris.vertex("n1", ti) * u
           + tris.vertex("n2", ti) * v).normalize()
    nrm = nrm * torch.where(direction.dot(nrm) > 0.0, -1.0, 1.0)
    mat = torch.where(hit, tris.material_id[ti], -1)
    return torch.where(hit, t, -1.0), nrm, mat


def _constant(fn, *args, **kwargs):
    """fn's hits as constants: no autograd graph through a mesh kernel or
    its plain version (the JAX package's stop_gradient,
    pathtracer_tpu/ops/intersect.py:358-366,419,456)."""
    with torch.no_grad():
        return tuple(a.detach() if isinstance(a, torch.Tensor)
                     else Vec3(*(c.detach() for c in a))
                     for a in fn(*args, **kwargs))


def _merge(best, t, nrm, mat):
    """The closest-hit merge of one intersector's (t, normal, material) into
    best = (t_best, n_best, m_best, any_hit): a lane takes the hit where
    t > 0 and t < t_best, strictly, so the first of equal t wins."""
    t_best, n_best, m_best, any_hit = best
    upd = torch.logical_and(t > 0.0, t < t_best)
    return (torch.where(upd, t, t_best), Vec3.where(upd, nrm, n_best),
            torch.where(upd, mat, m_best), torch.logical_or(any_hit, upd))


def analytic_plain(scene: SceneArrays, geom_types: Tuple[int, ...],
                   origin: Vec3, direction: Vec3):
    """The closest hit over the scene's boxes and spheres in plain PyTorch,
    merged in table order: (t_best [N], FLT_MAX where none is hit; normal
    Vec3, +0 there; material_id [N] int32, 0 there; any_hit [N] bool).
    Differentiable in the rays and the geom transforms. The twin of
    csrc/analytic.cu (ops/kernels.py `analytic`), which gives its bits."""
    n = origin.x.shape[0]
    dev = origin.x.device
    best = (torch.full((n,), FLT_MAX, device=dev), Vec3.zeros(n, dev),
            torch.zeros((n,), dtype=torch.int32, device=dev),
            torch.zeros((n,), dtype=torch.bool, device=dev))
    g = scene.geoms
    for i, gt in enumerate(geom_types):
        if gt == MESH:
            continue
        fn = sphere_intersect if gt == SPHERE else box_intersect
        t, nrm = fn(g.transform[i], g.inverse_transform[i],
                    g.inv_transpose[i], origin, direction)
        best = _merge(best, t, nrm, g.material_id[i].expand(n))
    return best


def analytic_twin(scene: SceneArrays, geom_types: Tuple[int, ...],
                  inverse_transform, inv_transpose, ox, oy, oz, dx, dy, dz):
    """analytic_plain with the geom tables' transforms `inverse_transform`
    and `inv_transpose`, on ray planes: kernels.analytic's outputs (t, nx,
    ny, nz, material_id, any_hit)."""
    geoms = dataclasses.replace(scene.geoms,
                                inverse_transform=inverse_transform,
                                inv_transpose=inv_transpose)
    t, nrm, mat, hit = analytic_plain(dataclasses.replace(scene, geoms=geoms),
                                      geom_types, Vec3(ox, oy, oz),
                                      Vec3(dx, dy, dz))
    return t, *nrm, mat, hit


def analytic_hit(scene: SceneArrays, geom_types: Tuple[int, ...],
                 origin: Vec3, direction: Vec3):
    """analytic_plain's result: on CPU tensors analytic_plain itself; on
    CUDA tensors one launch of csrc/analytic.cu, with analytic_twin's
    gradients in the rays and the geom transforms (kernels.with_twin)."""
    if origin.x.device.type != "cuda":
        return analytic_plain(scene, geom_types, origin, direction)
    g = scene.geoms
    t, nx, ny, nz, mat, hit = kernels.with_twin(
        # inv and invt are g's own transforms, which the wrapper reads
        lambda inv, invt, *rays: kernels.analytic(g, *rays),
        functools.partial(analytic_twin, scene, geom_types),
        g.inverse_transform, g.inv_transpose,
        *(c.contiguous() for c in (*origin, *direction)))
    return t, Vec3(nx, ny, nz), mat, hit


def intersect_scene(scene: SceneArrays, geom_types: Tuple[int, ...],
                    origin: Vec3, direction: Vec3,
                    bvh_impl: str = "pallas", active=None
                    ) -> Tuple[torch.Tensor, Vec3, torch.Tensor]:
    """Closest hit over all geoms (computeIntersectionsNaive,
    pathtrace.cu:441-522).

    Analytic geoms run first (`analytic_hit`: one kernel launch on CUDA);
    their closest hit is the mesh intersector's
    pruning bound `t_bound`, exactly as in the JAX package. `bvh_impl` is
    one of BVH_IMPLS (dispatch of intersect.py:394-457): "binned", "wide",
    "wide_nosort" and "brute" make one pass over all meshes ("brute"
    ignores `active` and the bound, which the merge then applies);
    "pallas", "sorted" and "jnp" walk each mesh root in turn ("jnp"
    without the bound, as in the JAX package).

    Differentiability, as in the JAX package: the analytic tests and the
    "jnp" walk carry autograd; every other mesh intersector returns its
    hits as constants (`_constant`). That is exact for material parameters
    and drops only the almost-everywhere-zero geometric term for camera
    ones. Returns (t [N] > 0 on hit else -1, normal Vec3, material_id [N]).
    """
    if MESH in geom_types and bvh_impl not in BVH_IMPLS:
        raise ValueError(f"bvh_impl {bvh_impl!r} is not ported; "
                         f"use one of {BVH_IMPLS}")

    best = analytic_hit(scene, geom_types, origin, direction)

    if MESH in geom_types:
        if bvh_impl == "binned":
            from .binned import mesh_intersect_binned
            best = _merge(best, *_constant(
                mesh_intersect_binned, scene, scene.mesh_roots, origin,
                direction, active=active, t_bound=best[0]))
        elif bvh_impl == "wide":
            from .wide import mesh_intersect_wide_sorted
            best = _merge(best, *_constant(
                mesh_intersect_wide_sorted, scene, scene.mesh_roots, origin,
                direction, active=active, t_bound=best[0]))
        elif bvh_impl == "wide_nosort":
            from .wide import mesh_intersect_wide
            best = _merge(best, *_constant(
                mesh_intersect_wide, scene, origin, direction, active=active,
                t_bound=best[0]))
        elif bvh_impl == "brute":
            from .brute import mesh_intersect_brute
            best = _merge(best, *_constant(mesh_intersect_brute, scene,
                                           origin, direction))
        elif bvh_impl == "jnp":
            for root in scene.mesh_roots:
                best = _merge(best, *mesh_intersect(scene, root, origin,
                                                    direction))
        else:
            from .bvh_packet import (mesh_intersect_packet,
                                     mesh_intersect_packet_sorted)
            walk = (mesh_intersect_packet_sorted if bvh_impl == "sorted"
                    else mesh_intersect_packet)
            for root in scene.mesh_roots:
                best = _merge(best, *_constant(
                    walk, scene, root, origin, direction, active=active,
                    t_bound=best[0]))

    t_best, n_best, m_best, any_hit = best
    return torch.where(any_hit, t_best, -1.0), n_best, m_best
