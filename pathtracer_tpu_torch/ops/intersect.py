"""Ray-primitive intersection over the ray pool (Vec3 SoA).

The port of pathtracer_tpu/ops/intersect.py (reference src/intersections.cu):
the analytic box and sphere tests, the slab test, and the scene-level closest
hit `intersect_scene` with its mesh intersectors, named as in the JAX
package: "binned" (ops/binned.py, the default for mesh scenes), "pallas"
(the packet walk alone, ops/bvh_packet.py), "sorted" (the packet walk over
coherence-sorted chunks), "wide" / "wide_nosort" (the 8-wide walk,
ops/wide.py, with or without that sort) and "brute" (every triangle,
ops/brute.py). Every t is the world-ray parameter; t <= 0 encodes a miss.
The reference-semantics walk "jnp" is not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..scene.types import MESH, SPHERE, SceneArrays
from ..utils.vec import Vec3, mat4_apply

FLT_MAX = 3.402823466e38
BVH_IMPLS = ("binned", "wide", "wide_nosort", "pallas", "sorted", "brute")


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


def intersect_scene(scene: SceneArrays, geom_types: Tuple[int, ...],
                    origin: Vec3, direction: Vec3,
                    bvh_impl: str = "pallas", active=None
                    ) -> Tuple[torch.Tensor, Vec3, torch.Tensor]:
    """Closest hit over all geoms (computeIntersectionsNaive,
    pathtrace.cu:441-522).

    Analytic geoms run first; their closest hit is the mesh intersector's
    pruning bound `t_bound`, exactly as in the JAX package. `bvh_impl` is
    one of BVH_IMPLS (dispatch of intersect.py:394-457): "binned", "wide",
    "wide_nosort" and "brute" make one pass over all meshes ("brute"
    ignores `active` and the bound, which the merge then applies);
    "pallas" and "sorted" walk each mesh root in turn. Returns (t [N] > 0
    on hit else -1, normal Vec3, material_id [N]).
    """
    if MESH in geom_types and bvh_impl not in BVH_IMPLS:
        raise ValueError(f"bvh_impl {bvh_impl!r} is not ported; "
                         f"use one of {BVH_IMPLS}")

    n = origin.x.shape[0]
    dev = origin.x.device
    t_best = torch.full((n,), FLT_MAX, device=dev)
    n_best = Vec3.zeros(n, dev)
    m_best = torch.zeros((n,), dtype=torch.int32, device=dev)
    any_hit = torch.zeros((n,), dtype=torch.bool, device=dev)

    def merge(t, nrm, mat):
        nonlocal t_best, n_best, m_best, any_hit
        upd = torch.logical_and(t > 0.0, t < t_best)
        t_best = torch.where(upd, t, t_best)
        n_best = Vec3.where(upd, nrm, n_best)
        m_best = torch.where(upd, mat, m_best)
        any_hit = torch.logical_or(any_hit, upd)

    g = scene.geoms
    for i, gt in enumerate(geom_types):
        if gt == MESH:
            continue
        fn = sphere_intersect if gt == SPHERE else box_intersect
        t, nrm = fn(g.transform[i], g.inverse_transform[i],
                    g.inv_transpose[i], origin, direction)
        merge(t, nrm, g.material_id[i].expand(n))

    if MESH in geom_types:
        if bvh_impl == "binned":
            from .binned import mesh_intersect_binned
            merge(*mesh_intersect_binned(scene, scene.mesh_roots, origin,
                                         direction, active=active,
                                         t_bound=t_best))
        elif bvh_impl == "wide":
            from .wide import mesh_intersect_wide_sorted
            merge(*mesh_intersect_wide_sorted(scene, scene.mesh_roots,
                                              origin, direction,
                                              active=active, t_bound=t_best))
        elif bvh_impl == "wide_nosort":
            from .wide import mesh_intersect_wide
            merge(*mesh_intersect_wide(scene, origin, direction,
                                       active=active, t_bound=t_best))
        elif bvh_impl == "brute":
            from .brute import mesh_intersect_brute
            merge(*mesh_intersect_brute(scene, origin, direction))
        else:
            from .bvh_packet import (mesh_intersect_packet,
                                     mesh_intersect_packet_sorted)
            walk = (mesh_intersect_packet_sorted if bvh_impl == "sorted"
                    else mesh_intersect_packet)
            for root in scene.mesh_roots:
                merge(*walk(scene, root, origin, direction, active=active,
                            t_bound=t_best))

    return torch.where(any_hit, t_best, -1.0), n_best, m_best
