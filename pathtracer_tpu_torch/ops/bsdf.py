"""BSDF sampling and the uber-shader as select trees (Vec3 SoA).

The port of pathtracer_tpu/ops/bsdf.py (reference src/interactions.cu and
shadeRealMaterial, pathtrace.cu:524-571). Every branch is computed for every
lane and combined with selects; `any_glossy` / `any_refractive` drop the
branches no material of the scene can take. Differentiable as the JAX
package's is: the Fresnel and gloss picks carry their branch-probability
gradient through `_branch_prob_surrogate`, and the guards against inf and NaN
in unselected branches (refract's k clamp, the IOR of non-refractive lanes,
Vec3.normalize's clamp) are kept.

`shade_lanes` is the engine's entry: a bounce's draws and shade. On CPU
tensors it draws (ops/rng.py) and runs `shade`; on CUDA tensors it launches
csrc/shade.cu (ops/kernels.py `shade`), which draws in the kernel and gives
`shade`'s bits, with the plain draw's and `shade`'s gradients
(ops/kernels.py `with_twin`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..scene.types import MaterialArrays
from ..utils.math import SQRT_OF_ONE_THIRD, TWO_PI
from ..utils.vec import Vec3
from . import kernels, rng

SCATTER_EPS = 1e-3  # interactions.cu:61
LUMA_R, LUMA_G, LUMA_B = 0.2126, 0.7152, 0.0722  # interactions.cu:75-76


def cosine_hemisphere(normal: Vec3, u1: torch.Tensor, u2: torch.Tensor) -> Vec3:
    """Cosine-weighted hemisphere sample around `normal`
    (interactions.cu:7-45)."""
    up = torch.sqrt(u1)
    over = torch.sqrt(torch.clamp(1.0 - up * up, min=0.0))
    around = u2 * TWO_PI

    # Peter Kutz not-normal trick (interactions.cu:22-34)
    ax = torch.abs(normal.x) < SQRT_OF_ONE_THIRD
    ay = torch.abs(normal.y) < SQRT_OF_ONE_THIRD
    one = torch.ones_like(normal.x)
    zero = torch.zeros_like(normal.x)
    nn_x = torch.where(ax, one, zero)
    nn_y = torch.where(ax, zero, torch.where(ay, one, zero))
    nn_z = torch.where(torch.logical_or(ax, ay), zero, one)
    not_normal = Vec3(nn_x, nn_y, nn_z)

    p1 = normal.cross(not_normal).normalize()
    p2 = normal.cross(p1).normalize()
    return (normal * up
            + p1 * (torch.cos(around) * over)
            + p2 * (torch.sin(around) * over))


def fresnel_schlick(cos_theta, eta_i, eta_t):
    """Schlick approximation (interactions.cu:47-52). pow5 as multiplies."""
    r0 = (eta_i - eta_t) / (eta_i + eta_t)
    r0 = r0 * r0
    m = torch.clamp(1.0 - cos_theta, min=0.0)
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)


def reflect(incident: Vec3, normal: Vec3) -> Vec3:
    """glm::reflect."""
    return incident - normal * (2.0 * incident.dot(normal))


def refract(incident: Vec3, normal: Vec3, eta: torch.Tensor) -> Vec3:
    """glm::refract: zero vector on total internal reflection (near-critical
    lanes, k < 1e-6, count as TIR as in the JAX package)."""
    cos_i = -incident.dot(normal)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 1e-6
    k_safe = torch.where(tir, 1.0, k)
    coeff = eta * cos_i - torch.sqrt(k_safe)
    out = incident * eta + normal * coeff
    zero = torch.zeros_like(cos_i)
    return Vec3.where(tir, Vec3(zero, zero, zero), out)


class LaneMaterials(NamedTuple):
    """Per-lane material parameters (gathered by material id)."""

    color: Vec3
    specular_color: Vec3
    has_reflective: torch.Tensor
    has_refractive: torch.Tensor
    ior: torch.Tensor
    emittance: torch.Tensor


def gather_material(materials: MaterialArrays, mat_id: torch.Tensor
                    ) -> LaneMaterials:
    """Per-lane material fetch (pathtrace.cu:550). Misses (id -1) read
    material 0, as the JAX package's select chain does."""
    mid = torch.clamp(mat_id, min=0).long()

    def col(table, c=None):
        # index_select rather than table[mid]: the same values, and its
        # backward is one index_add_, where that of advanced indexing sorts
        # the lane ids and, on CUDA, sums each run of one material serially
        return torch.index_select(table if c is None else table[:, c], 0,
                                  mid)

    return LaneMaterials(
        color=Vec3(col(materials.color, 0), col(materials.color, 1),
                   col(materials.color, 2)),
        specular_color=Vec3(col(materials.specular_color, 0),
                            col(materials.specular_color, 1),
                            col(materials.specular_color, 2)),
        has_reflective=col(materials.has_reflective),
        has_refractive=col(materials.has_refractive),
        ior=col(materials.ior),
        emittance=col(materials.emittance),
    )


def _branch_prob_surrogate(took_first: torch.Tensor, p: torch.Tensor
                           ) -> torch.Tensor:
    """Value-1 weight whose gradient carries the branch-probability
    derivative (pathtracer_tpu/ops/bsdf.py:146): the taken branch is
    weighted by p / detach(p) (or (1-p) / (1-detach(p))), so every sample
    keeps its value and E[w f] = p f_first + (1-p) f_other is
    differentiable in p. Its value is 1, except where the probability of
    the taken branch is below the 1e-6 clamp."""
    p0 = p.detach()
    w_first = p / torch.clamp(p0, min=1e-6)
    w_other = (1.0 - p) / torch.clamp(1.0 - p0, min=1e-6)
    return torch.where(took_first, w_first, w_other)


class ScatterResult(NamedTuple):
    origin: Vec3
    direction: Vec3
    throughput: Vec3  # multiplier applied to path color


def scatter_ray(direction: Vec3, hit_point: Vec3, normal: Vec3,
                m: LaneMaterials,
                u_pick: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor,
                u_fresnel: torch.Tensor,
                any_glossy: bool = True,
                any_refractive: bool = True) -> ScatterResult:
    """Vectorized scatterRay (interactions.cu:54-149) over [N] lanes:
    diffuse iff refl == 0 and refr == 0; glossy iff refl != 0 and refr == 0
    (luminance-weighted pick); refractive iff refr != 0 (Schlick pick)."""
    base_origin = hit_point + normal * SCATTER_EPS  # interactions.cu:62

    diff_dir = cosine_hemisphere(normal, u1, u2)
    out_dir = diff_dir
    out_origin = base_origin
    throughput = m.color

    if any_glossy:
        def luma(c: Vec3):
            return c.x * LUMA_R + c.y * LUMA_G + c.z * LUMA_B

        is_gloss = torch.logical_and(m.has_reflective != 0.0,
                                     m.has_refractive == 0.0)
        roughness = 1.0 - m.has_reflective
        diffuse_luma = luma(m.color) * (roughness + 0.2)
        specular_luma = luma(m.specular_color) * (1.0 - roughness)
        p_diffuse = diffuse_luma / (diffuse_luma + specular_luma + 1e-6)
        gloss_take_diffuse = u_pick < p_diffuse
        mirror_dir = reflect(direction, normal).normalize()
        gloss_dir = Vec3.where(gloss_take_diffuse, diff_dir, mirror_dir)
        gloss_thr = Vec3.where(gloss_take_diffuse, m.color, m.specular_color)
        gloss_thr = gloss_thr * _branch_prob_surrogate(gloss_take_diffuse,
                                                       p_diffuse)
        out_dir = Vec3.where(is_gloss, gloss_dir, out_dir)
        throughput = Vec3.where(is_gloss, gloss_thr, throughput)

    if any_refractive:
        is_refr = m.has_refractive != 0.0
        cos_i0 = -direction.dot(normal)
        entering = cos_i0 > 0.0
        flip = torch.where(entering, 1.0, -1.0)
        r_normal = normal * flip
        cos_i = torch.abs(cos_i0)
        ior = torch.where(m.ior > 0.0, m.ior, 1.0)
        ior_from = torch.where(entering, 1.0, ior)
        ior_to = torch.where(entering, ior, 1.0)
        eta = ior_from / ior_to
        reflect_prob = fresnel_schlick(cos_i, ior_from, ior_to)
        refr_dir = refract(direction, r_normal, eta)
        tir = refr_dir.length_sq() < 1e-16  # |v| < 1e-8, interactions.cu:132
        do_reflect = torch.logical_or(tir, u_fresnel < reflect_prob)
        refl_dir = reflect(direction, r_normal).normalize()
        refr_dir_n = Vec3.where(tir, r_normal, refr_dir).normalize()
        refract_out_dir = Vec3.where(do_reflect, refl_dir, refr_dir_n)
        refract_origin = Vec3.where(do_reflect,
                                    hit_point + r_normal * SCATTER_EPS,
                                    hit_point - r_normal * SCATTER_EPS)
        refract_thr = Vec3.where(do_reflect, m.specular_color, m.color)
        refract_thr = refract_thr * torch.where(
            tir, 1.0, _branch_prob_surrogate(do_reflect, reflect_prob))
        out_dir = Vec3.where(is_refr, refract_out_dir, out_dir)
        out_origin = Vec3.where(is_refr, refract_origin, out_origin)
        throughput = Vec3.where(is_refr, refract_thr, throughput)

    return ScatterResult(out_origin, out_dir, throughput)


def shade(origin: Vec3, direction: Vec3, color: Vec3,
          remaining_bounces: torch.Tensor,
          t: torch.Tensor, normal: Vec3, mat_id: torch.Tensor,
          materials: MaterialArrays, uniforms,
          any_glossy: bool = True, any_refractive: bool = True,
          depth_quirk: bool = False, rr_depth=0, rr_start: int = 0):
    """Vectorized shadeRealMaterial (pathtrace.cu:524-571), the port of
    pathtracer_tpu/ops/bsdf.py:253.

    remaining_bounces [N] i32 (>0 live, ==0 done, <0 gathered); uniforms is a
    tuple of [N] draws (pick, u1, u2, fresnel[, rr]). With rr_start > 0, a
    path that scatters at depth rr_depth >= rr_start survives with
    probability clamp(max(throughput), 0.05, 1) and is divided by it;
    rr_depth is a host int (the whole pool at one bounce) or an [N] tensor
    of per-lane depths (the persistent engine).
    depth_quirk=False: a path whose bounce budget runs out contributes
    nothing (textbook); True replicates the reference code's raw-throughput
    gather. Returns updated (origin, direction, color, remaining_bounces);
    lanes with remaining_bounces <= 0 on entry pass through unchanged.
    """
    active = remaining_bounces > 0
    m = gather_material(materials, mat_id)
    hit = t > 0.0
    emissive = torch.logical_and(hit, m.emittance > 0.0)
    miss = torch.logical_not(hit)
    do_scatter = torch.logical_and(
        active, torch.logical_and(hit, torch.logical_not(emissive)))

    hit_point = origin + direction * t

    sc = scatter_ray(direction, hit_point, normal, m,
                     uniforms[0], uniforms[1], uniforms[2], uniforms[3],
                     any_glossy=any_glossy, any_refractive=any_refractive)

    new_origin = Vec3.where(do_scatter, sc.origin, origin)
    new_direction = Vec3.where(do_scatter, sc.direction, direction)

    new_color = Vec3.where(do_scatter, color * sc.throughput, color)
    emissive_active = torch.logical_and(active, emissive)
    new_color = Vec3.where(emissive_active,
                           color * m.color * m.emittance, new_color)
    miss_active = torch.logical_and(active, miss)
    zero = torch.zeros_like(t)
    new_color = Vec3.where(miss_active, Vec3(zero, zero, zero),
                           new_color)  # background black

    new_rb = torch.where(do_scatter, remaining_bounces - 1, remaining_bounces)
    if rr_start > 0:
        p = torch.clamp(torch.maximum(new_color.x,
                                      torch.maximum(new_color.y,
                                                    new_color.z)),
                        0.05, 1.0)
        if isinstance(rr_depth, torch.Tensor):      # per-lane depths
            rr_active = torch.logical_and(do_scatter, rr_depth >= rr_start)
        else:
            rr_active = (do_scatter if rr_depth >= rr_start
                         else torch.zeros_like(do_scatter))
        killed = torch.logical_and(rr_active, uniforms[4] >= p)
        boost = torch.where(torch.logical_and(rr_active,
                                              torch.logical_not(killed)),
                            1.0 / p, 1.0)
        new_color = new_color * boost
        new_rb = torch.where(killed, -2, new_rb)
    if not depth_quirk:
        # depth-exhausted paths die unlit (-2: dead, never gathered)
        new_rb = torch.where(torch.logical_and(do_scatter, new_rb == 0), -2,
                             new_rb)
    new_rb = torch.where(torch.logical_or(emissive_active, miss_active), 0,
                         new_rb)
    return new_origin, new_direction, new_color, new_rb


def shade_lanes(origin: Vec3, direction: Vec3, color: Vec3,
                remaining_bounces: torch.Tensor, t: torch.Tensor,
                normal: Vec3, mat_id: torch.Tensor,
                materials: MaterialArrays, irng: rng.IterationRng,
                depth: int, lane: torch.Tensor, salt=None,
                any_glossy: bool = True, any_refractive: bool = True,
                depth_quirk: bool = False, rr_start: int = 0):
    """One bounce's draws and shade for the lanes `lane` (their pixel ids
    on the fast RNG, their rows on threefry; `salt` the tiled mode's tile
    index): `shade`'s (origin, direction, color, remaining_bounces) with
    the uniforms irng.uniforms(depth, lane, 4 or 5, salt) and rr_depth =
    depth. CPU tensors: that draw and `shade`. CUDA tensors: one launch of
    csrc/shade.cu, which draws the fast hash itself from the depth's key
    (irng.depth_key) and the pixel ids (irng.pixels) or reads the threefry
    planes the engine draws, with the gradients of the same draw and
    `shade` (kernels.with_twin)."""
    m = 5 if rr_start else 4
    if origin.x.device.type != "cuda":
        u = irng.uniforms(depth, lane, m, salt=salt)
        return shade(origin, direction, color, remaining_bounces, t, normal,
                     mat_id, materials, u, any_glossy=any_glossy,
                     any_refractive=any_refractive, depth_quirk=depth_quirk,
                     rr_depth=depth, rr_start=rr_start)
    host_key = None
    if irng.fast:
        key = irng.depth_key(depth)
        if not isinstance(key, torch.Tensor):
            host_key, key = key, None
        draws = (key, irng.pixels(lane).to(torch.int64).contiguous())
    else:
        draws = tuple(p.contiguous()
                      for p in irng.uniforms(depth, lane, m, salt=salt))

    def unpack(xs):
        """The inputs below as kernels.shade's first 11 arguments."""
        mats = dataclasses.replace(
            materials, **dict(zip(kernels.SHADE_TABLES, xs[15:21])))
        lanes = (Vec3(*xs[0:3]), Vec3(*xs[3:6]), Vec3(*xs[6:9]), xs[9],
                 xs[10], Vec3(*xs[11:14]), xs[14], mats)
        if irng.fast:
            return (*lanes, host_key if xs[21] is None else xs[21], xs[22],
                    None)
        return (*lanes, None, None, xs[21:])

    def kernel(*xs):
        return kernels.shade(*unpack(xs), any_glossy=any_glossy,
                             any_refractive=any_refractive, rr=rr_start > 0,
                             rr_on=0 < rr_start <= depth,
                             depth_quirk=depth_quirk)

    def plain(*xs):
        *lanes, key, pixel, u = unpack(xs)
        if u is None:
            u = rng.fast_uniforms_perlane(rng._pixel_mix(key, pixel), m)
        o, d, c, rb = shade(*lanes, u, any_glossy=any_glossy,
                            any_refractive=any_refractive,
                            depth_quirk=depth_quirk, rr_depth=depth,
                            rr_start=rr_start)
        return (*o, *d, *c, rb)

    out = kernels.with_twin(
        kernel, plain,
        *(x.contiguous() for x in (*origin, *direction, *color)),
        remaining_bounces.contiguous(), t.contiguous(),
        *(x.contiguous() for x in normal), mat_id.to(torch.int32).contiguous(),
        *(getattr(materials, f) for f in kernels.SHADE_TABLES), *draws)
    return Vec3(*out[0:3]), Vec3(*out[3:6]), Vec3(*out[6:9]), out[9]
