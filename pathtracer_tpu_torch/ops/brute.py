"""Brute-force mesh intersection: the port of pathtracer_tpu/ops/bvh_pallas.py
(`_brute_kernel`, :427, and `mesh_intersect_brute`, :540), the reference's
no-BVH ablation (bvh_impl="brute").

Every ray is tested against every triangle of every mesh. Moller-Trumbore
is evaluated as four linear forms of the ray's features F = [d, o, o x d, 1]
(scene/types.py pack_tris_mxu): a, u*a, v*a and t*a, each a 16-term dot
product with the triangle's coefficient row. A hit is valid by the
sign-free tests of bvh_pallas.py:483-487 (a^2 > eps^2, u*a >= 0, v*a >= 0,
(u + v)*a <= a^2, t*a >= eps*a^2), t = tn * (1/a), and each ray keeps the
FIRST triangle of smallest t in table order (the TPU kernel's smallest row
index within a tile and strict improvement across tiles). The epilogue
interpolates the winner's corner normals, normalizes and faces them toward
the ray; t = -1, mat = -1 on a miss. Like the JAX function it ignores
`active` and `t_bound`: intersect_scene's merge drops hits beyond the bound.

`brute` launches csrc/brute.cu for CUDA tensors, `brute_plain` (the same
function by the dense 16-term sums, chunked over rays) runs for CPU tensors.
The kernel reads the compact table of pack_tris_brute (the 19 coefficients
a triangle that are not structurally zero) and sums only those terms; its
results equal the plain version's bit for bit (csrc/brute.cu says why). The
TPU kernel's dot products ran on the matrix unit; here they are summed term
by term in FP32, so against the JAX package t agrees within rounding
(rtol 1e-4, atol 1e-5, as tests/test_intersect.py:374 holds brute to the
packet walk), with equal hit sets and material ids.
"""
from __future__ import annotations

import torch

from ..scene.types import BRUTE_ROW, MXU_NFEAT, MXU_TRI_TILE
from ..utils.vec import Vec3
from . import kernels

FLT_MAX = 3.402823466e38
EPS = 1e-6
BRUTE_CHUNK = 1 << 23   # (ray, triangle) pairs per block of plain work


def features(ox, oy, oz, dx, dy, dz):
    """The 16 per-ray features [d, o, o x d, 1, 0 x 6] (bvh_pallas.py:464-471)
    as a list of [N] tensors."""
    cx = oy * dz - oz * dy
    cy = oz * dx - ox * dz
    cz = ox * dy - oy * dx
    one = torch.ones_like(dx)
    zero = torch.zeros_like(dx)
    return [dx, dy, dz, ox, oy, oz, cx, cy, cz, one] + [zero] * (
        MXU_NFEAT - 10)


def brute_plain(coeffs, attrs, ox, oy, oz, dx, dy, dz, chunk=BRUTE_CHUNK):
    """Plain PyTorch version of csrc/brute.cu: (t, nx, ny, nz, mat) per
    ray, over blocks of rays with at most `chunk` (ray, triangle) pairs."""
    n_tris = attrs.shape[0]
    # [4, T, 16]: the a, un, vn, tn coefficient rows of every triangle
    c = coeffs.reshape(-1, 4, MXU_TRI_TILE, MXU_NFEAT).transpose(0, 1)
    c = c.reshape(4, n_tris, MXU_NFEAT)
    feats = features(ox, oy, oz, dx, dy, dz)
    n = ox.shape[0]
    dev = ox.device
    t_best = torch.full((n,), FLT_MAX, device=dev)
    u_best = torch.zeros(n, device=dev)
    v_best = torch.zeros(n, device=dev)
    k_best = torch.zeros(n, dtype=torch.int64, device=dev)
    step = max(1, chunk // max(n_tris, 1))
    for r0 in range(0, n if n_tris else 0, step):
        sl = slice(r0, r0 + step)
        f = [x[sl, None] for x in feats]

        def form(q):
            # the 16-term dot product, term by term in feature order
            acc = c[q, None, :, 0] * f[0]
            for j in range(1, MXU_NFEAT):
                acc = acc + c[q, None, :, j] * f[j]
            return acc

        a, un, vn, tn = (form(q) for q in range(4))
        a2 = a * a
        ua = un * a
        va = vn * a
        valid = ((a2 > EPS * EPS) & (ua >= 0.0) & (va >= 0.0)
                 & (ua + va <= a2) & (tn * a >= EPS * a2))
        inv_a = 1.0 / torch.where(valid, a, 1.0)
        t = torch.where(valid, tn * inv_a, FLT_MAX)
        k = torch.argmin(t, dim=1, keepdim=True)       # first of the smallest
        pick = lambda x: torch.gather(x, 1, k)[:, 0]
        t_best[sl] = pick(t)
        inv_w = pick(inv_a)
        u_best[sl] = pick(un) * inv_w
        v_best[sl] = pick(vn) * inv_w
        k_best[sl] = k[:, 0]
    hit = t_best < FLT_MAX
    at = torch.where(hit[:, None], attrs[k_best], 0.0) if n_tris else \
        torch.zeros((n, MXU_NFEAT), device=dev)
    u = torch.where(hit, u_best, 0.0)
    v = torch.where(hit, v_best, 0.0)
    w = 1.0 - u - v
    nn = [w * at[:, c] + u * at[:, 3 + c] + v * at[:, 6 + c]
          for c in range(3)]
    inv_len = 1.0 / torch.sqrt(torch.clamp(
        nn[0] * nn[0] + nn[1] * nn[1] + nn[2] * nn[2], min=1e-30))
    fl = torch.where(dx * nn[0] + dy * nn[1] + dz * nn[2] > 0.0, -inv_len,
                     inv_len)
    return (torch.where(hit, t_best, -1.0), nn[0] * fl, nn[1] * fl,
            nn[2] * fl, torch.where(hit, at[:, 9].to(torch.int32), -1))


def brute(coeffs, attrs, table, n_tris, ox, oy, oz, dx, dy, dz):
    """(t, nx, ny, nz, mat) per ray: csrc/brute.cu over `table`, the compact
    coefficients of its first `n_tris` triangles, on CUDA tensors; the plain
    version over `coeffs` on CPU tensors. `table` and `n_tris` must be
    pack_tris_brute(coeffs), as the scene builds them at load
    (SceneArrays.tris_brute, .brute_tris): on either device the three tables
    are checked to describe the same padded triangle count."""
    t_pad = attrs.shape[0]
    if (t_pad % MXU_TRI_TILE or tuple(coeffs.shape) != (4 * t_pad, MXU_NFEAT)
            or tuple(table.shape) != (t_pad, BRUTE_ROW)
            or not 0 <= n_tris <= t_pad):
        raise ValueError(f"brute: coeffs {tuple(coeffs.shape)}, attrs "
                         f"{tuple(attrs.shape)}, table {tuple(table.shape)} "
                         f"and n_tris {n_tris} must describe the same whole "
                         f"{MXU_TRI_TILE}-triangle tiles")
    if ox.device.type == "cpu":
        return brute_plain(coeffs, attrs, ox, oy, oz, dx, dy, dz)
    n = ox.shape[0]
    dev = kernels.check("brute", n, cols=MXU_NFEAT, attrs_f32=attrs,
                        ray_ox_f32=ox, ray_oy_f32=oy, ray_oz_f32=oz,
                        ray_dx_f32=dx, ray_dy_f32=dy, ray_dz_f32=dz)
    if kernels.check("brute", n, cols=BRUTE_ROW, table_f32=table) != dev:
        raise ValueError("brute: table and rays on different devices")
    if table.data_ptr() % 16:
        raise ValueError("brute: table must be 16-byte aligned (the kernel "
                         "reads it as float4)")
    t, nx, ny, nz, mat = kernels.hit_outputs(n, ox.device)
    if n:
        p = kernels.ptr
        kernels.launch("brute", dev, p(table), p(attrs), n_tris, p(ox),
                       p(oy), p(oz), p(dx), p(dy), p(dz), p(t), p(nx), p(ny),
                       p(nz), p(mat), n)
    return t, nx, ny, nz, mat


def mesh_intersect_brute(scene, origin: Vec3, direction: Vec3):
    """Every triangle of every mesh against every ray (bvh_pallas.py:540):
    (t [N], normal Vec3, mat [N]), t = -1 on a miss. Needs the scene's
    brute tables (load_scene(brute_tables=True))."""
    if scene.tris_mxu_n.shape[0] == 0:
        # placeholder tables have zero rows: reject a scene loaded without
        # them rather than intersect nothing
        raise ValueError(
            "bvh_impl='brute' needs load_scene(brute_tables=True)")
    o = [c.contiguous() for c in origin]
    d = [c.contiguous() for c in direction]
    t, nx, ny, nz, mat = brute(scene.tris_mxu_c, scene.tris_mxu_n,
                               scene.tris_brute, scene.brute_tris, *o, *d)
    return t, Vec3(nx, ny, nz), mat
