"""Camera ray generation: stochastic AA jitter + thin-lens depth of field.

The port of pathtracer_tpu/ops/camera.py (reference pathtrace.cu:235-322),
over the whole pixel pool in the Vec3 SoA layout. `camera_paths` is the
engine's raygen: on CUDA tensors one launch of csrc/raygen.cu, bit for bit
its plain twin `raygen_plain`, which CPU tensors run.
"""
from __future__ import annotations

import dataclasses

import torch

from ..scene.types import CameraArrays, PixelMap, RenderSettings
from ..utils.math import PI
from ..utils.vec import Vec3
from . import kernels


def pick_tile(width: int, height: int):
    """Largest square tile (<= 32x32) dividing the image, or None."""
    for t in (32, 16, 8):
        if width % t == 0 and height % t == 0:
            return (t, t)
    return None


def tile_pixel_map(width: int, height: int, tile_h: int, tile_w: int):
    """lane (tile-major) -> pixel index (row-major). Pure index math on
    ints, numpy arrays or tensors of non-negative lanes."""
    return PixelMap((width, tile_h, tile_w))


def concentric_sample_disk(u1: torch.Tensor, u2: torch.Tensor):
    """Concentric disk warp (pathtrace.cu:235-250). Returns (dx, dy)."""
    sx = 2.0 * u1 - 1.0
    sy = 2.0 * u2 - 1.0
    use_x = torch.abs(sx) > torch.abs(sy)
    r = torch.where(use_x, sx, sy)
    safe_sx = torch.where(sx == 0.0, 1.0, sx)
    safe_sy = torch.where(sy == 0.0, 1.0, sy)
    theta = torch.where(
        use_x,
        (PI / 4.0) * (sy / safe_sx),
        (PI / 2.0) - (PI / 4.0) * (sx / safe_sy),
    )
    both_zero = torch.logical_and(sx == 0.0, sy == 0.0)
    r = torch.where(both_zero, 0.0, r)
    return r * torch.cos(theta), r * torch.sin(theta)


def generate_camera_rays(cam: CameraArrays, width: int, height: int,
                         jitter_normals, dof_uniforms,
                         pixel_idx: torch.Tensor):
    """One primary ray per lane, for the global pixel ids `pixel_idx` [n]
    (index = x + y*width, pathtrace.cu:266).

    jitter_normals: pair of [n] standard normals for AA (sigma 0.005, clamp
      +-0.5), or None; dof_uniforms: pair of [n] uniforms for the lens sample,
      or None. The thin lens is active iff lens_radius > 0.
    Returns (origin Vec3, direction Vec3) of [n].
    """
    n = pixel_idx.shape[0]
    x = (pixel_idx % width).to(torch.float32)
    y = (pixel_idx // width).to(torch.float32)

    if jitter_normals is not None:
        px = x + torch.clamp(jitter_normals[0] * 0.005, -0.5, 0.5)
        py = y + torch.clamp(jitter_normals[1] * 0.005, -0.5, 0.5)
    else:
        px, py = x, y

    view = Vec3(cam.view[0], cam.view[1], cam.view[2])
    right = Vec3(cam.right[0], cam.right[1], cam.right[2])
    up = Vec3(cam.up[0], cam.up[1], cam.up[2])
    pos = Vec3(cam.position[0], cam.position[1], cam.position[2])

    # dir = normalize(view - right*plx*(px - w/2) - up*ply*(py - h/2))
    sx = cam.pixel_length[0] * (px - 0.5 * width)
    sy = cam.pixel_length[1] * (py - 0.5 * height)
    d = (view - right * sx - up * sy).normalize()

    origin = Vec3(pos.x.expand(n), pos.y.expand(n), pos.z.expand(n))

    if dof_uniforms is not None:
        # thin lens: focal point along the pinhole ray, lens-disk origin
        # offset (pathtrace.cu:294-315), selected where lens_radius > 0
        denom = d.dot(view)
        denom = torch.where(torch.abs(denom) < 1e-6,
                            torch.where(denom >= 0.0, 1e-6, -1e-6), denom)
        t_focus = cam.focal_distance / denom
        p_focus = origin + d * t_focus
        lx, ly = concentric_sample_disk(dof_uniforms[0], dof_uniforms[1])
        lx = lx * cam.lens_radius
        ly = ly * cam.lens_radius
        o_dof = origin + right * lx + up * ly
        d_dof = (p_focus - o_dof).normalize()
        enabled = cam.lens_radius > 0.0
        origin = Vec3.where(enabled, o_dof, origin)
        d = Vec3.where(enabled, d_dof, d)

    return origin, d


def raygen_plain(cam: CameraArrays, settings: RenderSettings, n: int,
                 pixel_offset: int, irng) -> tuple:
    """The fresh path pool of `n` lanes from global lane `pixel_offset` on,
    in plain PyTorch: the AA normals (depth -1) and lens uniforms (depth -2)
    of `irng` (ops/rng.py IterationRng) where settings.jitter / dof, the
    camera rays (generate_camera_rays) of pixel ids
    settings.pixel_map()(lane + pixel_offset), throughput one,
    settings.trace_depth bounces left. Returns (ox, oy, oz, dx, dy, dz, one,
    remaining_bounces int32, lane int64)."""
    dev = cam.position.device
    lanes = torch.arange(n, dtype=torch.int64, device=dev)
    jitter = irng.normals(-1, lanes, 2) if settings.jitter else None
    dof_u = irng.uniforms(-2, lanes, 2) if settings.dof else None
    pixel_ids = settings.pixel_map()(lanes + pixel_offset if pixel_offset
                                     else lanes)
    origin, direction = generate_camera_rays(
        cam, settings.width, settings.height, jitter, dof_u,
        pixel_idx=pixel_ids)
    one = torch.ones(n, device=dev)
    rb = torch.full((n,), settings.trace_depth, dtype=torch.int32,
                    device=dev)
    return (*origin, *direction, one, rb, lanes)


def camera_paths(cam: CameraArrays, settings: RenderSettings, n: int,
                 pixel_offset: int, irng) -> tuple:
    """The engine's raygen: `raygen_plain`'s arguments and outputs. On the
    fast RNG `irng` must carry the pool's pixel offset and the settings'
    pixel map (the kernel keys the draws on the pixel ids of the rays).
    CPU tensors: raygen_plain. CUDA tensors: one launch of csrc/raygen.cu
    (kernels.camera), which reads the camera and any key tensor on the
    device, with the gradients of raygen_plain (kernels.with_twin)."""
    pmap = settings.pixel_map()
    if irng.fast and (irng.offset != pixel_offset or irng.pixel_map != pmap):
        raise ValueError(f"irng draws at pixel offset {irng.offset} with "
                         f"pixel map {irng.pixel_map}, the pool is at "
                         f"{pixel_offset} with the settings' {pmap}")
    if cam.position.device.type != "cuda":
        return raygen_plain(cam, settings, n, pixel_offset, irng)
    if irng.fast:
        draws = {"keys": (irng.depth_key(-1) if settings.jitter else None,
                          irng.depth_key(-2) if settings.dof else None)}
    else:
        lanes = torch.arange(n, dtype=torch.int64, device=cam.position.device)

        def pair(draw, depth):
            return tuple(p.contiguous() for p in draw(depth, lanes, 2))

        draws = {"planes": (
            pair(irng.normals, -1) if settings.jitter else None,
            pair(irng.uniforms, -2) if settings.dof else None)}
    return kernels.with_twin(
        lambda *c: kernels.camera(
            CameraArrays(*c), settings.width, settings.height,
            settings.trace_depth, n, offset=pixel_offset, pixel_map=pmap,
            **draws),
        lambda *c: raygen_plain(CameraArrays(*c), settings, n, pixel_offset,
                                irng),
        *(getattr(cam, f.name) for f in dataclasses.fields(cam)))
