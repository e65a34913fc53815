"""PyTorch port, raygen: csrc/raygen.cu (one launch an iteration: the
camera's draws, the AA jitter, the thin lens and the fresh path state) and
its plain twin, ops/camera.py raygen_plain. Imports no JAX, so it also runs
on a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_raygen.py -m cuda

On the CPU: generate_paths (the twin on CPU tensors) against the expression
generate_paths inlined before the kernel, bit for bit, over the pixel maps,
threefry, the settings that switch parts off and both kinds of iteration;
the kernel's pixel map written out in C integer arithmetic against
RenderSettings.pixel_map; the kernel's name in the profiler and the
benchmark. The tests marked `cuda` build the library and hold the kernel
to the twin bit for bit on every output and lane at 800x800, the compiled
frame to the twin's rays for a camera written in place between replays,
the launch count and the gradients; they skip without a CUDA device.
"""
import dataclasses
import math
from unittest import mock

import numpy as np
import pytest
import torch

from benchmark.trace import RANGES, is_mesh_kernel, is_own_kernel
from pathtracer_tpu_torch import load_scene
from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.engine.wavefront import PathState
from pathtracer_tpu_torch.ops import camera, kernels, rng
from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.scene.types import PixelMap
from pathtracer_tpu_torch.utils import profiling, spans
from pathtracer_tpu_torch.utils.vec import Vec3

torch.set_num_threads(2)

# the kernel's name as torch.profiler shows it (one of its instances)
DEVICE_NAME = ("void (anonymous namespace)::pt_camera_paths<true, true, "
               "true, false, false>((anonymous namespace)::CameraArgs)")
SEED = 3000000019


def inline_generate_paths(scene, settings, irng, n=None, pixel_offset=0):
    """engine/wavefront.py generate_paths as it was before the kernel: the
    draws from irng, the pixel map, generate_camera_rays and the fills."""
    if n is None:
        n = settings.pixel_count
    dev = scene.device
    lanes = torch.arange(n, dtype=torch.int64, device=dev)
    jitter = irng.normals(-1, lanes, 2) if settings.jitter else None
    dof_u = irng.uniforms(-2, lanes, 2) if settings.dof else None
    pixel_ids = settings.pixel_map()(lanes + pixel_offset if pixel_offset
                                     else lanes)
    origin, direction = camera.generate_camera_rays(
        scene.camera, settings.width, settings.height, jitter, dof_u,
        pixel_idx=pixel_ids)
    one = torch.ones(n, device=dev)
    return PathState(
        origin=origin, direction=direction, color=Vec3(one, one, one),
        remaining_bounces=torch.full((n,), settings.trace_depth,
                                     dtype=torch.int32, device=dev),
        pixel=lanes)


def flat(state):
    return (*state.origin, *state.direction, *state.color,
            state.remaining_bounces, state.pixel)


def same_bits(got, ref, label=""):
    """Every output equal, float32 outputs by their bits (torch.equal takes
    -0 == +0), and of the same dtype and shape."""
    def bits(t):
        t = t.contiguous()
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    for k, (a, b) in enumerate(zip(got, ref, strict=True)):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{label} {k}"
        assert torch.equal(bits(a), bits(b)), (
            f"{label} output {k} differs on "
            f"{int((bits(a) != bits(b)).sum())} lanes")


def setup(name, device, res, depth=None, *, interleave=None, shard=0,
          fast_rng=True, jitter=True, dof=True, lens_zero=False,
          iteration="int"):
    """(scene, settings, irng, n, pixel_offset) of one iteration's raygen:
    the whole image, or with `interleave` S shard `shard`'s block of
    pixel_count / S lanes."""
    overrides = {"RES": [res, res]}
    if depth is not None:
        overrides["DEPTH"] = depth
    scene, settings = load_scene(scene_path(name), device,
                                 overrides=overrides)
    settings = dataclasses.replace(settings, shard_interleave=interleave,
                                   fast_rng=fast_rng, jitter=jitter, dof=dof)
    if lens_zero:
        scene = dataclasses.replace(scene, camera=dataclasses.replace(
            scene.camera,
            lens_radius=torch.zeros_like(scene.camera.lens_radius)))
    n = settings.pixel_count // (interleave or 1)
    offset = shard * n
    it = 5
    if iteration == "tensor":
        it = torch.tensor(it, dtype=torch.int64, device=device)
    irng = rng.IterationRng(SEED, it, pixel_map=settings.pixel_map(),
                            pixel_offset=offset, fast=fast_rng,
                            key_salt=shard if interleave else None)
    return scene, settings, irng, n, offset


# (name, res, setup keywords): the pixel maps, threefry, each part off
CASES = [
    ("cornell", {}),
    ("cornell", {"iteration": "tensor"}),
    ("animal", {}),
    ("animal", {"iteration": "tensor"}),
    ("cornell", {"interleave": 4, "shard": 3}),
    ("animal", {"interleave": 8, "shard": 5, "iteration": "tensor"}),
    ("cornell", {"fast_rng": False}),
    ("animal", {"fast_rng": False, "interleave": 4, "shard": 1}),
    ("cornell", {"jitter": False}),
    ("cornell", {"dof": False}),
    ("cornell", {"jitter": False, "dof": False}),
    ("cornell", {"lens_zero": True}),
]


def _id(case):
    name, kw = case
    return "-".join([name] + [f"{k}={v}" for k, v in kw.items()])


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# -- CPU ---------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_id)
def test_the_twin_is_the_inline_expression(case):
    """On CPU tensors generate_paths runs the twin: bit for bit the
    expression it inlined before the kernel, with the animal's tile map,
    the shard interleave with a pixel offset, threefry, jitter or DoF off,
    a zero lens radius and an int or a 0-d tensor iteration; nothing
    launches."""
    name, kw = case
    scene, settings, irng, n, offset = setup(name, "cpu", 64, **kw)
    assert (settings.tile is not None) == (name == "animal")
    before = dict(kernels.LAUNCHES)
    got = wavefront.generate_paths(scene, settings, irng, n=n,
                                   pixel_offset=offset)
    ref = inline_generate_paths(scene, settings, irng, n, offset)
    assert kernels.LAUNCHES == before
    same_bits(flat(got), flat(ref))
    assert got.color.x is got.color.y is got.color.z
    moved = got.origin.x != got.origin.x[0]
    assert bool(moved.any()) == (settings.dof and
                                 float(scene.camera.lens_radius) > 0)


def test_generate_paths_refuses_an_irng_of_another_offset():
    scene, settings = load_scene(scene_path("cornell"), "cpu",
                                 overrides={"RES": [16, 16]})
    irng = rng.IterationRng(0, 1, pixel_map=settings.pixel_map(),
                            pixel_offset=64)
    with pytest.raises(ValueError, match="offset"):
        wavefront.generate_paths(scene, settings, irng, n=64)


@pytest.mark.parametrize("irng_map", ["identity", "interleave", "lambda"])
def test_generate_paths_refuses_an_irng_of_another_pixel_map(irng_map):
    """On the fast RNG the draws must be keyed on the settings' pixel map
    (the alien's tile map here), which the kernel computes for both the
    draws and the rays; a map of another form, or one that is no PixelMap,
    is refused. Threefry draws by lane row and takes any map."""
    scene, settings = load_scene(scene_path("animal"), "cpu",
                                 overrides={"RES": [64, 64]})
    assert settings.pixel_map() == camera.tile_pixel_map(64, 64, 32, 32)
    other = {"identity": None,
             "interleave": dataclasses.replace(
                 settings, shard_interleave=4).pixel_map(),
             "lambda": settings.pixel_map().__call__}[irng_map]
    with pytest.raises(ValueError, match="pixel map"):
        wavefront.generate_paths(scene, settings, rng.IterationRng(
            0, 1, pixel_map=other))
    state = wavefront.generate_paths(scene, settings, rng.IterationRng(
        0, 1, pixel_map=other, fast=False))
    assert state.pixel.shape == (settings.pixel_count,)


def kernel_pixels(lanes, width, offset, tile, interleave):
    """csrc/raygen.cu pixel_of on int64 lanes, in C's truncating integer
    division (numpy's on these non-negative values)."""
    lane = lanes.astype(np.int64) + offset
    if interleave is not None:
        shards, n_local, granule = interleave
        loc, s = lane % n_local, lane // n_local
        lane = ((loc // granule) * shards + s) * granule + loc % granule
    if tile is None:
        return lane
    th, tw = tile
    t, r = lane // (th * tw), lane % (th * tw)
    tiles_x = width // tw
    return ((t // tiles_x) * th + r // tw) * width + (t % tiles_x) * tw + (
        r % tw)


@pytest.mark.parametrize("res,tile,shards", [
    (800, None, None), (800, (32, 32), None), (800, None, 8),
    (800, (32, 32), 8), (1200, (16, 16), 4), (96, (32, 32), 3)])
def test_the_kernels_pixel_map_is_the_settings(res, tile, shards):
    """The kernel's pixel map from the PixelMap's interleave and tile
    equals RenderSettings.pixel_map on every lane of every shard, and is a
    permutation of the image."""
    _, settings = load_scene(scene_path("cornell"), "cpu",
                             overrides={"RES": [res, res]})
    settings = dataclasses.replace(settings, tile=tile,
                                   shard_interleave=shards)
    pmap = settings.pixel_map()
    inter = pmap.interleave
    assert (inter is None) == (shards is None)
    assert pmap.tile == (None if tile is None else (res, *tile))
    n = settings.pixel_count // (shards or 1)
    lanes = np.arange(n, dtype=np.int64)
    seen = []
    for s in range(shards or 1):
        got = kernel_pixels(lanes, settings.width, s * n, tile, inter)
        want = pmap(torch.from_numpy(lanes) + s * n).numpy()
        assert np.array_equal(got, want)
        seen.append(got)
    assert np.array_equal(np.sort(np.concatenate(seen)),
                          np.arange(settings.pixel_count))


def test_the_kernel_is_no_range_mesh_or_own_kernel_of_the_benchmark():
    """The profiler's name of the kernel has its kind; benchmark/trace.py
    counts it in torch_ops_ms, not as a mesh kernel, and no range or stage
    name reads it; the stage timer wraps generate_paths."""
    assert profiling.kernel_kind(DEVICE_NAME) == "raygen kernel"
    for name in (DEVICE_NAME, "pt_camera_paths"):
        assert not is_mesh_kernel(name)
        assert not is_own_kernel(name)
        assert name not in RANGES and name not in spans.STAGES
        assert "pt_raygen" not in name
    assert (profiling.wavefront, "generate_paths", "raygen") in (
        profiling.STAGES)


def test_the_wrapper_refuses_cpu_tensors():
    scene, settings = load_scene(scene_path("cornell"), "cpu")
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.camera(scene.camera, settings.width, settings.height, 8, 16,
                       keys=(1, 2))
    assert kernels.LAUNCHES == before


# -- CUDA --------------------------------------------------------------------

def _draws(settings, irng, n):
    """camera_paths's draws: the keyword (keys or planes) of kernels.camera
    and its (AA, lens) pair."""
    if irng.fast:
        return {"keys": (irng.depth_key(-1) if settings.jitter else None,
                         irng.depth_key(-2) if settings.dof else None)}
    lanes = torch.arange(n, dtype=torch.int64, device="cuda")
    return {"planes": (
        tuple(p.contiguous() for p in irng.normals(-1, lanes, 2))
        if settings.jitter else None,
        tuple(p.contiguous() for p in irng.uniforms(-2, lanes, 2))
        if settings.dof else None)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ("cornell", 8, {}), ("cornell", 8, {"iteration": "tensor"}),
    ("animal", 4, {}), ("animal", 4, {"iteration": "tensor"}),
    ("cornell", 8, {"fast_rng": False}),
    ("animal", 4, {"fast_rng": False, "interleave": 4, "shard": 2}),
    ("cornell", 8, {"interleave": 4, "shard": 3}),
    ("animal", 4, {"interleave": 8, "shard": 7, "iteration": "tensor"}),
    ("cornell", 8, {"jitter": False}), ("cornell", 8, {"dof": False}),
    ("cornell", 8, {"lens_zero": True})],
    ids=lambda c: _id((f"{c[0]}_d{c[1]}", c[2])))
def test_kernel_is_the_twin_bit_for_bit(case):
    """At 800x800 the kernel's nine outputs equal the twin's on the card
    bit for bit on every lane (and generate_paths's, through the kernel,
    the expression it inlined before), one launch a call."""
    _need_cuda()
    name, depth, kw = case
    scene, settings, irng, n, offset = setup(name, "cuda", 800, depth, **kw)
    with torch.inference_mode():
        kernels.reset_counts()
        got = kernels.camera(scene.camera, settings.width, settings.height,
                             settings.trace_depth, n, offset=offset,
                             pixel_map=settings.pixel_map(),
                             **_draws(settings, irng, n))
        assert kernels.LAUNCHES["camera"] == 1
        ref = camera.raygen_plain(scene.camera, settings, n, offset, irng)
        same_bits(got, ref, "kernel vs twin")
        state = wavefront.generate_paths(scene, settings, irng, n=n,
                                         pixel_offset=offset)
        assert kernels.LAUNCHES["camera"] == 2
        same_bits(flat(state), flat(inline_generate_paths(
            scene, settings, irng, n, offset)), "generate_paths vs inline")
    kernels.reset_counts()


def _orbit(cam, angle):
    """The camera turned by `angle` about the y axis through its look-at
    point at focal_distance, written into its tensors in place."""
    c, s = math.cos(angle), math.sin(angle)
    rot = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                       device=cam.position.device)
    look = cam.position + cam.view * cam.focal_distance
    for name in ("view", "right", "up"):
        v = getattr(cam, name)
        v.copy_(rot @ v)
    cam.position.copy_(look - cam.view * cam.focal_distance)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "animal"])
def test_the_compiled_frame_reads_the_camera_written_in_place(name):
    """A camera turned in place between two calls of the compiled frame:
    the second call replays the one captured graph, which draws the new
    camera's rays, its image bit for bit the eager loop's through the twin
    with that camera (and not the old camera's image); one counted launch
    an iteration."""
    _need_cuda()
    scene, settings = load_scene(scene_path(name), "cuda",
                                 overrides={"RES": [64, 64]})
    seed, iters = 11, 2

    def twin_image(it):
        with mock.patch.object(wavefront, "camera_paths",
                               camera.raygen_plain):
            return wavefront.render_chunk_eager(
                scene, settings, wavefront.zero_accum(settings, "cuda"), it,
                iters, seed, False)

    wavefront.clear_frames()
    spans.reset()
    with torch.inference_mode():
        assert wavefront.eager_reason(settings, "cuda") is None
        wavefront.render_chunk(scene, settings,
                               wavefront.zero_accum(settings, "cuda"), 1,
                               iters, seed)
        old = twin_image(3)
        _orbit(scene.camera, 0.2)
        kernels.reset_counts()
        got = wavefront.render_chunk(scene, settings,
                                     wavefront.zero_accum(settings, "cuda"),
                                     3, iters, seed)
        assert kernels.LAUNCHES["camera"] == iters
        kernels.reset_counts()
        ref = twin_image(3)
        assert kernels.LAUNCHES["camera"] == 0
        torch.cuda.synchronize()
    assert spans.snapshot()["counters"]["captures"] == 1
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not all(torch.equal(a, b) for a, b in zip(got, old))
    wavefront.clear_frames()
    kernels.reset_counts()


@pytest.mark.cuda
def test_one_launch_an_iteration_on_replay():
    """The captured iteration holds one raygen launch, and LAUNCHES gains
    one a replayed iteration."""
    _need_cuda()
    scene, settings = load_scene(scene_path("cornell"), "cuda",
                                 overrides={"RES": [64, 64]})
    wavefront.clear_frames()
    with torch.inference_mode():
        frame = wavefront.capture_frame(scene, settings,
                                        settings.pixel_count, 0, 0, None,
                                        scene.device)
        assert frame.launches["camera"] == 1
        kernels.reset_counts()
        wavefront.render_chunk(scene, settings,
                               wavefront.zero_accum(settings, "cuda"), 1, 5,
                               0)
        torch.cuda.synchronize()
    assert kernels.LAUNCHES["camera"] == 5
    wavefront.clear_frames()
    kernels.reset_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["position", "view", "pixel_length",
                                   "lens_radius", "focal_distance"])
def test_gradients_through_the_kernel_are_the_twins(field):
    """Under autograd camera_paths launches the kernel, gives its
    inference bits, and the gradient of a weighted sum of the rays in a
    camera tensor equals the twin's bit for bit."""
    _need_cuda()
    scene, settings, irng, n, offset = setup("cornell", "cuda", 64)
    w = torch.rand(6, n, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(2))

    def run(route):
        p = getattr(scene.camera, field).detach().clone().requires_grad_()
        cam = dataclasses.replace(scene.camera, **{field: p})
        out = route(cam, settings, n, offset, irng)
        loss = (torch.stack(out[:6]) * w).sum()
        (g,) = torch.autograd.grad(loss, p)
        return out, g

    kernels.reset_counts()
    out, g = run(camera.camera_paths)
    assert kernels.LAUNCHES["camera"] == 1
    out_p, g_p = run(camera.raygen_plain)
    same_bits([o.detach() for o in out], [o.detach() for o in out_p])
    assert float(g_p.abs().sum()) > 0
    assert torch.equal(g, g_p)
    kernels.reset_counts()


@pytest.mark.cuda
def test_the_wrapper_rejects_bad_inputs():
    _need_cuda()
    scene, settings, irng, n, _ = setup("cornell", "cuda", 32,
                                        iteration="tensor")
    cam = scene.camera
    key = irng.depth_key(-1)
    args = (settings.width, settings.height, 8, n)
    plane = torch.zeros(n, device="cuda")
    bad = {"position": cam.position.double(),
           "view": cam.view[:2].contiguous(),
           "up": torch.zeros(3, 2, device="cuda")[:, 0],
           "pixel_length": cam.pixel_length.cpu()}
    for k, v in bad.items():
        with pytest.raises(ValueError, match=k):
            kernels.camera(dataclasses.replace(cam, **{k: v}), *args,
                           keys=(key, None))
    for draws in ({}, {"keys": (key, None), "planes": (None, None)}):
        with pytest.raises(ValueError, match="keys or"):
            kernels.camera(cam, *args, **draws)
    with pytest.raises(ValueError, match="0-d"):
        kernels.camera(cam, *args, keys=(key.view(1), None))
    with pytest.raises(TypeError):
        kernels.camera(cam, *args, planes=((plane, plane.int()), None))
    with pytest.raises(ValueError):
        kernels.camera(cam, *args, planes=((plane, plane[:-1]), None))
    with pytest.raises(ValueError, match="tile"):
        kernels.camera(cam, *args, keys=(key, None),
                       pixel_map=PixelMap((32, 7, 7)))
    kernels.reset_counts()
