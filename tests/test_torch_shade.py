"""PyTorch port, shade: csrc/shade.cu (one launch a bounce: the draws, the
material fetch and the scatter) and its plain twin, ops/bsdf.py shade with
the draws of ops/rng.py. Imports no JAX, so it also runs on a machine with a
GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_shade.py -m cuda

On the CPU: the route shade_lanes takes (the plain draw and shade, bit for
bit), the kernel's hash written out in uint32 arithmetic against
IterationRng.uniforms, and the kernel's name in the profiler and the
benchmark. The tests marked `cuda` build the library and hold the kernel to
the plain twin bit for bit on every output and lane (every bounce pool of a
Cornell 800x800 d8 and an alien 800x800 d4 iteration, and crafted lanes),
the engine modes' and the compiled frame's images to the plain path's, the
launch count and the gradients; they skip without a CUDA device.
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from benchmark.trace import is_mesh_kernel, is_own_kernel
from pathtracer_tpu_torch import load_scene
from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.ops import bsdf, kernels, rng
from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.scene.types import MaterialArrays
from pathtracer_tpu_torch.utils import profiling
from pathtracer_tpu_torch.utils.vec import Vec3

torch.set_num_threads(2)

# the kernel's name as torch.profiler shows it (one of its instances)
DEVICE_NAME = ("void (anonymous namespace)::pt_shade_lanes<true, false, "
               "false, false, false>((anonymous namespace)::ShadeArgs)")
M32 = 0xFFFFFFFF


def plain_shade_lanes(origin, direction, color, remaining_bounces, t,
                      normal, mat_id, materials, irng, depth, lane,
                      salt=None, any_glossy=True, any_refractive=True,
                      depth_quirk=False, rr_start=0):
    """The bounce's draws and shade as the engine issued them before the
    kernel: irng.uniforms, then bsdf.shade (the plain path on any
    device)."""
    u = irng.uniforms(depth, lane, 5 if rr_start else 4, salt=salt)
    return bsdf.shade(origin, direction, color, remaining_bounces, t, normal,
                      mat_id, materials, u, any_glossy=any_glossy,
                      any_refractive=any_refractive, depth_quirk=depth_quirk,
                      rr_depth=depth, rr_start=rr_start)


def flat(out):
    """The 10 outputs of a shade: 9 float planes and remaining_bounces."""
    o, d, c, rb = out
    return (*o, *d, *c, rb)


def same_bits(got, ref, label=""):
    """Every output equal, float32 outputs by their bits (torch.equal takes
    -0 == +0)."""
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    for k, (a, b) in enumerate(zip(flat(got), flat(ref))):
        assert a.dtype == b.dtype, f"{label} output {k}: dtypes differ"
        assert torch.equal(bits(a), bits(b)), (
            f"{label} output {k} differs on "
            f"{int((bits(a) != bits(b)).sum())} lanes")


def record_pools(name, device, res, overrides=None):
    """(scene, settings, [the arguments of every shade_lanes call]) of one
    eager iteration (iteration 1, seed 0) at res x res, cloned."""
    scene, settings = load_scene(scene_path(name), device,
                                 overrides={"RES": [res, res],
                                            **(overrides or {})})
    calls = []
    real = wavefront.shade_lanes

    def recording(*args, **kw):
        calls.append(([a.clone() if isinstance(a, torch.Tensor) else
                       Vec3(*(c.clone() for c in a)) if isinstance(a, Vec3)
                       else a for a in args], dict(kw)))
        return real(*args, **kw)

    with torch.inference_mode(), mock.patch.object(
            wavefront, "shade_lanes", recording):
        wavefront.render_chunk_eager(scene, settings,
                                     wavefront.zero_accum(settings, device),
                                     1, 1, 0, False)
    assert len(calls) == settings.trace_depth
    return scene, settings, calls


def uniforms_u32(seed, iteration, depth, pixels, m):
    """The kernel's draws written out in uint32 arithmetic (Python ints):
    state = pcg(key ^ pixel * 0xC2B2AE35), draw j = the top 24 bits of
    pcg(state + j * 0x9E3779B9) times 2^-24, the key
    pcg(pcg(seed * GOLDEN + iteration) ^ depth * 0x85EBCA6B)."""
    def pcg(x):
        x = (x * 747796405 + 2891336453) & M32
        x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & M32
        return (x >> 22) ^ x

    key = pcg(((seed * 0x9E3779B9) + iteration) & M32)
    key = pcg(key ^ ((depth & M32) * 0x85EBCA6B & M32))
    out = np.empty((m, len(pixels)), dtype=np.float32)
    for k, p in enumerate(pixels):
        state = pcg(key ^ ((int(p) & M32) * 0xC2B2AE35 & M32))
        for j in range(m):
            bits = pcg((state + j * 0x9E3779B9) & M32)
            out[j, k] = np.float32(bits >> 8) * np.float32(2.0 ** -24)
    return out


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# -- CPU ---------------------------------------------------------------------

@pytest.mark.parametrize("name,overrides", [
    ("cornell", {}), ("animal", {}), ("open_test_scene", {}),
    ("cornell", {"RR_START": 1}), ("animal", {"DEPTH_QUIRK": True}),
    ("open_test_scene", {"RR_START": 2, "DEPTH_QUIRK": True})])
def test_cpu_route_is_the_plain_draw_and_shade(name, overrides):
    """On CPU tensors shade_lanes draws with irng.uniforms and runs shade:
    every bounce pool gives the plain path's bits, and nothing launches."""
    scene, settings = load_scene(scene_path(name), "cpu",
                                 overrides={"RES": [12, 12]})
    settings = dataclasses.replace(
        settings, rr_start=overrides.get("RR_START", 0),
        depth_quirk=overrides.get("DEPTH_QUIRK", False))
    calls = []
    real = wavefront.shade_lanes

    def recording(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    before = dict(kernels.LAUNCHES)
    with torch.inference_mode(), mock.patch.object(
            wavefront, "shade_lanes", recording):
        wavefront.render_chunk_eager(scene, settings,
                                     wavefront.zero_accum(settings, "cpu"),
                                     3, 1, 5, False)
    assert kernels.LAUNCHES == before
    assert len(calls) == settings.trace_depth
    live = 0
    for args, kw in calls:
        got = bsdf.shade_lanes(*args, **kw)
        same_bits(got, plain_shade_lanes(*args, **kw))
        live += int((args[3] > 0).sum())
    assert live > 144


@pytest.mark.parametrize("iteration", ["int", "tensor"])
@pytest.mark.parametrize("offset", [0, 1000])
def test_the_kernels_hash_draws_irng_uniforms(iteration, offset):
    """The hash as the kernel computes it, from IterationRng.depth_key and
    IterationRng.pixels, equals IterationRng.uniforms for int and tensor
    iterations, every depth of a bounce loop, and a pixel offset."""
    seed, it = 3000000019, 77
    it_arg = torch.tensor(it) if iteration == "tensor" else it
    irng = rng.IterationRng(seed, it_arg, pixel_offset=offset)
    lane = torch.tensor([0, 1, 2, 799, 640000 - 1, 12345], dtype=torch.int64)
    for depth in (0, 1, 7, 61, 62, 70):
        key = irng.depth_key(depth)
        assert isinstance(key, torch.Tensor) == (iteration == "tensor")
        pixels = irng.pixels(lane)
        assert torch.equal(pixels, lane + offset)
        want = torch.stack(irng.uniforms(depth, lane, 5)).numpy()
        got = uniforms_u32(seed, it, depth, pixels.tolist(), 5)
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        assert int(key) == int(rng._depth_mix(rng._sample_key(seed, it),
                                              depth))


def test_pixels_follow_the_shard_interleave():
    """With a pixel map (the shard interleave), the kernel's pixel ids are
    pixel_map(lane + offset), as the plain draws' are."""
    _, settings = load_scene(scene_path("cornell"), "cpu",
                             overrides={"RES": [64, 64]})
    settings = dataclasses.replace(settings, shard_interleave=4)
    pmap = settings.pixel_map()
    irng = rng.IterationRng(1, 2, pixel_map=pmap, pixel_offset=1024)
    lane = torch.arange(1024, dtype=torch.int64)
    assert torch.equal(irng.pixels(lane), pmap(lane + 1024))
    want = irng.uniforms(3, lane, 4)
    got = rng.fast_uniforms_perlane(
        rng._pixel_mix(irng.depth_key(3), irng.pixels(lane)), 4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_the_kernel_is_no_mesh_or_own_kernel_of_the_benchmark():
    """The profiler's name of the kernel has its kind, benchmark/trace.py
    counts it in torch_ops_ms, not as a mesh kernel, and the stage timer
    wraps shade_lanes."""
    assert profiling.kernel_kind(DEVICE_NAME) == "shade kernel"
    for name in (DEVICE_NAME, "pt_shade_lanes"):
        assert not is_mesh_kernel(name)
        assert not is_own_kernel(name)
    assert (profiling.wavefront, "shade_lanes", "shade") in profiling.STAGES


def test_the_wrapper_refuses_cpu_tensors():
    scene, _ = load_scene(scene_path("cornell"), "cpu")
    n = 8
    z = torch.zeros(n)
    rb = torch.ones(n, dtype=torch.int32)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.shade((z, z, z), (z, z, z), (z, z, z), rb, z, (z, z, z),
                      rb, scene.materials, key=1,
                      pixel=torch.arange(n))
    assert kernels.LAUNCHES == before


# -- CUDA --------------------------------------------------------------------

def crafted_materials(device) -> MaterialArrays:
    """Diffuse; an emitter; glossy; glossy with black colours (p_diffuse 0);
    a mirror (reflective 1, black albedo); glass (IOR 1.5); near-air glass
    (IOR 1.0001: reflect_prob under the 1e-6 clamp at normal incidence);
    glass with IOR 0 (the 1.0 guard)."""
    color = [[0.8, 0.6, 0.4], [1.0, 0.9, 0.8], [0.5, 0.5, 0.5],
             [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.9, 0.95, 1.0],
             [1.0, 1.0, 1.0], [0.7, 0.7, 0.7]]
    spec = [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.9, 0.8, 0.7],
            [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [1.0, 1.0, 1.0],
            [1.0, 1.0, 1.0], [0.5, 0.5, 0.5]]
    refl = [0.0, 0.0, 0.6, 0.5, 1.0, 0.0, 0.0, 0.0]
    refr = [0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0]
    ior = [0.0, 0.0, 0.0, 0.0, 0.0, 1.5, 1.0001, 0.0]
    emit = [0.0, 5.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return MaterialArrays(f(color), f(spec), f([0.0] * 8), f(refl), f(refr),
                          f(ior), f(emit))


def crafted_lanes(n_random: int, seed: int, device):
    """(origin, direction, color, rb, t, normal, mat_id, uniforms) of
    random lanes over every crafted material, then: misses (t -1), dead
    lanes (remaining_bounces 0, -1, -2), grazing normals (the direction a
    few ulp from the tangent plane), rays leaving glass at grazing angles
    (total internal reflection), rays at normal incidence on near-air glass
    with uniforms 0 (p below the 1e-6 clamp), and uniforms 0 and just
    under 1."""
    r = np.random.default_rng(seed)
    n = n_random
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nrm = r.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    o = r.normal(0, 3.0, (n, 3))
    t = r.uniform(0.01, 10.0, n)
    mat = r.integers(-1, 8, n)
    rb = r.integers(-2, 6, n)
    u = r.uniform(0, 1, (5, n))
    extra = []
    # grazing: d = tangent + e * normal for tiny e, both signs
    for e in (0.0, 1e-7, -1e-7, 1e-30, -1e-30):
        k = 64
        nn = r.normal(size=(k, 3))
        nn /= np.linalg.norm(nn, axis=1, keepdims=True)
        tan = np.cross(nn, r.normal(size=(k, 3)))
        tan /= np.linalg.norm(tan, axis=1, keepdims=True)
        extra.append((tan + e * nn, nn, 5 + np.arange(k) % 3))
    # leaving glass (d along +n: not entering) at grazing angles: TIR
    k = 64
    nn = np.tile([0.0, 1.0, 0.0], (k, 1))
    ang = np.linspace(0.01, 1.5, k)
    dd = np.stack([np.sin(ang), np.cos(ang), np.zeros(k)], 1)
    extra.append((dd, nn, np.full(k, 5)))
    # normal incidence on near-air glass: reflect_prob ~ 2.5e-9
    extra.append((np.tile([0.0, -1.0, 0.0], (k, 1)), nn, np.full(k, 6)))
    for dd, nn, mm in extra:
        k = len(mm)
        d = np.concatenate([d, dd])
        nrm = np.concatenate([nrm, nn])
        o = np.concatenate([o, r.normal(0, 3.0, (k, 3))])
        t = np.concatenate([t, r.uniform(0.01, 10.0, k)])
        mat = np.concatenate([mat, mm])
        rb = np.concatenate([rb, np.full(k, 3)])
        u = np.concatenate([u, r.uniform(0, 1, (5, k))], 1)
    n = len(t)
    t[:32] = -1.0                       # misses
    rb[32:35] = (0, -1, -2)             # dead
    u[:, -3 * k:] = np.where(np.arange(3 * k) % 2 == 0, 0.0,
                             np.float32(1 - 2 ** -24))
    c = r.uniform(0, 1, (n, 3))
    c[40:48] = 0.0                      # black paths (RR's p at its floor)
    f = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)
    i = lambda a: torch.tensor(a, dtype=torch.int32, device=device)
    return (Vec3(*f(o.T)), Vec3(*f(d.T)), Vec3(*f(c.T)), i(rb), f(t),
            Vec3(*f(nrm.T)), i(mat), tuple(f(x) for x in u))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "animal"])
def test_kernel_matches_the_twin_on_every_bounce_pool(name):
    _need_cuda()
    scene, settings, calls = record_pools(name, "cuda", 800)
    with torch.inference_mode():
        for depth, (args, kw) in enumerate(calls):
            before = kernels.LAUNCHES["shade"]
            got = bsdf.shade_lanes(*args, **kw)
            assert kernels.LAUNCHES["shade"] == before + 1
            same_bits(got, plain_shade_lanes(*args, **kw),
                      f"{name} bounce {depth}")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("glossy,refractive", [(True, True), (False, True),
                                               (True, False),
                                               (False, False)])
@pytest.mark.parametrize("rr,rr_on,quirk", [(False, False, False),
                                            (False, False, True),
                                            (True, True, False),
                                            (True, False, True)])
def test_kernel_matches_the_twin_on_crafted_lanes(glossy, refractive, rr,
                                                   rr_on, quirk):
    """Crafted lanes through uniform planes (which can be 0 exactly) and
    through the hash, every branch set, Russian roulette on and off."""
    _need_cuda()
    mats = crafted_materials("cuda")
    o, d, c, rb, t, nrm, mat, u = crafted_lanes(4096, 3, "cuda")
    u = u if rr else u[:4]
    opts = dict(any_glossy=glossy, any_refractive=refractive,
                depth_quirk=quirk)
    rr_kw = dict(rr_depth=2 if rr_on else 0, rr_start=1 if rr else 0)
    with torch.inference_mode():
        got = kernels.shade(o, d, c, rb, t, nrm, mat, mats, uniforms=u,
                            rr=rr, rr_on=rr_on, **opts)
        got = (got[0:3], got[3:6], got[6:9], got[9])
        same_bits(got, bsdf.shade(o, d, c, rb, t, nrm, mat, mats, u,
                                  **opts, **rr_kw), "planes")
        pixel = torch.arange(t.shape[0], dtype=torch.int64,
                             device="cuda") * 7
        key = 0x12345678
        got = kernels.shade(o, d, c, rb, t, nrm, mat, mats, key=key,
                            pixel=pixel, rr=rr, rr_on=rr_on, **opts)
        got = (got[0:3], got[3:6], got[6:9], got[9])
        uh = rng.fast_uniforms_perlane(rng._pixel_mix(key, pixel),
                                       5 if rr else 4)
        same_bits(got, bsdf.shade(o, d, c, rb, t, nrm, mat, mats, uh,
                                  **opts, **rr_kw), "hash")
        ragged = [slice(0, 1), slice(0, 255), slice(0, 257)]
        for sl in ragged:
            sub = lambda v: Vec3(*(x[sl].contiguous() for x in v))
            args = (sub(o), sub(d), sub(c), rb[sl].contiguous(),
                    t[sl].contiguous(), sub(nrm), mat[sl].contiguous())
            us = tuple(x[sl].contiguous() for x in u)
            got = kernels.shade(*args, mats, uniforms=us, rr=rr,
                                rr_on=rr_on, **opts)
            same_bits((got[0:3], got[3:6], got[6:9], got[9]),
                      bsdf.shade(*args, mats, us, **opts, **rr_kw),
                      "ragged")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sorted", "tiled", "threefry", "sharded",
                                  "rr"])
def test_engine_modes_equal_the_plain_path(mode):
    """The sorted, tiled, threefry, sharded (shard_interleave, pixel
    offsets, key salts) and Russian-roulette renders through the kernel
    equal the same renders with the plain draw and shade, bit for bit."""
    _need_cuda()
    from pathtracer_tpu_torch.parallel import sharding
    scene, settings = load_scene(scene_path("open_test_scene"), "cuda",
                                 overrides={"RES": [64, 64]})
    if mode == "sorted":
        settings = dataclasses.replace(settings, sort_materials=True)
    elif mode == "tiled":
        settings = dataclasses.replace(settings, compact=True,
                                       compact_tile=1024)
    elif mode == "threefry":
        settings = dataclasses.replace(settings, fast_rng=False)
    elif mode == "rr":
        settings = dataclasses.replace(settings, rr_start=2)

    def run():
        if mode == "sharded":
            mesh = sharding.make_ray_mesh(4, devices="cuda")
            return sharding.render_sharded(scene, settings, mesh,
                                           iterations=2, seed=9)
        acc = wavefront.zero_accum(settings, "cuda")
        wavefront.render_chunk_eager(scene, settings, acc, 1, 2, 9, True)
        return acc.to_array().cpu().numpy()

    kernels.reset_counts()
    got = run()
    assert kernels.LAUNCHES["shade"] >= settings.trace_depth
    kernels.reset_counts()
    with mock.patch.object(wavefront, "shade_lanes", plain_shade_lanes):
        ref = run()
    assert kernels.LAUNCHES["shade"] == 0
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    assert float(np.abs(got).sum()) > 0
    wavefront.clear_frames()
    kernels.reset_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "animal"])
def test_compiled_frame_equals_the_eager_plain_loop(name):
    """The compiled frame launches the kernel once a bounce (counted on
    replay): its 64x64 image equals the eager loop's through the plain
    draw and shade bit for bit."""
    _need_cuda()
    scene, settings = load_scene(scene_path(name), "cuda",
                                 overrides={"RES": [64, 64]})
    iters = 3
    wavefront.clear_frames()
    with torch.inference_mode():
        assert wavefront.eager_reason(settings, "cuda") is None
        frame = wavefront.capture_frame(scene, settings,
                                        settings.pixel_count, 0, 0, None,
                                        scene.device)
        assert frame.launches["shade"] == settings.trace_depth
        kernels.reset_counts()
        got = wavefront.render_chunk(scene, settings,
                                     wavefront.zero_accum(settings, "cuda"),
                                     1, iters, 0)
        assert kernels.LAUNCHES["shade"] == settings.trace_depth * iters
        kernels.reset_counts()
        with mock.patch.object(wavefront, "shade_lanes", plain_shade_lanes):
            ref = wavefront.render_chunk_eager(
                scene, settings, wavefront.zero_accum(settings, "cuda"), 1,
                iters, 0, False)
        assert kernels.LAUNCHES["shade"] == 0
        torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert float(sum(c.sum() for c in got)) > 0
    wavefront.clear_frames()
    kernels.reset_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("name,field", [("cornell", "color"),
                                        ("cornell", "emittance"),
                                        ("glass_slab", "ior"),
                                        ("animal", "color")])
def test_gradients_through_the_function_equal_the_plain_paths(name, field):
    """render_iteration under autograd: the forward image through the
    kernel's autograd.Function equals the plain path's bit for bit, and
    the gradient of a weighted image sum in the albedo, the emittance or
    the IOR equals the plain path's within the card's atomic-sum rounding
    (the material gather's backward sums with atomics)."""
    _need_cuda()
    scene, settings = load_scene(scene_path(name), "cuda",
                                 overrides={"RES": [32, 32]})
    w = torch.rand(3, settings.pixel_count, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(1))

    def run():
        p = getattr(scene.materials, field).detach().clone()
        p.requires_grad_(True)
        mats = dataclasses.replace(scene.materials, **{field: p})
        sc = dataclasses.replace(scene, materials=mats)
        acc = wavefront.zero_accum(settings, "cuda")
        img = wavefront.render_iteration(sc, settings, acc, 1, seed=4)
        loss = (img.to_array().T * w).sum()
        (g,) = torch.autograd.grad(loss, p)
        return img.to_array().detach(), g

    kernels.reset_counts()
    img, g = run()
    assert kernels.LAUNCHES["shade"] == settings.trace_depth
    with mock.patch.object(wavefront, "shade_lanes", plain_shade_lanes):
        img_p, g_p = run()
    assert torch.equal(img.view(torch.int32), img_p.view(torch.int32))
    assert float(g_p.abs().sum()) > 0
    torch.testing.assert_close(g, g_p, rtol=1e-5, atol=1e-7)
    kernels.reset_counts()


@pytest.mark.cuda
def test_the_wrapper_rejects_bad_inputs():
    _need_cuda()
    mats = crafted_materials("cuda")
    o, d, c, rb, t, nrm, mat, u = crafted_lanes(64, 0, "cuda")
    args = (o, d, c, rb, t, nrm, mat, mats)
    with pytest.raises(TypeError):
        kernels.shade(o, d, c, rb.long(), t, nrm, mat, mats, uniforms=u[:4])
    with pytest.raises(ValueError):
        kernels.shade(Vec3(o.x[::2], o.y, o.z), d, c, rb, t, nrm, mat, mats,
                      uniforms=u[:4])
    with pytest.raises(ValueError):
        kernels.shade(o, d, c, rb, t.cpu(), nrm, mat, mats, uniforms=u[:4])
    with pytest.raises(ValueError, match="uniform"):
        kernels.shade(*args, uniforms=u[:4], rr=True)
    with pytest.raises(ValueError, match="pixel"):
        kernels.shade(*args, key=3, pixel=torch.arange(
            t.shape[0], device="cuda", dtype=torch.int32))
    with pytest.raises(ValueError, match="key"):
        kernels.shade(*args, key=torch.zeros(2, dtype=torch.int64,
                                             device="cuda"),
                      pixel=torch.arange(t.shape[0], device="cuda"))
    bad = dataclasses.replace(mats, color=mats.color.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.shade(o, d, c, rb, t, nrm, mat, bad, uniforms=u[:4])
