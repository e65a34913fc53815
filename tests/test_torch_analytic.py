"""PyTorch port, the analytic closest hit: csrc/analytic.cu (one launch a
bounce) and its plain twin, ops/intersect.py analytic_plain. Imports no JAX,
so it also runs on a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_analytic.py -m cuda

On the CPU: the route intersect_scene takes (`analytic_route`), the plain
twin against the inline loop it was moved from, the launch entries, and
that the kernel's name is none of the benchmark's own kernels. The tests
marked `cuda` build the library and hold the kernel to the plain twin bit
for bit on every output and lane (the pools of every bounce of a Cornell
and an alien 800x800 iteration, and crafted rays), the compiled frame's
images to the eager plain path's, and the launch count; they skip without
a CUDA device.
"""
import dataclasses
import json
import os
import re
from unittest import mock

import numpy as np
import pytest
import torch

from benchmark.trace import is_mesh_kernel, is_own_kernel
from pathtracer_tpu_torch import load_scene
from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.ops import intersect, kernels
from pathtracer_tpu_torch.ops.intersect import (analytic_plain,
                                                analytic_route, box_intersect,
                                                sphere_intersect)
from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.scene.types import MESH, SPHERE
from pathtracer_tpu_torch.utils import profiling, spans
from pathtracer_tpu_torch.utils.vec import Vec3

torch.set_num_threads(2)

FLT_MAX = 3.402823466e38
# the kernel's name as torch.profiler shows it
DEVICE_NAME = ("(anonymous namespace)::pt_analytic_hit(int const*, int "
               "const*, float4 const*, float4 const*, int, float const*, "
               "float const*, float const*, float const*, float const*, "
               "float const*, float*, float*, float*, float*, int*, bool*, "
               "int)")


def old_inline_loop(scene, geom_types, origin, direction):
    """intersect_scene's analytic loop as it stood inline before it moved
    into analytic_plain: (t_best, n_best, m_best, any_hit)."""
    n = origin.x.shape[0]
    dev = origin.x.device
    t_best = torch.full((n,), FLT_MAX, device=dev)
    n_best = Vec3.zeros(n, dev)
    m_best = torch.zeros((n,), dtype=torch.int32, device=dev)
    any_hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    g = scene.geoms
    for i, gt in enumerate(geom_types):
        if gt == MESH:
            continue
        fn = sphere_intersect if gt == SPHERE else box_intersect
        t, nrm = fn(g.transform[i], g.inverse_transform[i],
                    g.inv_transpose[i], origin, direction)
        upd = torch.logical_and(t > 0.0, t < t_best)
        t_best = torch.where(upd, t, t_best)
        n_best = Vec3.where(upd, nrm, n_best)
        m_best = torch.where(upd, g.material_id[i].expand(n), m_best)
        any_hit = torch.logical_or(any_hit, upd)
    return t_best, n_best, m_best, any_hit


def flat(out):
    """(t, nx, ny, nz, mat, hit) of an analytic result."""
    t, nrm, mat, hit = out
    return (t, *nrm, mat, hit)


def same_bits(got, ref):
    """Every output equal, float32 outputs by their bits (torch.equal takes
    -0 == +0)."""
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    for k, (a, b) in enumerate(zip(flat(got), flat(ref))):
        assert a.dtype == b.dtype, f"output {k}: {a.dtype} vs {b.dtype}"
        assert torch.equal(bits(a), bits(b)), (
            f"output {k} differs on {int((bits(a) != bits(b)).sum())} lanes")


def write_crafted_scene(directory) -> str:
    """Boxes and spheres at odd angles and non-uniform scales, a box that
    holds the camera, and two coincident boxes with different materials
    (the first must win their ties). Returns the scene JSON's path."""
    mats = {f"m{k}": {"TYPE": "Diffuse", "RGB": [0.2 + 0.1 * k, 0.5, 0.5]}
            for k in range(6)}

    def obj(kind, mat, trans, rot, scale):
        return {"TYPE": kind, "MATERIAL": mat, "TRANS": trans,
                "ROTAT": rot, "SCALE": scale}
    scene = {
        "Materials": mats,
        "Camera": {"RES": [16, 16], "FOVY": 45.0, "ITERATIONS": 1,
                   "DEPTH": 2, "FILE": "crafted", "EYE": [0.0, 0.0, 9.0],
                   "LOOKAT": [0.0, 0.0, 0.0], "UP": [0.0, 1.0, 0.0]},
        "Objects": [
            obj("cube", "m0", [0.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                [30.0, 30.0, 30.0]),
            obj("cube", "m1", [1.0, -0.5, 0.3], [23.0, 41.0, 7.0],
                [2.0, 0.7, 1.3]),
            obj("cube", "m2", [1.0, -0.5, 0.3], [23.0, 41.0, 7.0],
                [2.0, 0.7, 1.3]),
            obj("sphere", "m3", [-1.5, 1.0, -0.5], [10.0, 70.0, 30.0],
                [1.5, 2.5, 1.0]),
            obj("sphere", "m4", [2.0, 2.0, -2.0], [0.0, 0.0, 0.0],
                [2.0, 2.0, 2.0]),
            obj("cube", "m5", [-2.0, -2.0, 1.0], [0.0, 90.0, 0.0],
                [1.0, 1.0, 1.0]),
        ]}
    path = os.path.join(directory, "crafted.json")
    with open(path, "w") as f:
        json.dump(scene, f)
    return path


def crafted_rays(scene, n_random: int, seed: int):
    """(origin, direction) numpy planes [3, N] float32: random rays; rays
    from inside each box and sphere; along the axes with the other
    direction components exactly 0, +-1e-21, +-1e-20 (the box's clamp) and
    its float neighbours; zero directions (dead lanes); rays grazing each
    sphere (object-space tangents, a few ulp either side); and a few lanes
    with an Inf or NaN in o or d."""
    r = np.random.default_rng(seed)
    tf = scene.geoms.transform.cpu().numpy().astype(np.float64)
    kinds = scene.geoms.gtype.cpu().numpy()
    o_list = [r.normal(0, 4.0, (n_random, 3))]
    d_list = [r.normal(0, 1.0, (n_random, 3))]

    def world(m, p, w):
        return (m[:3, :3] @ p.T).T + w * m[:3, 3]

    clamp = float(np.float32(1e-20))
    tiny = [0.0, -0.0, 1e-21, -1e-21, clamp, -clamp,
            float(np.nextafter(np.float32(clamp), np.float32(0))),
            float(np.nextafter(np.float32(clamp), np.float32(1))),
            -float(np.nextafter(np.float32(clamp), np.float32(1)))]
    axes = np.eye(3)
    for g, kind in enumerate(kinds):
        if kind == MESH:
            continue
        m = tf[g]
        # from inside: the centre and points near it
        p_obj = np.concatenate([np.zeros((1, 3)),
                                r.uniform(-0.3, 0.3, (15, 3))])
        o_in = world(m, p_obj, 1.0)
        for k in range(3):
            for s in (1.0, -1.0):
                for e in tiny:
                    d = s * axes[k] + e * (1.0 - axes[k])
                    o_list.append(o_in[:4])
                    d_list.append(np.repeat(d[None], 4, 0))
        o_list.append(o_in)
        d_list.append(r.normal(size=o_in.shape))
        o_list.append(o_in[:4])
        d_list.append(np.zeros((4, 3)))                  # dead lanes
        if kind == SPHERE:
            # tangents in object space: the ray y = h, z = 0 along +x
            h = np.float32(0.5)
            hs = [h]
            for _ in range(3):
                hs.append(np.nextafter(hs[-1], np.float32(1)))
            lo = [h]
            for _ in range(3):
                lo.append(np.nextafter(lo[-1], np.float32(0)))
            hs = np.array(hs + lo[1:], dtype=np.float64)
            ro = np.stack([np.full_like(hs, -2.0), hs, np.zeros_like(hs)],
                          1)
            rd = np.repeat(np.array([[1.0, 0.0, 0.0]]), len(hs), 0)
            o_list.append(world(m, ro, 1.0))
            d_list.append(world(m, rd, 0.0))
    o = np.concatenate(o_list).astype(np.float32)
    d = np.concatenate(d_list).astype(np.float32)
    lane = np.arange(8)
    bad = np.array([np.inf, -np.inf, np.nan, 1e30])
    o[lane[:4], lane[:4] % 3] = bad
    d[lane[4:8], lane[4:8] % 3] = bad
    return np.ascontiguousarray(o.T), np.ascontiguousarray(d.T)


def random_rays(n: int, seed: int):
    """(origin, direction) numpy planes [3, n] float32 of finite random
    rays (no zero direction: autograd's gradients stay finite)."""
    r = np.random.default_rng(seed)
    o = r.normal(0, 4.0, (3, n)).astype(np.float32)
    return o, r.normal(0, 1.0, (3, n)).astype(np.float32)


def to_vec3(planes, device) -> Vec3:
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(p)).to(device)
                  for p in planes))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# -- CPU ---------------------------------------------------------------------

@pytest.mark.parametrize("device_type,records,route", [
    ("cpu", False, "plain"), ("cpu", True, "plain"),
    ("cuda", True, "grad"), ("cuda", False, "kernel")])
def test_analytic_route(device_type, records, route):
    """CPU tensors take the plain twin; on CUDA, autograd recording takes the
    plain expression and inference the kernel."""
    assert analytic_route(device_type, records) == route


@pytest.mark.parametrize("name", ["cornell", "teapot", "open_test_scene",
                                  "crafted"])
def test_plain_twin_equals_the_old_inline_loop(name, tmp_path):
    path = (write_crafted_scene(tmp_path) if name == "crafted"
            else scene_path(name))
    scene, settings = load_scene(path, "cpu")
    o, d = crafted_rays(scene, 512, 7)
    origin, direction = to_vec3(o, "cpu"), to_vec3(d, "cpu")
    got = analytic_plain(scene, settings.geom_types, origin, direction)
    ref = old_inline_loop(scene, settings.geom_types, origin, direction)
    same_bits(got, ref)
    assert int(got[3].sum()) > 100


def test_crafted_ties_go_to_the_first_box(tmp_path):
    """Two coincident boxes (materials 1 and 2 in table order): every ray
    that hits them keeps the first."""
    scene, settings = load_scene(write_crafted_scene(tmp_path), "cpu")
    m = scene.geoms.transform[1].numpy().astype(np.float64)
    n = 64
    p = np.random.default_rng(3).uniform(-0.4, 0.4, (n, 3))
    target = (m[:3, :3] @ p.T).T + m[:3, 3]
    origin = target + np.array([0.0, 0.0, 6.0])
    o = to_vec3(origin.T.astype(np.float32), "cpu")
    d = to_vec3((target - origin).T.astype(np.float32), "cpu")
    t, _, mat, hit = analytic_plain(scene, settings.geom_types, o, d)
    mat_box1 = int(scene.geoms.material_id[1])
    assert bool(hit.all())
    assert int((mat == mat_box1).sum()) > n // 2
    assert int((mat == int(scene.geoms.material_id[2])).sum()) == 0


def test_intersect_scene_on_the_cpu_launches_nothing():
    """CPU tensors, with autograd recording or not: the plain twin, no
    launch and no count of the autograd route (that counts CUDA calls)."""
    scene, settings = load_scene(scene_path("cornell"), "cpu")
    o, d = crafted_rays(scene, 64, 1)
    spans.reset()
    before = dict(kernels.LAUNCHES)
    origin = to_vec3(o, "cpu")
    direction = Vec3(*(c.requires_grad_(True) for c in to_vec3(d, "cpu")))
    t, nrm, mat = intersect.intersect_scene(scene, settings.geom_types,
                                            origin, direction)
    assert t.grad_fn is not None
    with torch.inference_mode():
        intersect.intersect_scene(scene, settings.geom_types,
                                  to_vec3(o, "cpu"), to_vec3(d, "cpu"))
    assert kernels.LAUNCHES == before
    assert "analytic_grad" not in spans.snapshot()["counters"]
    ref = old_inline_loop(scene, settings.geom_types, origin, direction)
    assert torch.equal(t, torch.where(ref[3], ref[0], -1.0))
    assert torch.equal(mat, ref[2])


def test_the_autograd_route_is_counted_and_differentiable():
    """The "grad" route runs the plain expression, which autograd records,
    and counts the call; the operator's report prints the share."""
    scene, settings = load_scene(scene_path("cornell"), "cpu")
    o, d = random_rays(256, 2)
    spans.reset()
    origin = Vec3(*(c.requires_grad_(True) for c in to_vec3(o, "cpu")))
    with mock.patch.object(intersect, "analytic_route",
                           lambda device_type, records: "grad"):
        t, nrm, mat = intersect.intersect_scene(
            scene, settings.geom_types, origin, to_vec3(d, "cpu"))
    assert spans.snapshot()["counters"]["analytic_grad"] == 1
    (g,) = torch.autograd.grad(torch.where(t > 0, t, 0.0).sum(), origin.x)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    calls = profiling.analytic_calls(3)
    assert calls == {"kernel": 3, "grad": 1, "kernel_share": 0.75}
    spans.reset()


def test_the_report_carries_the_analytic_calls():
    rep = profiling.report(scene_path("cornell"), "cpu", iters=1,
                           overrides={"RES": [16, 16], "DEPTH": 2})
    assert rep["analytic"] == {"kernel": 0, "grad": 0, "kernel_share": None}
    stages = rep["stage_times"]["stages"]
    assert stages["intersect.analytic"]["calls"] == (
        stages["intersect"]["calls"])
    assert ("analytic closest hit on the card: 0 kernel launches, 0 plain "
            "calls under autograd (none on the card)"
            in profiling.format_report(rep))


def test_the_wrapper_refuses_cpu_tensors():
    scene, _ = load_scene(scene_path("cornell"), "cpu")
    o, d = crafted_rays(scene, 16, 0)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.analytic(scene.geoms, *to_vec3(o, "cpu"),
                         *to_vec3(d, "cpu"))
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("name", ["cornell", "animal", "teapot", "crafted"])
def test_the_geom_tables_the_kernel_reads_are_row_major(name, tmp_path):
    """The wrapper reads gtype, material_id, inverse_transform and
    inv_transpose by pointer, row-major, and refuses any other layout: the
    loader builds them so."""
    path = (write_crafted_scene(tmp_path) if name == "crafted"
            else scene_path(name))
    scene, _ = load_scene(path, "cpu")
    g = scene.geoms
    for t in (g.gtype, g.material_id, g.inverse_transform, g.inv_transpose):
        assert t.is_contiguous()
    assert torch.equal(g.inv_transpose, g.inverse_transform.transpose(1, 2))


def test_the_kernel_is_no_mesh_or_own_kernel_of_the_benchmark():
    """benchmark/trace.py must count the kernel in torch_ops_ms, not in
    mesh_kernel_ms or mesh_roofline_pct."""
    names = dict(profiling.PORT_KERNELS)
    assert names["pt_analytic_hit"] == "analytic"
    for name in (DEVICE_NAME, "pt_analytic_hit",
                 "void (anonymous namespace)::pt_analytic_hit()"):
        assert not is_mesh_kernel(name)
        assert not is_own_kernel(name)
    assert profiling.kernel_kind(DEVICE_NAME) == "analytic hit kernel"


def test_the_launch_entries_are_there():
    """SOURCES, _ARGTYPES and LAUNCHES hold the kernel, and the C entry
    point takes as many arguments as its argtypes list."""
    assert "analytic.cu" in kernels.SOURCES
    assert "analytic" in kernels.LAUNCHES
    with open(os.path.join(kernels.CSRC, "analytic.cu")) as f:
        src = f.read()
    assert re.search(r"__global__[^;{]*\bpt_analytic_hit\(", src)
    sig = re.search(r'extern "C" int pt_analytic\(([^)]*)\)', src)
    assert sig is not None
    n_args = len(sig.group(1).split(","))
    assert n_args == len(kernels._ARGTYPES["pt_analytic"])


# -- CUDA --------------------------------------------------------------------

def bounce_pools(name: str, res: int):
    """(scene, settings, [(origin, direction)] of every bounce of one
    iteration at res x res, the scene's own depth) on the card, recorded at
    each intersect_scene call of the eager loop."""
    scene, settings = load_scene(scene_path(name), "cuda",
                                 overrides={"RES": [res, res]})
    pools = []
    real = wavefront.intersect_scene

    def recording(sc, gt, origin, direction, **kw):
        pools.append((Vec3(*(c.clone() for c in origin)),
                      Vec3(*(c.clone() for c in direction))))
        return real(sc, gt, origin, direction, **kw)

    with torch.inference_mode(), mock.patch.object(
            wavefront, "intersect_scene", recording):
        wavefront.render_chunk_eager(scene, settings,
                                     wavefront.zero_accum(settings, "cuda"),
                                     1, 1, 0, False)
    torch.cuda.synchronize()
    assert len(pools) == settings.trace_depth
    return scene, settings, pools


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "animal"])
def test_kernel_matches_the_plain_twin_on_every_bounce_pool(name):
    _need_cuda()
    scene, settings, pools = bounce_pools(name, 800)
    with torch.inference_mode():
        for depth, (origin, direction) in enumerate(pools):
            before = kernels.LAUNCHES["analytic"]
            got = intersect.analytic_hit(scene, settings.geom_types, origin,
                                         direction)
            assert kernels.LAUNCHES["analytic"] == before + 1
            ref = analytic_plain(scene, settings.geom_types, origin,
                                 direction)
            same_bits(got, ref)
            if depth == 0:
                assert int(got[3].sum()) > 100000
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "animal", "crafted"])
def test_kernel_matches_the_plain_twin_on_crafted_rays(name, tmp_path):
    _need_cuda()
    path = (write_crafted_scene(tmp_path) if name == "crafted"
            else scene_path(name))
    scene, settings = load_scene(path, "cuda")
    o, d = crafted_rays(scene, 4096, 11)
    origin, direction = to_vec3(o, "cuda"), to_vec3(d, "cuda")
    with torch.inference_mode():
        got = intersect.analytic_hit(scene, settings.geom_types, origin,
                                     direction)
        same_bits(got, analytic_plain(scene, settings.geom_types, origin,
                                      direction))
        for n in (1, 255, 257):                     # ragged pools
            sub = (Vec3(*(c[:n] for c in origin)),
                   Vec3(*(c[:n] for c in direction)))
            same_bits(intersect.analytic_hit(scene, settings.geom_types,
                                             *sub),
                      analytic_plain(scene, settings.geom_types, *sub))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_autograd_on_the_card_takes_the_plain_expression():
    """Rays that autograd records through run the plain expression (counted,
    no launch) and carry a gradient; the same rays under inference launch
    the kernel, with the same bits."""
    _need_cuda()
    scene, settings = load_scene(scene_path("cornell"), "cuda")
    o, d = random_rays(4096, 5)
    spans.reset()
    before = kernels.LAUNCHES["analytic"]
    origin = Vec3(*(c.requires_grad_(True) for c in to_vec3(o, "cuda")))
    direction = to_vec3(d, "cuda")
    got = intersect.analytic_hit(scene, settings.geom_types, origin,
                                 direction)
    assert kernels.LAUNCHES["analytic"] == before
    assert spans.snapshot()["counters"]["analytic_grad"] == 1
    (g,) = torch.autograd.grad(torch.where(got[3], got[0], 0.0).sum(),
                               origin.x)
    assert bool(torch.isfinite(g).all())
    with torch.inference_mode():
        inf = intersect.analytic_hit(scene, settings.geom_types,
                                     to_vec3(o, "cuda"), direction)
    assert kernels.LAUNCHES["analytic"] == before + 1
    same_bits(inf, tuple(x.detach() if isinstance(x, torch.Tensor)
                         else Vec3(*(c.detach() for c in x)) for x in got))
    spans.reset()


@pytest.mark.cuda
def test_the_wrapper_rejects_bad_inputs():
    _need_cuda()
    scene, _ = load_scene(scene_path("cornell"), "cuda")
    o, d = crafted_rays(scene, 64, 0)
    origin, direction = to_vec3(o, "cuda"), to_vec3(d, "cuda")
    with pytest.raises(TypeError):
        kernels.analytic(scene.geoms, origin.x.double(), *origin[1:],
                         *direction)
    with pytest.raises(ValueError):
        kernels.analytic(scene.geoms, origin.x[::2], *origin[1:],
                         *direction)
    with pytest.raises(ValueError):
        kernels.analytic(scene.geoms, origin.x.cpu(), *origin[1:],
                         *direction)
    g = scene.geoms
    bad = dataclasses.replace(g, inv_transpose=g.inverse_transform.transpose(
        1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.analytic(bad, *origin, *direction)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "animal"])
def test_compiled_frame_equals_the_eager_plain_path(name):
    """The compiled frame (captured under set_sync_debug_mode("error"))
    launches the kernel once a bounce: its 64x64 image equals the eager
    loop's through the plain twin bit for bit, and LAUNCHES["analytic"]
    counts bounces x iterations."""
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
        assert frame.launches["analytic"] == settings.trace_depth
        kernels.reset_counts()
        got = wavefront.render_chunk(scene, settings,
                                     wavefront.zero_accum(settings, "cuda"),
                                     1, iters, 0)
        assert kernels.LAUNCHES["analytic"] == settings.trace_depth * iters
        kernels.reset_counts()
        with mock.patch.object(intersect, "analytic_route",
                               lambda device_type, records: "plain"):
            ref = wavefront.render_chunk_eager(
                scene, settings, wavefront.zero_accum(settings, "cuda"), 1,
                iters, 0, False)
        assert kernels.LAUNCHES["analytic"] == 0
        torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert float(sum(c.sum() for c in got)) > 0
    wavefront.clear_frames()
    kernels.reset_counts()
