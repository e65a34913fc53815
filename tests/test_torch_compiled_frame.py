"""PyTorch port, the compiled frame (engine/wavefront.py): render_chunk as
one captured CUDA graph replay an iteration.

On the CPU: the capturable iteration (all trace_depth masked bounces, the
iteration number a 0-d tensor) against the JAX package's render_chunk, with
early exit and without, under tests/test_torch_engine.py's rule (under 1%
of pixels off by more than 1e-4); the tensor-iteration RNG against the int
one, bit for bit; the rule that picks the eager loop (`eager_reason`); the
graph cache key; the replay's launch accounting; render_chunk_compiled's
warm-up, replays and accumulator copies with a graph that runs the
iteration on the CPU; the cache's memory budget and its warnings; the
gradients' route (render_iteration, never render_chunk);
kernel_bench.device_sums and profiling.port_launches on synthetic profiler
events.
The `cuda` tests capture every --bvh on the card under
set_sync_debug_mode("error") and hold the compiled chunk to the eager one
bit for bit; they skip without a device. On the card, without JAX:
    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_compiled_frame.py -m cuda
"""
import contextlib
import dataclasses
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import load_scene
from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.engine.wavefront import (Frame,
                                                   capturable_iteration,
                                                   eager_reason, frame_key,
                                                   zero_accum)
from pathtracer_tpu_torch.ops import binned, kernels, rng
from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.utils.kernel_bench import device_sums
from pathtracer_tpu_torch.utils.profiling import PORT_KERNELS, port_launches

torch.set_num_threads(2)

# (scene, res, depth, bvh): the capturable iteration against JAX
CASES = [("cornell", 32, 8, None), ("open_test_scene", 32, 8, None),
         ("teapot", 24, 4, "binned"), ("teapot", 24, 4, "wide")]
BVHS = ("binned", "wide", "wide_nosort", "pallas", "sorted", "brute")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b) -> bool:
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _load(name, res, depth, bvh=None, device="cpu"):
    return load_scene(scene_path(name), device,
                      overrides={"RES": [res, res], "DEPTH": depth},
                      bvh_impl=bvh)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("name,res,depth,bvh", CASES)
def test_capturable_iteration_matches_jax(name, res, depth, bvh,
                                          early_exit):
    """Two iterations of the capturable iteration on the CPU against the
    JAX package's render_chunk of the same two, lane by lane. JAX is
    imported here, so that the `cuda` tests run where it is missing."""
    import jax.numpy as jnp

    from pathtracer_tpu import load_scene as jax_load_scene
    from pathtracer_tpu.engine.wavefront import render_chunk as jax_chunk
    from pathtracer_tpu.engine.wavefront import zero_accum as jax_zero

    overrides = {"RES": [res, res], "DEPTH": depth}
    j_scene, j_set = jax_load_scene(scene_path(name), overrides=overrides,
                                    wide_tables=bvh == "wide")
    if bvh is not None:
        j_set = dataclasses.replace(j_set, bvh_impl=bvh)
    p_scene, p_set = _load(name, res, depth, bvh)
    acc_j = jax_chunk(j_scene, j_set, jax_zero(j_set), jnp.int32(1), 2,
                      seed=0, early_exit=early_exit)
    want = np.stack([np.asarray(c) for c in acc_j], axis=-1)
    acc = zero_accum(p_set, "cpu")
    it = torch.tensor(1, dtype=torch.int64)
    with torch.inference_mode():
        for _ in range(2):
            capturable_iteration(p_scene, p_set, acc, it, seed=0)
    assert int(it) == 3
    got = torch.stack(tuple(acc), dim=-1).numpy()
    assert np.isfinite(got).all() and got.max() > 0
    differs = np.abs(got - want).max(axis=-1) > 1e-4
    assert differs.mean() < 0.01, differs.mean()


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
@pytest.mark.parametrize("pixel_offset", [0, 300])
def test_tensor_iteration_draws_the_int_bits(pixel_offset, seed):
    """IterationRng with a 0-d tensor iteration: uniforms and normals bit
    for bit the int iteration's, at raygen's depths -2 and -1 and bounces
    0..7, with and without a shard offset (and a seed whose product with
    the golden ratio passes 2**63)."""
    _, settings = _load("teapot", 16, 8)
    pmap = settings.pixel_map()
    lanes = torch.arange(256, dtype=torch.int64)
    for iteration in (1, 2, 4097):
        a = rng.IterationRng(seed, iteration, pixel_map=pmap,
                             pixel_offset=pixel_offset)
        b = rng.IterationRng(seed, torch.tensor(iteration), pixel_map=pmap,
                             pixel_offset=pixel_offset)
        for depth in range(-2, 8):
            assert _same(a.uniforms(depth, lanes, 5),
                         b.uniforms(depth, lanes, 5)), (iteration, depth)
            assert _same(a.normals(depth, lanes, 3),
                         b.normals(depth, lanes, 3)), (iteration, depth)


def test_tensor_iteration_needs_the_fast_path():
    with pytest.raises(ValueError, match="0-d"):
        rng.IterationRng(0, torch.tensor(1), fast=False)
    with pytest.raises(ValueError, match="0-d"):
        rng.IterationRng(0, torch.tensor([1]))


def _rule_case(name):
    """(settings, device, early_exit, context, the reason's words or None
    for the compiled frame)."""
    _, teapot = _load("teapot", 16, 2)
    _, cornell = _load("cornell", 16, 2)
    rep = dataclasses.replace
    cases = {
        # compiled: every --bvh that captures, and the masked forms
        **{f"compiled_{b}": (rep(teapot, bvh_impl=b), "cuda", True, None,
                             None) for b in BVHS},
        "compiled_cuda1": (teapot, "cuda:1", True, None, None),
        "compiled_no_exit_sorted": (rep(teapot, sort_materials=True),
                                    "cuda", False, None, None),
        "compiled_no_exit_tiled": (rep(teapot, compact=True), "cuda", False,
                                   None, None),
        "compiled_jnp_without_mesh": (rep(cornell, bvh_impl="jnp"), "cuda",
                                      True, None, None),
        # eager
        "eager_cpu": (teapot, "cpu", True, None, "CUDA"),
        "eager_threefry": (rep(teapot, fast_rng=False), "cuda", True, None,
                           "threefry"),
        "eager_jnp": (rep(teapot, bvh_impl="jnp"), "cuda", True, None,
                      "jnp"),
        "eager_sorted": (rep(cornell, sort_materials=True), "cuda", True,
                         None, "sorted"),
        "eager_tiled": (rep(cornell, compact=True, compact_tile=64),
                        "cuda", True, None, "tiled"),
    }
    return cases[name]


RULE_CASES = ([f"compiled_{b}" for b in BVHS]
              + ["compiled_cuda1", "compiled_no_exit_sorted",
                 "compiled_no_exit_tiled", "compiled_jnp_without_mesh",
                 "eager_cpu", "eager_threefry", "eager_jnp", "eager_sorted",
                 "eager_tiled"])


@pytest.mark.parametrize("case", RULE_CASES)
def test_eager_reason(case):
    """The settings rule, decided without a device: each compiled case
    and each eager one (render_chunk runs under inference mode)."""
    settings, device, early_exit, ctx, words = _rule_case(case)
    with torch.inference_mode(), (ctx or contextlib.nullcontext()):
        reason = eager_reason(settings, device, early_exit)
    if words is None:
        assert reason is None
    else:
        assert reason is not None and words in reason, reason


def test_gradients_go_through_render_iteration_only():
    """The gradients' route stays eager without a rule case: render_chunk
    runs under inference mode, so an albedo that requires grad gets no
    graph there, while render_iteration records one."""
    from pathtracer_tpu_torch.utils.grad import with_materials
    scene, settings = _load("cornell", 8, 2)
    albedo = scene.materials.color.clone().requires_grad_(True)
    scene = with_materials(scene, color=albedo)
    with torch.enable_grad():
        chunk = wavefront.render_chunk(scene, settings,
                                       zero_accum(settings, "cpu"), 1, 1)
        it = wavefront.render_iteration(scene, settings,
                                        zero_accum(settings, "cpu"), 1,
                                        early_exit=False)
    assert not chunk.x.requires_grad
    assert it.x.requires_grad


def _key_variant(name, scene, settings):
    """frame_key's arguments with the one input `name` changed, and the
    context to compute it in."""
    args = dict(scene=scene, settings=settings, n=256, seed=0,
                pixel_offset=0, key_salt=None, device="cuda:0")
    ctx = contextlib.nullcontext()
    if name == "scene_tensor":
        args["scene"] = dataclasses.replace(
            scene, tris_packed=scene.tris_packed.clone())
    elif name == "scene_nested_tensor":
        args["scene"] = dataclasses.replace(scene, camera=dataclasses.replace(
            scene.camera, position=scene.camera.position.clone()))
    elif name == "scene_static":
        args["scene"] = dataclasses.replace(scene, tre_rows=scene.tre_rows
                                            + 1)
    elif name == "settings":
        args["settings"] = dataclasses.replace(settings, trace_depth=3)
    elif name == "n":
        args["n"] = 128
    elif name == "seed":
        args["seed"] = 1
    elif name == "pixel_offset":
        args["pixel_offset"] = 128
    elif name == "key_salt":
        args["key_salt"] = 1
    elif name == "device":
        args["device"] = "cuda:1"
    elif name == "module_flag":
        ctx = mock.patch.object(binned, "EXPAND", 2)
    elif name == "wrapper":
        ctx = mock.patch.object(binned, "cull", binned.cull_plain)
    return args, ctx


KEY_INPUTS = ("scene_tensor", "scene_nested_tensor", "scene_static",
              "settings", "n", "seed", "pixel_offset", "key_salt", "device",
              "module_flag", "wrapper")


@pytest.mark.parametrize("name", KEY_INPUTS)
def test_frame_key_changes_with_each_input(name):
    scene, settings = _load("teapot", 16, 2)
    base, _ = _key_variant(None, scene, settings)
    k0 = frame_key(**base)
    assert frame_key(**base) == k0
    args, ctx = _key_variant(name, scene, settings)
    with ctx:
        k1 = frame_key(**args)
    assert k1 != k0
    hash(k1)
    # an in-place change keeps the key: the graph reads the new values
    scene.camera.position.add_(1.0)
    assert frame_key(**base) == k0


class _FakeGraph:
    def __init__(self, fn=None):
        self.replays, self.fn = 0, fn

    def replay(self):
        self.replays += 1
        if self.fn is not None:
            self.fn()


def test_replay_adds_the_captured_launches():
    """Frame.replay counts what the capture recorded, once a replay; the
    capture's own counts are taken out (counts, counts_since,
    restore_counts)."""
    kernels.reset_counts()
    kernels.LAUNCHES["scan"] = 5
    before = kernels.counts()
    kernels.LAUNCHES["cull"] += 3
    kernels.LAUNCHES["stream"] += 2
    kernels.FORMS["cull_k1"] = 3
    kernels.FORMS["stream_default"] = 2
    launches, forms = kernels.counts_since(before)
    assert launches == {"cull": 3, "stream": 2}
    assert forms == {"cull_k1": 3, "stream_default": 2}
    kernels.restore_counts(before)
    assert kernels.LAUNCHES["cull"] == 0 and kernels.LAUNCHES["scan"] == 5
    assert kernels.FORMS == {}
    graph = _FakeGraph()
    frame = Frame(graph, None, None, launches, forms, 0.0, 0, None)
    for _ in range(4):
        frame.replay()
    assert graph.replays == 4
    assert kernels.LAUNCHES == {**dict.fromkeys(kernels.LAUNCHES, 0),
                                "cull": 12, "stream": 8, "scan": 5}
    assert kernels.FORMS == {"cull_k1": 12, "stream_default": 8}
    kernels.reset_counts()


@pytest.mark.parametrize("n_iters", [1, 5])
def test_compiled_chunk_flow_on_a_cpu_graph(monkeypatch, n_iters):
    """render_chunk_compiled with a stand-in graph that runs the captured
    iteration on its own accumulator and iteration tensor: the warm-up
    iteration, the capture, the replays and the copies in and out give
    render_chunk_eager's bits, over two chunks (a cold and a cached
    graph)."""
    scene, settings = _load("teapot", 16, 3)
    captures = []

    def fake_capture(scene, settings, n, seed, pixel_offset, key_salt,
                     device):
        acc = zero_accum(settings, "cpu", n=n)
        it = torch.zeros((), dtype=torch.int64)
        graph = _FakeGraph(lambda: capturable_iteration(
            scene, settings, acc, it, seed, pixel_offset, key_salt))
        captures.append(graph)
        return Frame(graph, acc, it, {"cull": 2}, {}, 0.0, 0, scene)

    monkeypatch.setattr(wavefront, "capture_frame", fake_capture)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    wavefront.clear_frames()
    kernels.reset_counts()
    with torch.inference_mode():
        got = zero_accum(settings, "cpu")
        for start in (1, 1 + n_iters):
            wavefront.render_chunk_compiled(scene, settings, got, start,
                                            n_iters, seed=3)
        ref = wavefront.render_chunk_eager(scene, settings,
                                           zero_accum(settings, "cpu"), 1,
                                           2 * n_iters, 3)
    assert len(captures) == 1 and captures[0].replays == 2 * n_iters - 1
    assert _same(got, ref)
    assert kernels.LAUNCHES["cull"] == 2 * (2 * n_iters - 1)
    wavefront.clear_frames()
    kernels.reset_counts()


@pytest.mark.parametrize("pool,kept,drops", [(100, [3, 4], 2),
                                             (300, [4], 4)])
def test_frame_cache_drops_past_its_budget(monkeypatch, pool, kept, drops):
    """Past frame_budget the least recently used graphs are dropped, with a
    warning each, the newest never; a cached graph used again moves to the
    newest end (pools of 100: seed 1 is used again and outlives seed 2),
    and a dropped one is captured again (pools of 300: each drops the one
    before)."""
    def fake_capture(scene, settings, n, seed, *rest):
        return Frame(_FakeGraph(), zero_accum(settings, "cpu", n=n),
                     torch.zeros((), dtype=torch.int64), {}, {}, 0.0, pool,
                     seed)

    monkeypatch.setattr(wavefront, "frame_budget", lambda device: 250)
    monkeypatch.setattr(wavefront, "capture_frame", fake_capture)
    monkeypatch.setattr(wavefront, "capturable_iteration",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    scene, settings = _load("cornell", 2, 1)
    wavefront.clear_frames()
    acc = zero_accum(settings, "cpu")
    with pytest.warns(UserWarning, match="dropped a graph") as caught:
        for seed in (1, 2, 1, 3, 4):
            wavefront.render_chunk_compiled(scene, settings, acc, 1, 2, seed)
    assert [f.scene for f in wavefront.cached_frames()] == kept
    assert len(caught) == drops
    wavefront.clear_frames()


def _evt(key, us, count=1, device="cuda", annotation=False):
    return SimpleNamespace(key=key, self_device_time_total=us, count=count,
                           device_type=device, is_user_annotation=annotation)


def test_device_sums_leave_out_range_spans():
    """kernel_bench.device_sums, device_ms's sum, takes every kernel and
    memset once and leaves out the spins, host events and the ranges'
    device-side spans (utils/profiling.is_range_span)."""
    events = [_evt("cull_kernel", 400.0, 4), _evt("Memset (Device)", 40.0, 4),
              _evt("pt_mi_cull", 900.0, 4),
              _evt("my_range", 500.0, 4, annotation=True),
              _evt("spin_kernel", 80.0, 32), _evt("cudaLaunchKernel", 70.0,
                                                  8, device="cpu"),
              _evt("idle", 0.0, 1)]
    by_name, counts = device_sums(events, 4, "cuda")
    assert by_name == {"cull_kernel": 0.1, "Memset (Device)": 0.01}
    assert counts == {"cull_kernel": 4, "Memset (Device)": 4}


def test_port_launches_reads_the_kernels_by_name():
    """profiling.port_launches, what chip_smoke holds the launch counters
    to: each counted launch's own device kernel by its demangled name, on
    the card only; the walks' compactions, the deferring stream's support
    sort, library scans, ranges and host events are no launch."""
    events = [
        _evt("void cull_kernel<true, 3>(CullArgs)", 0.0, 12),
        _evt("void stream_kernel<false, true, false>(StreamArgs)", 1.0, 8),
        _evt("void support_kernel(SupportArgs)", 1.0, 8),
        _evt("void packet_kernel_compact(int const*, int, int*)", 1.0, 4),
        _evt("void packet_kernel_walk<true>(PacketArgs)", 1.0, 4),
        _evt("void wide_compact_kernel(Args, int)", 1.0, 2),
        _evt("void wide_push_kernel<false>(Args)", 1.0, 2),
        _evt("(anonymous namespace)::brute_kernel(BruteArgs)", 1.0, 1),
        _evt("(anonymous namespace)::pt_analytic_hit(int const*, int)", 1.0,
             6),
        _evt("void (anonymous namespace)::pt_shade_lanes<true, false, "
             "false, false, false>((anonymous namespace)::ShadeArgs)", 1.0,
             7),
        _evt("void (anonymous namespace)::pt_camera_paths<true, true, true, "
             "true, false>((anonymous namespace)::CameraArgs)", 1.0, 1),
        _evt("void cub::DeviceScanKernel<Policy>(int*)", 1.0, 3),
        _evt("void at::native::tensor_kernel_scan_innermost_dim<float>()",
             1.0, 3),
        _evt("pt_mi_cull", 9.0, 4, annotation=True),
        _evt("void wide_mask_kernel(Args)", 1.0, 5, device="cpu"),
    ]
    assert port_launches(events, "cuda") == {
        "cull": 12, "stream": 8, "packet": 4, "wide_push": 2,
        "wide_mask": 0, "brute": 1, "scan": 0, "analytic": 6, "shade": 7,
        "camera": 1}
    assert sorted(k for _, k in PORT_KERNELS) == sorted(kernels.LAUNCHES)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("bvh", BVHS)
def test_every_bvh_captures_without_a_host_read(bvh):
    """Each admitted --bvh captures under set_sync_debug_mode("error"), and
    4 compiled iterations equal the eager loop's bit for bit with the same
    kernel launches."""
    _need_cuda()
    scene, settings = _load("teapot", 64, 4, bvh, device="cuda")
    wavefront.clear_frames()
    with torch.inference_mode():
        assert eager_reason(settings, "cuda") is None
        frame = wavefront.capture_frame(scene, settings,
                                        settings.pixel_count, 0, 0, None,
                                        scene.device)
        assert frame.launches, "captured no kernel launch"
        assert frame.pool_bytes > 0, "the capture took no pool"
        kernels.reset_counts()
        eager = wavefront.render_chunk_eager(
            scene, settings, zero_accum(settings, "cuda"), 1, 4, 0, False)
        eager_counts = kernels.counts()
        kernels.reset_counts()
        got = wavefront.render_chunk(scene, settings,
                                     zero_accum(settings, "cuda"), 1, 4, 0)
        torch.cuda.synchronize()
    assert _same(got, eager)
    assert kernels.counts() == eager_counts
    wavefront.clear_frames()
    kernels.reset_counts()
