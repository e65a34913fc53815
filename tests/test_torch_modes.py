"""PyTorch port, the engine modes: the material-sorted and tiled wavefront
modes, ray_survival, the persistent engine and checkpoints, each against
the JAX package (and against the port's masked mode) on the CPU.

Cornell 32x32 d4 unless a test says otherwise. The RNG streams are
bit-identical and keyed by pixel, so every mode samples the same paths: an
image may only part where a few-ulp difference (XLA's CPU backend contracts
multiply-adds) flips a discrete decision, or where floats are summed in
another order. Against JAX the criterion is the share of pixels off by more
than 1e-4 (under 1%); between the port's own modes, and against the JAX
persistent engine, rtol and atol 1e-5 (the JAX package's own
test_sorted_mode_bitexact_vs_masked). Integer outputs must be equal.
Measured on the CPU at these sizes: every image was bit-identical.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu import load_scene as jax_load_scene
from pathtracer_tpu import render as jax_render
from pathtracer_tpu.engine import persistent as jpersistent
from pathtracer_tpu.engine.wavefront import ray_survival as jax_ray_survival
from pathtracer_tpu.ops import rng as jrng
from pathtracer_tpu.utils import checkpoint as jcheckpoint
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch import load_scene, render, render_persistent
from pathtracer_tpu_torch.engine import persistent
from pathtracer_tpu_torch.engine.wavefront import (ray_survival,
                                                   render_chunk, zero_accum)
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _scenes(name="cornell", res=32, depth=4):
    overrides = {"RES": [res, res], "DEPTH": depth}
    return (load_scene(scene_path(name), "cpu", overrides=overrides),
            jax_load_scene(scene_path(name), overrides=overrides))


@pytest.fixture(scope="module")
def cornell():
    return _scenes()


def _share_off(a, b):
    return float((np.abs(a - b).max(axis=-1) > 1e-4).mean())


@pytest.mark.parametrize("mode", ["sorted", "tiled"])
def test_mode_matches_jax_and_masked(cornell, mode):
    (p_scene, p_set), (j_scene, j_set) = cornell
    kw = ({"sort_materials": True} if mode == "sorted"
          else {"compact": True, "compact_tile": 256})
    img_p = render(p_scene, dataclasses.replace(p_set, **kw), iterations=3)
    img_j = np.asarray(jax_render(j_scene, dataclasses.replace(j_set, **kw),
                                  iterations=3, chunk=3))
    assert np.isfinite(img_p).all() and img_p.max() > 0
    assert _share_off(img_p, img_j) < 0.01
    img_m = render(p_scene, p_set, iterations=3)
    np.testing.assert_allclose(img_p, img_m, **TOL)


@pytest.mark.parametrize("mode", ["sorted", "tiled"])
def test_mode_matches_masked_on_a_pool_of_partial_columns(mode):
    """50x50 = 2,500 lanes, not a multiple of 128: the sorted mode takes the
    full-pool multisort and its unsort; the tiled mode runs 10 tiles of
    250."""
    scene, settings = load_scene(scene_path("cornell"), "cpu",
                                 overrides={"RES": [50, 50], "DEPTH": 4})
    assert settings.pixel_count % 128 != 0
    kw = ({"sort_materials": True} if mode == "sorted"
          else {"compact": True, "compact_tile": 250})
    img = render(scene, dataclasses.replace(settings, **kw), iterations=2)
    np.testing.assert_allclose(img, render(scene, settings, iterations=2),
                               **TOL)


def test_tiled_mode_skips_dead_tiles():
    """A tile whose lanes are all dead never reaches the intersector."""
    from pathtracer_tpu_torch.engine import wavefront

    scene, settings = load_scene(scene_path("cornell"), "cpu",
                                 overrides={"RES": [32, 32], "DEPTH": 3})
    irng = rng.IterationRng(0, 1)
    state = wavefront.generate_paths(scene, settings, irng)
    rb = state.remaining_bounces.clone()
    rb[256:512] = -1                                      # tile 1 dead
    state = state._replace(remaining_bounces=rb)
    sizes = []
    real = wavefront.intersect_scene

    def counting(scene, geom_types, origin, direction, **kw):
        sizes.append(origin.x.shape[0])
        return real(scene, geom_types, origin, direction, **kw)

    image = zero_accum(settings, "cpu")
    try:
        wavefront.intersect_scene = counting
        out = wavefront.bounce_step_tiled(scene, settings, irng, 0, state,
                                          image, 256)
    finally:
        wavefront.intersect_scene = real
    assert sizes == [256, 256, 256]
    assert torch.equal(out.remaining_bounces[256:512], rb[256:512])
    assert torch.equal(out.pixel, state.pixel)


def test_non_dividing_tile_warns_and_equals_masked(cornell):
    (scene, settings), _ = cornell
    tiled = dataclasses.replace(settings, compact=True, compact_tile=300)
    with pytest.warns(UserWarning, match="not divisible"):
        img = render(scene, tiled, iterations=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        img_m = render(scene, settings, iterations=2)
    np.testing.assert_array_equal(img, img_m)


def test_ray_survival_equals_jax():
    (p_scene, p_set), (j_scene, j_set) = _scenes(depth=6)
    counts = ray_survival(p_scene, p_set, 3, seed=2)
    assert counts.dtype == torch.int32
    assert counts.shape == (p_set.trace_depth + 1,)
    want = np.asarray(jax_ray_survival(j_scene, j_set, jnp.int32(3), seed=2))
    np.testing.assert_array_equal(counts.numpy(), want)
    assert counts[0] == p_set.pixel_count


@pytest.mark.parametrize("rr_start", [0, 2])
def test_persistent_matches_jax_and_masked(cornell, rr_start):
    """rr_start=2 runs Russian roulette on per-lane depths (shade's tensor
    rr_depth)."""
    (p_scene, p_set), (j_scene, j_set) = cornell
    p_set = dataclasses.replace(p_set, rr_start=rr_start)
    j_set = dataclasses.replace(j_set, rr_start=rr_start)
    img_p = render_persistent(p_scene, p_set, iterations=12, chunk=6)
    img_j = np.asarray(jpersistent.render_persistent(j_scene, j_set,
                                                     iterations=12, chunk=6))
    np.testing.assert_allclose(img_p, img_j, **TOL)
    np.testing.assert_allclose(img_p, render(p_scene, p_set, iterations=12),
                               **TOL)


def test_persistent_chunks_equal_one_chunk(cornell):
    (scene, settings), _ = cornell
    stride = persistent.pixel_stride(settings.pixel_count)
    one = persistent.render_persistent_chunk(
        scene, settings, persistent.fresh_lanes(settings, "cpu"), 8, 0,
        stride)
    two = persistent.fresh_lanes(settings, "cpu")
    two = persistent.render_persistent_chunk(scene, settings, two, 3, 0,
                                             stride)
    assert two.flushed == 3
    two = persistent.render_persistent_chunk(scene, settings, two, 8, 0,
                                             stride)
    assert one.flushed == two.flushed == 8
    for a, b in zip(one.accum, two.accum):
        torch.testing.assert_close(a, b, **TOL)


def test_persistent_teapot_through_the_binned_intersector():
    scene, settings = load_scene(scene_path("teapot"), "cpu",
                                 overrides={"RES": [16, 16], "DEPTH": 3})
    assert settings.bvh_impl == "binned"
    img = render_persistent(scene, settings, iterations=2)
    assert np.isfinite(img).all() and img.max() > 0
    np.testing.assert_allclose(img, render(scene, settings, iterations=2),
                               **TOL)


def test_schedule_wraps_as_jax_int32():
    """Rounds 5,000-6,000 at 800x800, where the JAX package's int32 product
    assign * stride wraps: the lane's pixel and the flush shift must be
    JAX's."""
    n = 640000
    stride = persistent.pixel_stride(n)
    assert stride == jpersistent.pixel_stride(n)
    assign = np.arange(5000, 6001, dtype=np.int32)
    lanes = np.random.default_rng(0).integers(0, n, assign.shape[0]
                                              ).astype(np.int32)
    j_assign = jnp.asarray(assign)
    j_prod = j_assign * jnp.int32(stride)
    assert (np.asarray(j_prod) < 0).any()                 # it does wrap
    want = (jnp.asarray(lanes) + j_prod % jnp.int32(n)) % jnp.int32(n)
    got = persistent.schedule_pixel(torch.from_numpy(lanes).long(),
                                    torch.from_numpy(assign).long(), stride,
                                    n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    shifts = [persistent.flush_shift(int(r), stride, n) for r in assign]
    np.testing.assert_array_equal(shifts, np.asarray(j_prod % jnp.int32(n)))


def test_decision_state_with_per_lane_sample_and_depth():
    r = np.random.default_rng(1)
    n = 4096
    sample = r.integers(-3, 10000, n).astype(np.int32)
    depth = r.integers(-2, 12, n).astype(np.int32)
    pixel = r.integers(0, 640000, n).astype(np.int32)
    got = rng.decision_state(7, torch.from_numpy(sample),
                             torch.from_numpy(depth), torch.from_numpy(pixel))
    want = jrng.decision_state(7, jnp.asarray(sample), jnp.asarray(depth),
                               jnp.asarray(pixel))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


def test_checkpoint_round_trip_and_resume(cornell, tmp_path):
    (scene, settings), _ = cornell
    full = render_chunk(scene, settings, zero_accum(settings, "cpu"), 1, 6)
    half = render_chunk(scene, settings, zero_accum(settings, "cpu"), 1, 3)
    path = checkpoint.save_checkpoint(str(tmp_path / "ck.npz"), half, 3,
                                      settings, seed=0)
    accum, done, seed = checkpoint.load_checkpoint(path, settings, "cpu")
    assert (done, seed) == (3, 0)
    for a, b in zip(accum, half):
        assert torch.equal(a, b)
    img = render(scene, settings, iterations=3, accum=accum,
                 start_iteration=done, seed=seed)
    for a, b in zip(accum, full):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(img, render(scene, settings, iterations=6),
                               rtol=1e-6, atol=1e-6)
    other = dataclasses.replace(settings, trace_depth=5)
    with pytest.raises(ValueError, match="mismatch"):
        checkpoint.load_checkpoint(path, other, "cpu")


def test_persistent_resume_from_checkpoint(cornell, tmp_path):
    (scene, settings), _ = cornell
    stride = persistent.pixel_stride(settings.pixel_count)
    full = persistent.render_persistent_chunk(
        scene, settings, persistent.fresh_lanes(settings, "cpu"), 6, 0,
        stride)
    half = persistent.render_persistent_chunk(
        scene, settings, persistent.fresh_lanes(settings, "cpu"), 3, 0,
        stride)
    path = checkpoint.save_checkpoint(str(tmp_path / "ck.npz"), half.accum,
                                      3, settings)
    accum, done, seed = checkpoint.load_checkpoint(path, settings, "cpu")
    resumed = persistent.render_persistent_chunk(
        scene, settings, persistent.fresh_lanes(settings, "cpu", accum,
                                                done), 6, seed, stride)
    for a, b in zip(full.accum, resumed.accum):
        assert torch.equal(a, b)


def test_checkpoints_cross_between_the_packages(cornell, tmp_path):
    (p_scene, p_set), (j_scene, j_set) = cornell
    j_acc = jnp.full((3, p_set.pixel_count), 0.5, jnp.float32)
    j_path = jcheckpoint.save_checkpoint(str(tmp_path / "j.npz"),
                                         JVec3(*j_acc), 4, j_set, seed=9)
    accum, done, seed = checkpoint.load_checkpoint(j_path, p_set, "cpu")
    assert (done, seed) == (4, 9) and float(accum.y.sum()) == 0.5 * 1024

    p_acc = zero_accum(p_set, "cpu")
    p_acc.z.add_(torch.arange(p_set.pixel_count, dtype=torch.float32))
    p_path = checkpoint.save_checkpoint(str(tmp_path / "p.npz"), p_acc, 2,
                                        p_set, seed=1)
    j_accum, done, seed = jcheckpoint.load_checkpoint(p_path, j_set)
    assert (done, seed) == (2, 1)
    np.testing.assert_array_equal(np.asarray(j_accum.z), p_acc.z.numpy())


def test_command_line_persistent_engine_and_checkpoint(tmp_path, capsys):
    from pathtracer_tpu_torch.__main__ import main

    out, ck = tmp_path / "c.png", tmp_path / "ck.npz"
    args = [scene_path("cornell"), "--res", "16", "--spp", "2", "--depth",
            "3", "--out", str(out), "--device", "cpu", "--engine",
            "persistent", "--checkpoint", str(ck)]
    main(args)
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    text = capsys.readouterr().out
    assert "(persistent engine)" in text and "(2 spp)" in text
    main(args)                                   # resumes: 2 more samples
    text = capsys.readouterr().out
    assert "resuming from" in text and "(4 spp)" in text
