"""PyTorch port, the threefry RNG path (RenderSettings.fast_rng=False): the
hand-ported threefry2x32 streams against jax.random, and the engine modes
that draw from them against the JAX package, on the CPU.

Tolerances, and why:
  - keys, fold_in, random bits and uniforms: bit for bit (integer
    arithmetic, and the uniform is a bit pattern minus 1).
  - normals: within NORMAL_ULP units in the last place of
    jax.random.normal. The port evaluates XLA's float32 erf_inv polynomial
    step by step; XLA's CPU backend contracts its multiply-adds into FMAs,
    and its log1p and torch's may round differently. Measured: 3 ulp at
    most, on about 5% of draws (200,000 draws).
  - images without jitter: bit for bit (no normal is drawn, and the fast
    path's images are already bit-equal to JAX's at these sizes).
  - images with jitter: the camera rays differ by the normals' few ulps, so
    a path may part where a discrete decision flips; as the other engine
    tests, under JITTER_SHARE of pixels may differ by more than 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.prng import threefry_2x32 as jax_threefry_2x32

from pathtracer_tpu import load_scene as jax_load_scene
from pathtracer_tpu import render as jax_render
from pathtracer_tpu.ops import rng as jrng
from pathtracer_tpu.utils import checkpoint as jcheckpoint
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch import load_scene, render
from pathtracer_tpu_torch.engine.wavefront import (ray_survival,
                                                   render_iteration,
                                                   zero_accum)
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

NORMAL_ULP = 4        # normals vs jax.random.normal (see above)
JITTER_SHARE = 0.01   # pixels off by more than 1e-4, with jitter


def _key_data(k):
    return tuple(int(x) for x in jax.random.key_data(k))


def _ulp(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_threefry2x32_equals_jax():
    r = np.random.default_rng(0)
    for _ in range(4):
        k1, k2 = (int(x) for x in r.integers(0, 2 ** 32, 2))
        count = r.integers(0, 2 ** 32, 2 * 1001).astype(np.uint32)
        want = np.asarray(jax_threefry_2x32(
            (jnp.uint32(k1), jnp.uint32(k2)), jnp.asarray(count)))
        x = torch.from_numpy(count.astype(np.int64))
        y1, y2 = rng.threefry2x32(k1, k2, x[:1001], x[1001:])
        got = torch.cat([y1, y2]).numpy().astype(np.uint32)
        np.testing.assert_array_equal(got, want)
        # the same on host ints, as keys are folded
        assert rng.threefry2x32(k1, k2, int(count[0]), int(count[1001])) == (
            int(want[0]), int(want[1001]))


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1])
def test_key_and_fold_in_equal_jax(seed):
    k = jax.random.key(seed)
    assert rng.key(seed) == _key_data(k)
    for data in (0, 1, 3, 4096, 2 ** 31 + 5, 2 ** 32 - 1, -1, -2):
        j = jax.random.fold_in(k, data & 0xFFFFFFFF)
        assert rng.fold_in(rng.key(seed), data) == _key_data(j), data
    # folds chain as the engine chains them: iteration, salt, depth, tile
    j = k
    p = rng.key(seed)
    for data in (12, 3, 0xFFFFFFFE, 40):
        j, p = jax.random.fold_in(j, data), rng.fold_in(p, data)
        assert p == _key_data(j)


@pytest.mark.parametrize("n,m", [(1001, 4), (999, 5), (4097, 2)])
def test_uniforms_equal_jax_bit_for_bit(n, m):
    for seed, fold in ((0, 1), (5, 0xFFFFFFFF)):
        j_key = jax.random.fold_in(jax.random.key(seed), fold)
        want = np.asarray(jax.random.uniform(j_key, (n, m), jnp.float32))
        got = rng.uniforms(rng.fold_in(rng.key(seed), fold), n, m, "cpu")
        assert got.shape == (n, m) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))


def test_normals_within_ulp_of_jax():
    j_key = jax.random.fold_in(jax.random.key(3), 11)
    want = np.asarray(jax.random.normal(j_key, (200001, 1), jnp.float32))
    got = rng.normals(rng.fold_in(rng.key(3), 11), 200001, 1, "cpu").numpy()
    ulp = _ulp(got, want)
    assert ulp.max() <= NORMAL_ULP, ulp.max()
    assert (ulp == 0).mean() > 0.9
    # erf_inv at the ends of its domain
    x = torch.tensor([-1.0, -0.99999994, 0.0, 0.5, 0.99999994, 1.0])
    ref = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x.numpy())))
    got = rng.erf_inv(x).numpy()
    assert np.isneginf(got[0]) and np.isposinf(got[-1])
    assert _ulp(got[1:-1], ref[1:-1]).max() <= NORMAL_ULP


@pytest.mark.parametrize("key_salt", [None, 3])
@pytest.mark.parametrize("depth", [-2, -1, 0, 3])
def test_iteration_rng_threefry_equals_jax(depth, key_salt):
    """Draws of IterationRng(fast=False) by lane row: uniforms bit for bit,
    with and without a key salt and a per-draw salt; normals (raygen's
    jitter, depth -1) within NORMAL_ULP."""
    n, seed, iteration = 777, 4, 9
    lanes = torch.arange(n)
    j = jrng.IterationRng(False, seed, jnp.int32(iteration),
                          key_salt=key_salt)
    p = rng.IterationRng(seed, iteration, fast=False, key_salt=key_salt)
    for salt in (None, 5):
        want = j.uniforms(depth, jnp.arange(n), 4, salt=salt)
        got = p.uniforms(depth, lanes, 4, salt=salt)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          np.asarray(b).view(np.int32))
    if depth == -1:
        want = j.normals(depth, jnp.arange(n), 2)
        for a, b in zip(p.normals(depth, lanes, 2), want):
            assert _ulp(a.numpy(), np.asarray(b)).max() <= NORMAL_ULP
    # the fast path ignores both salts
    f = rng.IterationRng(seed, iteration, fast=True, key_salt=key_salt)
    for a, b in zip(f.uniforms(depth, lanes, 4, salt=5),
                    rng.IterationRng(seed, iteration).uniforms(depth, lanes,
                                                               4)):
        assert torch.equal(a, b)


MODES = {"masked": {}, "sorted": {"sort_materials": True},
         "tiled": {"compact": True, "compact_tile": 256}}


@pytest.fixture(scope="module")
def cornell():
    overrides = {"RES": [32, 32]}
    return (load_scene(scene_path("cornell"), "cpu", overrides=overrides),
            jax_load_scene(scene_path("cornell"), overrides=overrides))


@pytest.mark.parametrize("mode", list(MODES))
def test_threefry_render_equals_jax_without_jitter(cornell, mode):
    """Cornell 32x32 d8, two iterations through each engine mode with
    fast_rng=False and no jitter: the JAX package's image bit for bit (the
    sorted mode draws for its permuted lanes, the tiled mode salts each
    tile's draws with its index)."""
    (p_scene, p_set), (j_scene, j_set) = cornell
    kw = dict(MODES[mode], fast_rng=False, jitter=False)
    img_p = render(p_scene, dataclasses.replace(p_set, **kw), iterations=2)
    img_j = np.asarray(jax_render(j_scene, dataclasses.replace(j_set, **kw),
                                  iterations=2, chunk=2))
    assert np.isfinite(img_p).all() and img_p.max() > 0
    np.testing.assert_array_equal(img_p.view(np.int32), img_j.view(np.int32))
    # another stream than the fast path's
    fast = render(p_scene, dataclasses.replace(p_set, **MODES[mode],
                                               jitter=False), iterations=2)
    assert not np.array_equal(fast, img_p)


def test_threefry_iteration_with_jitter_and_key_salt_matches_jax(cornell):
    """render_iteration with jitter (normals) and a shard's key salt: under
    JITTER_SHARE of pixels off JAX's by more than 1e-4; ray_survival's
    counts with the same stream equal JAX's."""
    from pathtracer_tpu.engine.wavefront import (
        ray_survival as jax_ray_survival,
        render_iteration as jax_render_iteration)
    (p_scene, p_set), (j_scene, j_set) = cornell
    p_set = dataclasses.replace(p_set, fast_rng=False)
    j_set = dataclasses.replace(j_set, fast_rng=False)
    n = p_set.pixel_count
    got = render_iteration(p_scene, p_set, zero_accum(p_set, "cpu"), 3,
                           seed=2, early_exit=True, key_salt=1)
    want = jax_render_iteration(j_scene, j_set, JVec3.zeros((n,)),
                                jnp.int32(3), seed=2, early_exit=True,
                                key_salt=1)
    a = np.stack([c.numpy() for c in got], -1)
    b = np.stack([np.asarray(c) for c in want], -1)
    share = float((np.abs(a - b).max(axis=-1) > 1e-4).mean())
    assert share < JITTER_SHARE, share
    np.testing.assert_array_equal(
        ray_survival(p_scene, p_set, 3, seed=2).numpy(),
        np.asarray(jax_ray_survival(j_scene, j_set, jnp.int32(3), seed=2)))


def test_threefry_checkpoint_crosses_between_the_packages(cornell, tmp_path):
    """The fingerprint carries fast_rng: a threefry checkpoint written by
    either package loads in the other with threefry settings, and is
    refused with the fast path's."""
    (p_scene, p_set), (j_scene, j_set) = cornell
    p_set = dataclasses.replace(p_set, fast_rng=False)
    j_set = dataclasses.replace(j_set, fast_rng=False)
    j_acc = jnp.full((3, p_set.pixel_count), 0.25, jnp.float32)
    j_path = jcheckpoint.save_checkpoint(str(tmp_path / "j.npz"),
                                         JVec3(*j_acc), 3, j_set, seed=2)
    accum, done, seed = checkpoint.load_checkpoint(j_path, p_set, "cpu")
    assert (done, seed) == (3, 2) and float(accum.x.sum()) == 0.25 * 1024
    with pytest.raises(ValueError):
        checkpoint.load_checkpoint(
            j_path, dataclasses.replace(p_set, fast_rng=True), "cpu")
    p_path = checkpoint.save_checkpoint(str(tmp_path / "p.npz"), accum, 3,
                                        p_set, seed=2)
    j_accum, done, _ = jcheckpoint.load_checkpoint(p_path, j_set)
    assert done == 3
    np.testing.assert_array_equal(np.asarray(j_accum.x), accum.x.numpy())
    with pytest.raises(ValueError):
        jcheckpoint.load_checkpoint(
            p_path, dataclasses.replace(j_set, fast_rng=True))
