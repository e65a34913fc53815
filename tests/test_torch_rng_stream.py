"""PyTorch port, the per-iteration RNG stream API (ops/rng.py fast_state,
fast_fold, fast_uniforms, _box_muller, fast_normals, iteration_key,
bounce_key, Stream) against the JAX package's, and the distribution checks
of tests/test_rng.py on the port's streams, on the CPU.

Tolerances, and why:
  - states, keys and uniforms: bit for bit (integer arithmetic, and a
    uniform is an exact scaling of integer bits).
  - normals: within NORMAL_ULP units in the last place or NORMAL_ABS
    absolute, whichever is larger. Box-Muller's log, cos and sin (and the
    threefry path's erf_inv and log1p) may round differently in the two
    libraries; near a zero of cos or sin an ulp bound on the product means
    nothing, hence the absolute floor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import rng as jrng
from pathtracer_tpu_torch.ops import rng

torch.set_num_threads(2)

NORMAL_ULP = 4
NORMAL_ABS = 1e-6
# (seed, iteration, salt): salts -1 / -2 are raygen's depth channels
TRIPLES = [(0, 0, None), (0, 7, 0), (5, 9, 3), (123456, 1, -1),
           (2 ** 31 - 1, 1000, -2), (42, 2 ** 20 + 3, 2 ** 31 + 5)]


def _jsalt(salt):
    """A salt as the JAX package takes it: fold_in rejects negative Python
    ints and jnp rejects ints past int32, so a uint32 through _u32_salt."""
    return jnp.uint32(jrng._u32_salt(salt))


def _jax_stream(fast, seed, iteration, salt):
    return jrng.Stream.for_iteration(
        fast, seed, jnp.int32(iteration),
        salt=None if salt is None else _jsalt(salt))


def _key_data(k):
    return tuple(int(x) for x in jax.random.key_data(k))


def _assert_normals_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    err = np.abs(got - want)
    bad = (ulp > NORMAL_ULP) & (err > NORMAL_ABS)
    assert not bad.any(), (int(bad.sum()), float(err[bad].max()))


@pytest.mark.parametrize("seed,iteration,salt", TRIPLES)
def test_fast_hash_bit_equal(seed, iteration, salt):
    want = jrng.fast_state(seed, jnp.int32(iteration))
    got = rng.fast_state(seed, iteration, "cpu")
    assert got.dim() == 0 and got.dtype == torch.int64
    assert int(got) == int(np.asarray(want))
    if salt is not None:
        want = jrng.fast_fold(want, _jsalt(salt))
        got = rng.fast_fold(got, salt)
        assert int(got) == int(np.asarray(want))
    u = rng.fast_uniforms(got, 777, 5).numpy()
    assert u.dtype == np.float32 and u.shape == (777, 5)
    np.testing.assert_array_equal(
        u, np.asarray(jrng.fast_uniforms(want, 777, 5)))


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("seed,iteration,salt", TRIPLES)
def test_stream_uniforms_bit_equal(fast, seed, iteration, salt):
    js = _jax_stream(fast, seed, iteration, salt)
    ps = rng.Stream.for_iteration(fast, seed, iteration, salt=salt,
                                  device="cpu")
    for depth in (None, 0, 3, -1):
        j, p = (js, ps) if depth is None else (js.fold(_jsalt(depth)),
                                               ps.fold(depth))
        np.testing.assert_array_equal(p.uniforms(1000, 4).numpy(),
                                      np.asarray(j.uniforms(1000, 4)))


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("seed,iteration,salt", TRIPLES)
def test_stream_normals_close(fast, seed, iteration, salt):
    js = _jax_stream(fast, seed, iteration, salt)
    ps = rng.Stream.for_iteration(fast, seed, iteration, salt=salt,
                                  device="cpu")
    for m in (1, 2, 3):     # an odd m drops Box-Muller's last sine column
        _assert_normals_close(ps.normals(20_000, m).numpy(),
                              np.asarray(js.normals(20_000, m)))


def test_box_muller_matches_jax():
    """On the same uniforms, the zero clamp included."""
    u = np.random.default_rng(0).random((5000, 4), dtype=np.float32)
    u[:7, 0] = 0.0
    for m in (1, 3, 4):
        _assert_normals_close(
            rng._box_muller(torch.from_numpy(u), m).numpy(),
            np.asarray(jrng._box_muller(jnp.asarray(u), m)))


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1])
def test_iteration_and_bounce_keys_equal_jax(seed):
    for it in (0, 1, 4096):
        jk = jrng.iteration_key(seed, jnp.uint32(it))
        pk = rng.iteration_key(seed, it)
        assert pk == _key_data(jk)
        # a key may stand for the seed, as in the JAX package
        assert rng.iteration_key(rng.key(seed), it) == pk
        for depth in (0, 5, -1, -2):
            want = jrng.bounce_key(jk, jrng._u32_salt(depth))
            assert rng.bounce_key(pk, depth) == _key_data(want)


def test_stream_keeps_its_device():
    for fast in (True, False):
        s = rng.Stream.for_iteration(fast, 3, 4, device="cpu").fold(2)
        assert s.device == torch.device("cpu")
        assert s.uniforms(8, 2).device.type == "cpu"
        assert s.normals(8, 2).device.type == "cpu"


# -- tests/test_rng.py's checks, on the port's streams -----------------------

@pytest.mark.parametrize("fast", [True, False])
def test_uniforms_moments(fast):
    s = rng.Stream.for_iteration(fast, 0, 7, device="cpu")
    u = s.uniforms(100_000, 4).numpy()
    assert u.shape == (100_000, 4)
    assert (u >= 0).all() and (u < 1).all()
    np.testing.assert_allclose(u.mean(axis=0), 0.5, atol=0.01)
    np.testing.assert_allclose(u.var(axis=0), 1.0 / 12.0, atol=0.005)
    h, _ = np.histogram(u[:, 0], bins=16, range=(0, 1))
    chi2 = ((h - h.mean()) ** 2 / h.mean()).sum()
    assert chi2 < 60  # 15 dof; ~25 at p=0.05, 60 = far tail


@pytest.mark.parametrize("fast", [True, False])
def test_normals_moments(fast):
    s = rng.Stream.for_iteration(fast, 0, 3, device="cpu")
    z = s.normals(100_000, 2).numpy()
    np.testing.assert_allclose(z.mean(axis=0), 0.0, atol=0.02)
    np.testing.assert_allclose(z.var(axis=0), 1.0, atol=0.03)


@pytest.mark.parametrize("axis", ["iteration", "draw", "lane", "bounce"])
def test_fast_streams_decorrelated(axis):
    """Adjacent lanes / draws / bounces / iterations must not correlate."""
    s1 = rng.Stream.for_iteration(True, 0, 1, device="cpu")
    u1 = s1.uniforms(50_000, 2).numpy()
    if axis == "iteration":
        u2 = rng.Stream.for_iteration(True, 0, 2, device="cpu").uniforms(
            50_000, 2).numpy()
        a, b = u1[:, 0], u2[:, 0]
    elif axis == "draw":
        a, b = u1[:, 0], u1[:, 1]
    elif axis == "lane":
        a, b = u1[:-1, 0], u1[1:, 0]
    else:
        a = s1.fold(0).uniforms(50_000, 1).numpy()[:, 0]
        b = s1.fold(1).uniforms(50_000, 1).numpy()[:, 0]
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.02


def test_fast_deterministic():
    a = rng.fast_uniforms(rng.fast_state(5, 9, "cpu"), 1000, 3).numpy()
    b = rng.fast_uniforms(rng.fast_state(5, 9, "cpu"), 1000, 3).numpy()
    np.testing.assert_array_equal(a, b)
    c = rng.fast_uniforms(rng.fast_state(6, 9, "cpu"), 1000, 3).numpy()
    assert np.abs(a - c).max() > 1e-3


def test_fast_seed_zero_lane_zero_not_degenerate():
    """Guard the classic hash-RNG bug: all-zero inputs must still mix."""
    u = rng.fast_uniforms(rng.fast_state(0, 0, "cpu"), 4, 4).numpy()
    assert len(np.unique(u)) > 10
