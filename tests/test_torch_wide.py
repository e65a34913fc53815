"""PyTorch port, the 8-wide BVH walk (ops/wide.py) and the sorted packet
walk, against the JAX package on teapot tables carried over from it
(scene_from_jax_arrays), so both packages walk the very same forest.

On the CPU the wrapper runs the kernel's plain version, the per-ray walk of
csrc/wide.cu. The JAX kernels walk one stack per 128-ray packet; the port
walks each ray alone, ordering children by the ray's own direction sign
(the TPU used the packet's summed sign) and testing only the leaves its own
ray enters (the TPU tested a leaf for the whole packet). Either could change
a result only through an exact tie between two triangles or a box edge
grazed in float arithmetic; the tests count the lanes that differ and hold
that count at zero. Tolerances, and why:
  - hit set and material ids: exact;
  - t against JAX as its tests run it: within 1e-6 relative (XLA's CPU
    backend contracts the Moller-Trumbore multiply-adds into FMAs, the port
    rounds every operation); bit-equal against JAX with FMA contraction off
    (a subprocess with XLA_FLAGS=--xla_cpu_max_isa=AVX);
  - normals: rtol 1e-5, atol 1e-6 (tests/test_wide.py:52-58): JAX
    normalizes with lax.rsqrt, the port with 1/sqrt;
  - the port's push and mask stacks, with and without the cull, and the
    sorted and unsorted wrappers: bit for bit.
"""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu import load_scene as jax_load_scene
from pathtracer_tpu import render as jax_render
from pathtracer_tpu.ops import binned as j_binned
from pathtracer_tpu.ops.intersect import intersect_scene as j_intersect
from pathtracer_tpu.ops.wide import mesh_intersect_wide as j_wide
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch import load_scene, render
from pathtracer_tpu_torch.ops import binned, bvh_packet, wide
from pathtracer_tpu_torch.ops.intersect import intersect_scene
from pathtracer_tpu_torch.scene.fixtures import REPO_ROOT, scene_path
from pathtracer_tpu_torch.scene.loader import scene_from_jax_arrays
from pathtracer_tpu_torch.utils.vec import Vec3

torch.set_num_threads(2)

N = 2048
FLT_MAX = 3.402823466e38


def jax_leaves(tree, prefix=""):
    out = {}
    for k, v in tree._asdict().items():
        if hasattr(v, "_asdict"):
            out.update(jax_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def teapot():
    j_scene, j_set = jax_load_scene(scene_path("teapot"), wide_tables=True)
    return j_scene, j_set, scene_from_jax_arrays(jax_leaves(j_scene), "cpu")


def _rays(scene, seed, n=N):
    """Half the lanes random (as tests/test_wide.py makes them), half aimed
    at random points of the mesh's root box, so most of those hit; a random
    active mask and a bound that is finite on a third of the lanes."""
    r = np.random.default_rng(seed)
    o = r.uniform(-5, 5, size=(3, n)).astype(np.float32)
    d = r.normal(size=(3, n)).astype(np.float32)
    root = scene.mesh_roots[0]
    b = scene.bvh
    lo = np.array([b.min_x[root], b.min_y[root], b.min_z[root]], np.float32)
    hi = np.array([b.max_x[root], b.max_y[root], b.max_z[root]], np.float32)
    half = n // 2
    target = lo[:, None] + r.uniform(size=(3, half)) * (hi - lo)[:, None]
    o[:, :half] = target + r.normal(size=(3, half)) * 4.0
    d[:, :half] = target - o[:, :half]
    act = r.uniform(size=n) < 0.7
    tb = np.where(r.uniform(size=n) < 0.3, r.uniform(2, 12, size=n),
                  FLT_MAX).astype(np.float32)
    return o, d, act, tb


def _port_args(scene, o, d, act, tb):
    t = torch.from_numpy
    return (scene.nodes8_f, scene.nodes8_i, scene.tris8, scene.wide_root,
            *map(t, o), *map(t, d), t(act.astype(np.int32)), t(tb))


def _jax_wide(j_scene, o, d, act, tb, variant):
    t, n, m = j_wide(j_scene, JVec3(*map(jnp.asarray, o)),
                     JVec3(*map(jnp.asarray, d)), active=jnp.asarray(act),
                     t_bound=jnp.asarray(tb), interpret=True,
                     variant=variant)
    return np.asarray(t), np.stack([np.asarray(c) for c in n]), np.asarray(m)


def _assert_hits_match(port, ref, act, t_exact):
    """port: (t, nx, ny, nz, mat) tensors; ref: (t, [3, N] normals, mat).
    Returns the number of active lanes that hit."""
    tp, mp = port[0].numpy(), port[4].numpy()
    np_ = np.stack([c.numpy() for c in port[1:4]])
    tj, nj, mj = ref
    bad = ((tp > 0) != (tj > 0)) | (mp != mj)
    assert not bad[act].any(), (
        f"{int(bad[act].sum())} active lanes differ from JAX in hit or "
        f"material, first {np.nonzero(bad & act)[0][:5]}")
    if t_exact:
        np.testing.assert_array_equal(tp[act], tj[act])
    else:
        np.testing.assert_allclose(tp[act], tj[act], rtol=1e-6, atol=0)
    np.testing.assert_allclose(np_[:, act], nj[:, act], rtol=1e-5, atol=1e-6)
    return int((tj[act] > 0).sum())


@pytest.mark.parametrize("variant", wide.VARIANTS)
def test_wide_walk_plain_matches_jax(teapot, variant):
    """Against JAX's kernel of the same variant as its own tests run it
    (interpret mode, FMA contraction on)."""
    j_scene, _, scene = teapot
    o, d, act, tb = _rays(scene, 0)
    port = wide.wide_walk_plain(*_port_args(scene, o, d, act, tb),
                                variant=variant)
    ref = _jax_wide(j_scene, o, d, act, tb, variant)
    assert _assert_hits_match(port, ref, act, t_exact=False) > 300
    # inactive lanes: a miss with a zero normal, as the TPU kernel gives
    assert (port[0].numpy()[~act] == -1.0).all()
    assert (port[4].numpy()[~act] == -1).all()
    for c in port[1:4]:
        assert (c.numpy()[~act] == 0.0).all()


# The JAX package's wide kernel, both variants, on _rays(1) in interpret
# mode, in a process whose XLA may not use FMA instructions.
JAX_WITHOUT_FMA = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from pathtracer_tpu import load_scene
from pathtracer_tpu.ops.wide import mesh_intersect_wide
from pathtracer_tpu.utils.vec import Vec3
rays = np.load(sys.argv[1])
scene, _ = load_scene(sys.argv[2], wide_tables=True)
out = {}
for variant in ("push", "mask"):
    t, n, m = mesh_intersect_wide(
        scene, Vec3(*map(jnp.asarray, rays["o"])),
        Vec3(*map(jnp.asarray, rays["d"])), active=jnp.asarray(rays["act"]),
        t_bound=jnp.asarray(rays["tb"]), interpret=True, variant=variant)
    out[variant + "_t"] = np.asarray(t)
    out[variant + "_n"] = np.stack([np.asarray(c) for c in n])
    out[variant + "_m"] = np.asarray(m)
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def jax_without_fma(teapot, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wide_without_fma")
    o, d, act, tb = _rays(teapot[2], 1)
    np.savez(tmp / "rays.npz", o=o, d=d, act=act, tb=tb)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_max_isa=AVX").strip()
    res = subprocess.run(
        [sys.executable, "-c", JAX_WITHOUT_FMA, str(tmp / "rays.npz"),
         scene_path("teapot"), str(tmp / "out.npz")],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = np.load(tmp / "out.npz")
    return {k: out[k] for k in out.files}


@pytest.mark.parametrize("variant", wide.VARIANTS)
def test_wide_walk_bit_equal_to_jax_without_fma(teapot, jax_without_fma,
                                                variant):
    _, _, scene = teapot
    o, d, act, tb = _rays(scene, 1)
    port = wide.wide_walk_plain(*_port_args(scene, o, d, act, tb),
                                variant=variant)
    ref = tuple(jax_without_fma[f"{variant}_{k}"] for k in ("t", "n", "m"))
    assert _assert_hits_match(port, ref, act, t_exact=True) > 300


def test_push_mask_and_cull_agree_bit_for_bit(teapot):
    """The two stack disciplines visit the same children in the same order,
    and the push cull skips only entries that cannot hold a closer hit."""
    _, _, scene = teapot
    o, d, act, tb = _rays(scene, 2)
    args = _port_args(scene, o, d, act, tb)
    counts = {}
    ref = wide.wide_walk(*args, variant="push")
    for kw in ({"variant": "mask"}, {"variant": "push", "cull": True}):
        for a, b in zip(ref, wide.wide_walk(*args, **kw)):
            assert torch.equal(a, b), kw
    push_counts, mask_counts = {}, {}
    wide.wide_walk_plain(*args, variant="push", counts=push_counts)
    wide.wide_walk_plain(*args, variant="mask", counts=mask_counts)
    wide.wide_walk_plain(*args, variant="push", cull=True, counts=counts)
    assert push_counts == mask_counts
    assert counts["tri_tests"] <= push_counts["tri_tests"]


def test_wide_respects_t_bound(teapot):
    """Hits at or beyond the per-lane bound are misses, and bounded results
    agree with unbounded ones where those hit closer (tests/test_wide.py
    :61-81)."""
    _, _, scene = teapot
    o, d, act, _ = _rays(scene, 3)
    free = wide.wide_walk(*_port_args(scene, o, d, act,
                                      np.full(N, FLT_MAX, np.float32)))
    bounded = wide.wide_walk(*_port_args(scene, o, d, act,
                                         np.full(N, 0.85, np.float32)))
    tf, tb_ = free[0].numpy()[act], bounded[0].numpy()[act]
    mf, mb = free[4].numpy()[act], bounded[4].numpy()[act]
    close = (tf > 0) & (tf < 0.85)
    assert close.sum() > 100 and (tf >= 0.85).sum() > 100
    np.testing.assert_array_equal(tb_[close], tf[close])
    np.testing.assert_array_equal(mb[close], mf[close])
    assert (tb_[~close] == -1.0).all() and (mb[~close] == -1).all()


@pytest.mark.parametrize("impl", ["wide", "wide_nosort", "sorted"])
def test_intersect_scene_matches_jax(teapot, impl):
    """The scene-level closest hit (six boxes and the mesh) through the
    same bvh_impl in both packages."""
    j_scene, j_set, scene = teapot
    o, d, act, _ = _rays(scene, 4)
    tj, nj, mj = j_intersect(j_scene, j_set.geom_types,
                             JVec3(*map(jnp.asarray, o)),
                             JVec3(*map(jnp.asarray, d)), bvh_impl=impl,
                             active=jnp.asarray(act))
    tp, np_, mp = intersect_scene(scene, j_set.geom_types,
                                  Vec3(*map(torch.from_numpy, o)),
                                  Vec3(*map(torch.from_numpy, d)),
                                  bvh_impl=impl,
                                  active=torch.from_numpy(act))
    port = (tp, *np_, mp)
    ref = (np.asarray(tj), np.stack([np.asarray(c) for c in nj]),
           np.asarray(mj))
    assert _assert_hits_match(port, ref, act, t_exact=False) > 500


def test_sorted_wrappers_equal_unsorted(teapot):
    """The coherence sort changes which lanes walk side by side, never a
    lane's result."""
    _, _, scene = teapot
    o, d, act, tb = _rays(scene, 5)
    args = (Vec3(*map(torch.from_numpy, o)), Vec3(*map(torch.from_numpy, d)))
    kw = dict(active=torch.from_numpy(act), t_bound=torch.from_numpy(tb))
    root = scene.mesh_roots[0]
    pairs = [
        (wide.mesh_intersect_wide_sorted(scene, scene.mesh_roots, *args,
                                         **kw),
         wide.mesh_intersect_wide(scene, *args, **kw)),
        (wide.mesh_intersect_wide_sorted(scene, scene.mesh_roots, *args,
                                         sort_chunk=256, **kw),
         wide.mesh_intersect_wide(scene, *args, **kw)),
        (bvh_packet.mesh_intersect_packet_sorted(scene, root, *args,
                                                 sort_chunk=384, **kw),
         bvh_packet.mesh_intersect_packet(scene, root, *args, **kw)),
    ]
    for got, ref in pairs:
        assert int((ref[0] > 0).sum()) > 300
        assert torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2])
        for a, b in zip(got[1], ref[1]):
            assert torch.equal(a, b)


def test_binned_wide_fallback_contract(teapot):
    """fallback_impl="wide" keeps the true-closest-hit contract: the same
    hit set, materials and normals as the packet fallback, as
    tests/test_binned.py:172-196 holds them. Both finishes run the same
    triangle test on the same triangle data, so t is bit-equal here."""
    _, _, scene = teapot
    o, d, act, tb = _rays(scene, 6)
    args = (scene, scene.mesh_roots, Vec3(*map(torch.from_numpy, o)),
            Vec3(*map(torch.from_numpy, d)))
    kw = dict(active=torch.from_numpy(act), t_bound=torch.from_numpy(tb))
    ref = binned.mesh_intersect_binned(*args, fallback_impl="packet", **kw)
    got = binned.mesh_intersect_binned(*args, fallback_impl="wide", **kw)
    assert int((ref[0][torch.from_numpy(act)] > 0).sum()) > 300
    np.testing.assert_array_equal(got[0].numpy()[act], ref[0].numpy()[act])
    np.testing.assert_array_equal(got[2].numpy()[act], ref[2].numpy()[act])
    for a, b in zip(got[1], ref[1]):
        np.testing.assert_allclose(a.numpy()[act], b.numpy()[act],
                                   rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        binned.mesh_intersect_binned(*args, fallback_impl="jnp", **kw)
    # the module default is the packet walk, as in the JAX package
    assert binned.FALLBACK_IMPL == j_binned.FALLBACK_IMPL == "packet"


@pytest.mark.parametrize("impl", ["wide", "wide_nosort", "fallback"])
def test_wide_needs_its_tables(impl):
    """A mesh scene loaded without the wide tables holds a placeholder
    forest: every path to the 8-wide walk rejects it instead of missing
    every triangle. A meshless scene has nothing to reject."""
    scene, settings = load_scene(scene_path("teapot"), "cpu")
    assert not scene.wide_built
    o = Vec3(*(torch.zeros(4) for _ in range(3)))
    d = Vec3(*(torch.ones(4) for _ in range(3)))
    with pytest.raises(ValueError, match="wide_tables"):
        if impl == "fallback":
            binned.mesh_intersect_binned(scene, scene.mesh_roots, o, d,
                                         fallback_impl="wide")
        else:
            intersect_scene(scene, settings.geom_types, o, d, bvh_impl=impl)
    c_scene, c_set = load_scene(scene_path("cornell"), "cpu")
    t, _, _ = intersect_scene(c_scene, c_set.geom_types, o, d,
                              bvh_impl="wide" if impl == "fallback" else impl)
    assert t.shape == (4,)


def test_wide_render_matches_jax():
    """Teapot 32x32 d3, one iteration, bvh_impl="wide" in both packages,
    same seed: under 1% of pixels may differ by more than 1e-4 (the rule of
    tests/test_torch_engine.py)."""
    overrides = {"RES": [32, 32], "DEPTH": 3}
    j_scene, j_set = jax_load_scene(scene_path("teapot"),
                                    overrides=overrides, wide_tables=True)
    p_scene, p_set = load_scene(scene_path("teapot"), "cpu",
                                overrides=overrides, wide_tables=True)
    img_j = np.asarray(jax_render(
        j_scene, dataclasses.replace(j_set, bvh_impl="wide"), iterations=1,
        seed=0))
    img_p = render(p_scene, dataclasses.replace(p_set, bvh_impl="wide"),
                   iterations=1, seed=0)
    assert np.isfinite(img_p).all() and img_p.max() > 0
    differs = np.abs(img_p - img_j).max(axis=-1) > 1e-4
    assert differs.mean() < 0.01, differs.mean()
