"""PyTorch port, the sharded ray pool (parallel/sharding.py) against the
JAX package's shard_map path on the conftest's 8 virtual CPU devices, and
against the port's own single-pool render.

The RNG is keyed on global pixel ids and each pixel is summed only in its
shard, so a sharded image must equal the single-pool image bit for bit,
and the JAX sharded image as the single-device images agree (measured at
these sizes: bit for bit, atol 0). The persistent engine sums in another
order than the masked one: rtol and atol 1e-5 (tests/test_torch_modes.py).
Work counts are integers: equal. The albedo step sums its gradient over
shards in another order than the JAX psum: atol 1e-6 in loss and albedo
(tests/test_torch_grad.py's bound for the fit steps). Scenes are the
checked-in ones, seed 0.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu import load_scene as jax_load_scene
from pathtracer_tpu.engine.wavefront import lanes_to_image as j_lanes_to_image
from pathtracer_tpu.engine.wavefront import zero_accum as j_zero_accum
from pathtracer_tpu.parallel import sharding as jsh
from pathtracer_tpu.scene.types import _granule as j_granule
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch import load_scene, render
from pathtracer_tpu_torch.engine.wavefront import (generate_paths,
                                                   lanes_to_image,
                                                   render_chunk, zero_accum)
from pathtracer_tpu_torch.ops.intersect import intersect_scene
from pathtracer_tpu_torch.ops.rng import IterationRng
from pathtracer_tpu_torch.parallel import dryrun
from pathtracer_tpu_torch.parallel import sharding as sh
from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.scene.types import _granule
from pathtracer_tpu_torch.tools import fit_albedo
from pathtracer_tpu_torch.utils.grad import with_materials
from pathtracer_tpu_torch.utils.vec import Vec3

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _scenes(name, res, depth):
    ov = {"RES": [res, res], "DEPTH": depth}
    return (load_scene(scene_path(name), "cpu", overrides=ov),
            jax_load_scene(scene_path(name), overrides=ov))


def _mesh(n):
    return sh.make_ray_mesh(n, devices="cpu")


@pytest.fixture(scope="module")
def cornell32():
    return _scenes("cornell", 32, 4)


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("name", ["cornell", "teapot"])
def test_interleaved_pixel_map_matches_jax(name, shards):
    """The composed map (teapot: the tile map after the granule
    round-robin) equals the JAX map element for element, on numpy arrays
    and on tensors, and is a bijection of the pool."""
    _, p_set = load_scene(scene_path(name), "cpu",
                          overrides={"RES": [64, 64]})
    _, j_set = jax_load_scene(scene_path(name), overrides={"RES": [64, 64]})
    assert (p_set.tile is not None) == (name == "teapot")
    p_set = dataclasses.replace(p_set, shard_interleave=shards)
    j_set = dataclasses.replace(j_set, shard_interleave=shards)
    lanes = np.arange(p_set.pixel_count, dtype=np.int64)
    pm = np.asarray(p_set.pixel_map()(lanes))
    np.testing.assert_array_equal(pm, np.asarray(j_set.pixel_map()(lanes)))
    np.testing.assert_array_equal(
        p_set.pixel_map()(torch.from_numpy(lanes)).numpy(), pm)
    np.testing.assert_array_equal(np.sort(pm), lanes)
    assert not np.array_equal(pm, np.asarray(dataclasses.replace(
        p_set, shard_interleave=None).pixel_map()(lanes)))


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_granule_matches_jax(shards):
    n_local = 800 * 800 // shards
    for target in (1024, max(64, min(1024, n_local // 32))):
        assert _granule(n_local, target) == j_granule(n_local, target)
    assert _granule(800 * 800 // 8, 1024) == 1000


def test_render_chunk_sharded_matches_jax_and_single_pool(cornell32):
    """8 local shards, 2 iterations: the JAX package's 8-device
    render_chunk_sharded (atol 0) and the port's single-pool render_chunk
    (bit for bit, after undoing each one's lane order)."""
    (p_scene, p_set), (j_scene, j_set) = cornell32
    mesh = _mesh(8)
    accum = sh.render_chunk_sharded(
        p_scene, p_set, mesh,
        sh.shard_accum(zero_accum(p_set, "cpu"), mesh), 1, 2)
    assert len(accum) == 8 and all(a.x.shape == (128,) for a in accum)
    j_mesh = jsh.make_ray_mesh(8)
    j_accum = jsh.render_chunk_sharded(
        jsh.replicate(j_scene, j_mesh), j_set, j_mesh,
        jsh.shard_accum(j_zero_accum(j_set), j_mesh), jnp.int32(1), 2)
    full = sh.gather_accum(accum, mesh)
    np.testing.assert_array_equal(
        full.to_array().numpy(), np.asarray(j_accum.to_array()))
    s8 = dataclasses.replace(p_set, shard_interleave=8)
    single = render_chunk(p_scene, p_set, zero_accum(p_set, "cpu"), 1, 2)
    np.testing.assert_array_equal(lanes_to_image(full, s8),
                                  lanes_to_image(single, p_set))


@pytest.mark.parametrize("shards", [2, 8])
def test_render_sharded_matches_jax_and_render(cornell32, shards):
    (p_scene, p_set), (j_scene, j_set) = cornell32
    img = sh.render_sharded(p_scene, p_set, _mesh(shards), iterations=3,
                            chunk=2)
    img_j = np.asarray(jsh.render_sharded(
        j_scene, j_set, jsh.make_ray_mesh(shards), iterations=3, chunk=2))
    np.testing.assert_array_equal(img, img_j)
    np.testing.assert_array_equal(img, render(p_scene, p_set, iterations=3))


@pytest.mark.parametrize("name", ["cornell", "teapot"])
def test_lanes_to_image_inverts_the_interleave_as_jax(name):
    """The same lane-order data gives the JAX image (scatter through the
    composed map; teapot is tiled as well)."""
    _, p_set = load_scene(scene_path(name), "cpu",
                          overrides={"RES": [32, 32]})
    _, j_set = jax_load_scene(scene_path(name), overrides={"RES": [32, 32]})
    p_set = dataclasses.replace(p_set, shard_interleave=4)
    j_set = dataclasses.replace(j_set, shard_interleave=4)
    data = np.random.default_rng(0).random((3, p_set.pixel_count),
                                           dtype=np.float32)
    img = lanes_to_image(Vec3(*torch.from_numpy(data)), p_set)
    img_j = np.asarray(j_lanes_to_image(JVec3(*jnp.asarray(data)), j_set))
    np.testing.assert_array_equal(img, img_j)


def test_persistent_sharded_matches_jax(cornell32):
    (p_scene, p_set), (j_scene, j_set) = cornell32
    img = sh.render_persistent_sharded(p_scene, p_set, _mesh(8),
                                       iterations=6, chunk=4)
    img_j = np.asarray(jsh.render_persistent_sharded(
        j_scene, j_set, jsh.make_ray_mesh(8), iterations=6))
    np.testing.assert_allclose(img, img_j, **TOL)
    np.testing.assert_allclose(img, render(p_scene, p_set, iterations=6),
                               **TOL)


@pytest.mark.parametrize("interleave", [True, False])
def test_shard_work_counts_match_jax(cornell32, interleave):
    (p_scene, p_set), (j_scene, j_set) = cornell32
    w = sh.shard_work_counts(p_scene, p_set, _mesh(8), iterations=2,
                             interleave=interleave)
    w_j = jsh.shard_work_counts(j_scene, j_set, jsh.make_ray_mesh(8),
                                iterations=2, interleave=interleave)
    assert w.dtype == np.int64 and w.shape == (8,)
    np.testing.assert_array_equal(w, w_j)


def test_albedo_fit_step_matches_jax():
    (p_scene, p_set), (j_scene, j_set) = _scenes("cornell", 16, 2)
    mesh, j_mesh = _mesh(8), jsh.make_ray_mesh(8)
    target = sh.render_chunk_sharded(
        p_scene, p_set, mesh, sh.shard_accum(zero_accum(p_set, "cpu"), mesh),
        1, 1, early_exit=False)
    j_target = jsh.render_chunk_sharded(
        jsh.replicate(j_scene, j_mesh), j_set, j_mesh,
        jsh.shard_accum(j_zero_accum(j_set), j_mesh), jnp.int32(1), 1, 0,
        False)
    wrong = np.clip(p_scene.materials.color.numpy() + 0.2, 0.0, 1.0)
    p_wrong = with_materials(p_scene, color=torch.from_numpy(wrong))
    j_wrong = j_scene._replace(materials=j_scene.materials._replace(
        color=jnp.asarray(wrong)))
    new, loss = sh.albedo_fit_step(p_wrong, p_set, mesh, target, 2, lr=0.5)
    j_new, j_loss = jsh.albedo_fit_step(j_wrong, j_set, j_mesh, j_target,
                                        jnp.int32(2), lr=0.5)
    assert float(loss) > 0
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=0, atol=1e-6)
    np.testing.assert_allclose(new.materials.color.numpy(),
                               np.asarray(j_new.materials.color), rtol=0,
                               atol=1e-6)
    assert not np.allclose(new.materials.color.numpy(), wrong)


def test_albedo_fit_step_on_one_shard_is_the_single_device_step():
    scene, settings = load_scene(scene_path("cornell"), "cpu",
                                 overrides={"RES": [16, 16], "DEPTH": 2})
    mesh = _mesh(1)
    with torch.no_grad():
        target = render_chunk(scene, settings, zero_accum(settings, "cpu"),
                              1, 1, early_exit=False)
    wrong = with_materials(scene, color=torch.clamp(
        scene.materials.color + 0.2, 0.0, 1.0))
    new, loss = sh.albedo_fit_step(wrong, settings, mesh,
                                   sh.shard_accum(target, mesh), 1)
    new_1, loss_1 = fit_albedo.albedo_fit_step(wrong, settings, target, 1)
    assert torch.equal(loss, loss_1)
    assert torch.equal(new.materials.color, new_1.materials.color)


def test_binned_intersect_sharded_bitexact():
    """Teapot 32x32 camera rays through "binned" (cull, stream, packet's
    plain versions on the CPU) in 4 blocks equal the one-pool call."""
    scene, settings = load_scene(scene_path("teapot"), "cpu",
                                 overrides={"RES": [32, 32], "DEPTH": 2})
    assert settings.bvh_impl == "binned"
    state = generate_paths(scene, settings,
                           IterationRng(0, 1, pixel_map=settings.pixel_map()))
    o, d = state.origin, state.direction

    def isect(o, d):
        return intersect_scene(scene, settings.geom_types, o, d,
                               bvh_impl="binned")

    t1, n1, m1 = isect(o, d)
    assert bool((t1 > 0).any()) and bool((m1 != m1[0]).any())
    parts = [isect(Vec3(*(c[k * 256:(k + 1) * 256] for c in o)),
                   Vec3(*(c[k * 256:(k + 1) * 256] for c in d)))
             for k in range(4)]
    assert torch.equal(torch.cat([p[0] for p in parts]).view(torch.int32),
                       t1.view(torch.int32))
    assert torch.equal(torch.cat([p[2] for p in parts]), m1)
    for k in range(3):
        assert torch.equal(torch.cat([p[1][k] for p in parts]), n1[k])


@pytest.mark.parametrize("shards", [1, 4])
def test_dryrun_multichip_on_the_cpu(shards):
    fn, args = dryrun.entry("cpu")
    out = fn(*args)
    assert out.x.shape == (256 * 256,) and bool(torch.isfinite(out.x).all())
    dryrun.dryrun_multichip(shards, "cpu")


@pytest.mark.parametrize("mode", ["sorted", "tiled"])
def test_engine_modes_run_per_shard(cornell32, mode):
    """The sorted and tiled modes on each shard's block (tiles of 64 of a
    256-lane block) give the single-pool image of the mode."""
    (p_scene, p_set), _ = cornell32
    kw = ({"sort_materials": True} if mode == "sorted"
          else {"compact": True, "compact_tile": 64})
    m_set = dataclasses.replace(p_set, **kw)
    img = sh.render_sharded(p_scene, m_set, _mesh(4), iterations=2)
    np.testing.assert_allclose(img, render(p_scene, m_set, iterations=2),
                               **TOL)


def test_mesh_and_accumulator_bookkeeping(cornell32):
    (p_scene, p_set), _ = cornell32
    mesh = sh.make_ray_mesh(4, devices=["cpu"] * 4)
    assert mesh.shards == (0, 1, 2, 3) and mesh.group is None
    assert mesh.n_local(p_set) == 256
    assert all(s is p_scene for s in sh.replicate(p_scene, mesh))
    full = Vec3(*torch.arange(3 * 1024, dtype=torch.float32).reshape(3, -1))
    blocks = sh.shard_accum(full, mesh)
    assert torch.equal(blocks[1].y, full.y[256:512])
    assert all(torch.equal(a, b) for a, b in zip(sh.gather_accum(blocks,
                                                                 mesh), full))
    blocks[0].x.add_(1.0)          # a block is a copy, not a view
    assert float(full.x[0]) == 0.0
    with pytest.raises(ValueError):
        sh.make_ray_mesh(3, devices="cpu").n_local(p_set)
    with pytest.raises(ValueError):
        sh.make_ray_mesh(4, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            sh.make_ray_mesh(2)


# -- the JAX file's slow tests, at a smaller size, port only ----------------

def _fit(name, res, depth, steps, seed):
    scene, settings = load_scene(scene_path(name), "cpu",
                                 overrides={"RES": [res, res],
                                            "DEPTH": depth})
    mesh = _mesh(4)
    target = sh.render_chunk_sharded(
        scene, settings, mesh,
        sh.shard_accum(zero_accum(settings, "cpu"), mesh), 1, 1,
        early_exit=False)
    true = scene.materials.color.numpy()
    rng = np.random.default_rng(seed)
    wrong = np.clip(true + rng.uniform(-0.2, 0.2, true.shape), 0.05, 0.95)
    s = with_materials(scene, color=torch.as_tensor(wrong,
                                                    dtype=torch.float32))
    losses = []
    for _ in range(steps):
        s, loss = sh.albedo_fit_step(s, settings, mesh, target, 1, lr=1.0)
        losses.append(float(loss))
    err0 = np.abs(wrong - true).mean()
    err = np.abs(s.materials.color.numpy() - true).mean()
    return settings, losses, err0, err


def test_albedo_fit_descends():
    _, losses, _, _ = _fit("cornell", 16, 3, 2, 0)
    assert np.isfinite(losses).all() and losses[1] <= losses[0] + 1e-6


@pytest.mark.parametrize("name,steps,bound", [("cornell", 12, 0.7),
                                              ("teapot", 8, 0.75)])
def test_albedo_fit_converges(name, steps, bound):
    settings, losses, err0, err = _fit(name, 16, 2 if name == "teapot"
                                       else 3, steps, 1 if name == "cornell"
                                       else 3)
    if name == "teapot":
        assert settings.bvh_impl == "binned"
    assert losses[-1] < losses[0] * 0.5, f"loss did not halve: {losses}"
    assert err < err0 * bound, f"albedo error {err0:.4f} -> {err:.4f}"


def test_interleaved_work_below_contiguous():
    scene, settings = load_scene(scene_path("cornell"), "cpu",
                                 overrides={"RES": [64, 64], "DEPTH": 4})
    mesh = _mesh(8)
    w = sh.shard_work_counts(scene, settings, mesh, iterations=2)
    w0 = sh.shard_work_counts(scene, settings, mesh, iterations=2,
                              interleave=False)
    assert w.sum() == w0.sum()
    assert w.max() / w.mean() < w0.max() / w0.mean()


def test_scaling_efficiency_runs(cornell32):
    (p_scene, p_set), _ = cornell32
    r = sh.scaling_efficiency(p_scene, p_set, [1, 2], iterations=2,
                              devices="cpu")
    assert set(r) == {1, 2}
    assert r[1]["efficiency"] == 1.0
    assert r[1]["rays_per_s"] > 0 and r[2]["rays_per_s"] > 0
