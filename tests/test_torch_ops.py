"""PyTorch port, per-ray ops: RNG, camera, analytic intersection, shading,
each against its JAX function on the same inputs (made with numpy).

Tolerances, and why:
  - RNG states and uniforms: exact. Both are integer hashes; the uniform is
    the top 24 bits times 2**-24, exact in float32.
  - Box-Muller normals: 1e-6 absolute. log/sqrt/cos/sin round differently in
    XLA and in torch (a few ulps).
  - Everything else in float: XLA's CPU backend contracts a*b+c into fused
    multiply-adds (test_xla_cpu_contracts_multiply_adds pins this) and
    torch's eager ops do not, so values differ by a few ulps; 1e-5 absolute
    on unit vectors and 1e-5 relative on distances. Integer outputs (hit
    sets, material ids, remaining bounces) are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu import load_scene as jax_load_scene
from pathtracer_tpu.ops import bsdf as j_bsdf
from pathtracer_tpu.ops import camera as j_camera
from pathtracer_tpu.ops import intersect as j_intersect
from pathtracer_tpu.ops import rng as j_rng
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch import load_scene
from pathtracer_tpu_torch.ops import bsdf, camera, intersect, rng
from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.utils.vec import Vec3

torch.set_num_threads(2)

N = 4096


def j3(a):
    return JVec3(*(jnp.asarray(c) for c in a))


def t3(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def np3(v):
    return np.stack([np.asarray(c) for c in v])


def unit(rng_, n):
    d = rng_.normal(size=(3, n)).astype(np.float32)
    return (d / np.linalg.norm(d, axis=0)).astype(np.float32)


@pytest.fixture(scope="module")
def cornell():
    path = scene_path("cornell")
    return jax_load_scene(path), load_scene(path, "cpu")


def test_xla_cpu_contracts_multiply_adds():
    """Why float outputs get a few-ulp tolerance: XLA on the CPU computes
    a*b + c as one rounding (an FMA), numpy and torch as two."""
    r = np.random.default_rng(1)
    a, b, c = (r.normal(size=10_000).astype(np.float32) for _ in range(3))
    got = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    fused = (a.astype(np.float64) * b + c).astype(np.float32)
    np.testing.assert_array_equal(got, fused)
    two_roundings = (torch.from_numpy(a) * torch.from_numpy(b)
                     + torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(two_roundings, a * b + c)
    assert (got != two_roundings).any()


@pytest.mark.parametrize("seed,sample,depth", [
    (0, 1, -1), (0, 1, -2), (7, 3, 0), (12345, 77, 5), (2**31 + 5, 2**32 - 1,
                                                       2)])
def test_decision_state_and_uniforms_bit_identical(seed, sample, depth):
    pix = np.random.default_rng(seed % 1000).integers(
        0, 2**31 - 1, size=N).astype(np.int64)
    pix[:3] = (0, 1, 640_000)
    j_state = np.asarray(j_rng.decision_state(
        seed, jnp.uint32(sample), jnp.int32(depth),
        jnp.asarray(pix, jnp.int32)))
    p_state = rng.decision_state(seed, sample, depth, torch.from_numpy(pix))
    np.testing.assert_array_equal(p_state.numpy(), j_state.astype(np.int64))
    for uj, up in zip(j_rng.fast_uniforms_perlane(jnp.asarray(j_state), 5),
                      rng.fast_uniforms_perlane(p_state, 5)):
        np.testing.assert_array_equal(up.numpy(), np.asarray(uj))


def test_normals_within_1e6():
    pix = np.arange(N, dtype=np.int64)
    j_state = j_rng.decision_state(3, jnp.int32(9), jnp.int32(-1),
                                   jnp.asarray(pix, jnp.int32))
    p_state = rng.decision_state(3, 9, -1, torch.from_numpy(pix))
    for zj, zp in zip(j_rng.fast_normals_perlane(j_state, 3),
                      rng.fast_normals_perlane(p_state, 3)):
        np.testing.assert_allclose(zp.numpy(), np.asarray(zj), rtol=0,
                                   atol=1e-6)


def test_iteration_rng_with_tile_map_bit_identical():
    pm_j = j_camera.tile_pixel_map(64, 64, 32, 32)
    pm_p = camera.tile_pixel_map(64, 64, 32, 32)
    lanes = np.arange(64 * 64, dtype=np.int64)
    ij = j_rng.IterationRng(True, 5, jnp.int32(2), pixel_map=pm_j)
    ip = rng.IterationRng(5, 2, pixel_map=pm_p)
    for depth in (-2, -1, 0, 3):
        for uj, up in zip(ij.uniforms(depth, jnp.asarray(lanes, jnp.int32), 4),
                          ip.uniforms(depth, torch.from_numpy(lanes), 4)):
            np.testing.assert_array_equal(up.numpy(), np.asarray(uj))


@pytest.mark.parametrize("lens", [0.0, 0.2])
def test_camera_rays_match_jax(cornell, lens):
    (j_scene, j_set), (p_scene, p_set) = cornell
    r = np.random.default_rng(4)
    pix = r.integers(0, j_set.pixel_count, size=N).astype(np.int64)
    jit_n = r.normal(size=(2, N)).astype(np.float32)
    dof_u = r.uniform(size=(2, N)).astype(np.float32)
    j_cam = j_scene.camera._replace(lens_radius=jnp.float32(lens))
    p_cam = dataclasses.replace(p_scene.camera,
                                lens_radius=torch.tensor(lens,
                                                         dtype=torch.float32))
    jo, jd = j_camera.generate_camera_rays(
        j_cam, j_set.width, j_set.height, tuple(map(jnp.asarray, jit_n)),
        tuple(map(jnp.asarray, dof_u)), n=N,
        pixel_idx=jnp.asarray(pix, jnp.int32))
    po, pd = camera.generate_camera_rays(
        p_cam, p_set.width, p_set.height, tuple(map(torch.from_numpy, jit_n)),
        tuple(map(torch.from_numpy, dof_u)), pixel_idx=torch.from_numpy(pix))
    np.testing.assert_allclose(np3(po), np3(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np3(pd), np3(jd), rtol=0, atol=1e-5)


def _rays(seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-5, 5, size=(3, N)).astype(np.float32)
    return o, unit(r, N)


@pytest.mark.parametrize("geom", range(7))   # cornell: 6 boxes, 1 sphere
def test_analytic_intersection_matches_jax(cornell, geom):
    (j_scene, j_set), (p_scene, _) = cornell
    o, d = _rays(geom)
    j_fn = (j_intersect.sphere_intersect if j_set.geom_types[geom] == 0
            else j_intersect.box_intersect)
    p_fn = (intersect.sphere_intersect if j_set.geom_types[geom] == 0
            else intersect.box_intersect)
    g, pg = j_scene.geoms, p_scene.geoms
    tj, nj = j_fn(g.transform[geom], g.inverse_transform[geom],
                  g.inv_transpose[geom], j3(o), j3(d))
    tp, np_ = p_fn(pg.transform[geom], pg.inverse_transform[geom],
                   pg.inv_transpose[geom], t3(o), t3(d))
    tj, tp = np.asarray(tj), tp.numpy()
    np.testing.assert_array_equal(tp > 0, tj > 0)
    hit = tj > 0
    assert hit.any()
    np.testing.assert_allclose(tp[hit], tj[hit], rtol=1e-5, atol=0)
    np.testing.assert_allclose(np3(np_)[:, hit], np3(nj)[:, hit], rtol=0,
                               atol=1e-5)


def test_intersect_scene_analytic_matches_jax(cornell):
    (j_scene, j_set), (p_scene, p_set) = cornell
    o, d = _rays(11)
    o = (o * 0.4).astype(np.float32)     # origins inside the box
    tj, nj, mj = j_intersect.intersect_scene(j_scene, j_set.geom_types,
                                             j3(o), j3(d))
    tp, np_, mp = intersect.intersect_scene(p_scene, p_set.geom_types,
                                            t3(o), t3(d))
    np.testing.assert_array_equal(mp.numpy(), np.asarray(mj))
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), rtol=1e-5, atol=0)
    np.testing.assert_allclose(np3(np_), np3(nj), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,depth_quirk,rr_start", [
    ("cornell", False, 0), ("cornell", True, 0), ("cornell", False, 2),
    ("glass_slab", False, 0)])
def test_shade_matches_jax(name, depth_quirk, rr_start):
    j_scene, j_set = jax_load_scene(scene_path(name))
    p_scene, _ = load_scene(scene_path(name), "cpu")
    r = np.random.default_rng(21)
    o = r.uniform(-5, 5, size=(3, N)).astype(np.float32)
    d = unit(r, N)
    nrm = unit(r, N)
    col = r.uniform(0, 1, size=(3, N)).astype(np.float32)
    rb = r.integers(-1, 4, size=N).astype(np.int32)
    t = np.where(r.uniform(size=N) < 0.2, -1.0,
                 r.uniform(0.1, 10, size=N)).astype(np.float32)
    m = r.integers(-1, j_scene.materials.emittance.shape[0],
                   size=N).astype(np.int32)
    u = r.uniform(size=(5, N)).astype(np.float32)
    kw = dict(any_glossy=j_set.any_glossy,
              any_refractive=j_set.any_refractive, depth_quirk=depth_quirk,
              rr_start=rr_start)
    out_j = j_bsdf.shade(j3(o), j3(d), j3(col), jnp.asarray(rb),
                         jnp.asarray(t), j3(nrm), jnp.asarray(m),
                         j_scene.materials, tuple(map(jnp.asarray, u)),
                         rr_depth=jnp.int32(3), **kw)
    out_p = bsdf.shade(t3(o), t3(d), t3(col), torch.from_numpy(rb),
                       torch.from_numpy(t), t3(nrm), torch.from_numpy(m),
                       p_scene.materials, tuple(map(torch.from_numpy, u)),
                       rr_depth=3, **kw)
    np.testing.assert_array_equal(out_p[3].numpy(), np.asarray(out_j[3]))
    for k, tol in ((0, 1e-5), (1, 1e-5), (2, 1e-5)):
        np.testing.assert_allclose(np3(out_p[k]), np3(out_j[k]), rtol=tol,
                                   atol=tol)
