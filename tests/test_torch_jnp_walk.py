"""PyTorch port, the "jnp" mesh walk (ops/intersect.py mesh_intersect, the
stackless ENTER/ADVANCE walk with the reference's inside-origin prune
quirk) against the JAX package's walk, lane by lane, on the same rays.

Tolerances:
  - material ids, and which lanes hit, always exact;
  - t against JAX as its tests run it: rtol 1e-6 (XLA's CPU backend
    contracts multiply-adds into FMAs, tests/test_torch_ops.py; measured
    within 3e-6 absolute on teapot camera rays), and bit for bit against
    JAX in a process whose XLA may not use FMA
    (XLA_FLAGS=--xla_cpu_max_isa=AVX), as tests/test_torch_binned.py does;
  - normals: 1e-6 absolute (the two packages' rsqrt differ by an ulp;
    measured 1.2e-7).
No kernel is held against this walk: its prune quirk is not the kernels'
contract.
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
from pathtracer_tpu.ops import intersect as j_intersect
from pathtracer_tpu.scene import types as j_types
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch import load_scene
from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.ops import intersect, rng
from pathtracer_tpu_torch.scene import types
from pathtracer_tpu_torch.scene.bvh import align_leaves, build_bvh
from pathtracer_tpu_torch.scene.fixtures import REPO_ROOT, scene_path
from pathtracer_tpu_torch.utils.vec import Vec3
from torch_wide_scenes import SCENES

torch.set_num_threads(2)

RES = {"RES": [24, 24], "DEPTH": 3}


@pytest.fixture(scope="module")
def teapot():
    """(JAX scene, port scene, {camera, bounce1}: (o [3, N], d [3, N]))."""
    j_scene, _ = jax_load_scene(scene_path("teapot"), overrides=RES)
    scene, settings = load_scene(scene_path("teapot"), "cpu", overrides=RES,
                                 bvh_impl="jnp")
    irng = rng.IterationRng(0, 1, pixel_map=settings.pixel_map())
    state = wavefront.generate_paths(scene, settings, irng)
    rays = {"camera": state}
    rays["bounce1"] = wavefront.bounce_step(
        scene, settings, irng, 0, state, wavefront.zero_accum(settings, "cpu"))
    rays = {k: (np.stack([c.numpy() for c in s.origin]),
                np.stack([c.numpy() for c in s.direction]))
            for k, s in rays.items()}
    return j_scene, scene, rays


def _port(scene, root, o, d):
    t, n, m = intersect.mesh_intersect(
        scene, root, Vec3(*map(torch.from_numpy, o)),
        Vec3(*map(torch.from_numpy, d)))
    return t.numpy(), np.stack([c.numpy() for c in n]), m.numpy()


def _jax(j_scene, root, o, d):
    t, n, m = j_intersect.mesh_intersect(
        j_scene, jnp.int32(root), JVec3(*map(jnp.asarray, o)),
        JVec3(*map(jnp.asarray, d)))
    return np.asarray(t), np.stack([np.asarray(c) for c in n]), np.asarray(m)


def _assert_match(port, ref, t_exact, t_atol=0.0, n_atol=1e-6):
    (tp, np_, mp), (tj, nj, mj) = port, ref
    np.testing.assert_array_equal(tp > 0, tj > 0)
    np.testing.assert_array_equal(mp, mj)
    if t_exact:
        np.testing.assert_array_equal(tp.view(np.int32), tj.view(np.int32))
    else:
        np.testing.assert_allclose(tp, tj, rtol=1e-6, atol=t_atol)
    np.testing.assert_allclose(np_, nj, rtol=0, atol=n_atol)
    return int((tj > 0).sum())


@pytest.mark.parametrize("kind", ["camera", "bounce1"])
def test_mesh_intersect_matches_jax(teapot, kind):
    j_scene, scene, rays = teapot
    root = scene.mesh_roots[0]
    o, d = rays[kind]
    assert _assert_match(_port(scene, root, o, d), _jax(j_scene, root, o, d),
                         t_exact=False) > 10


# the JAX walk on the teapot rays, in a process whose XLA may not use FMA
JAX_WITHOUT_FMA = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from pathtracer_tpu import load_scene
from pathtracer_tpu.ops.intersect import mesh_intersect
from pathtracer_tpu.utils.vec import Vec3
rays = np.load(sys.argv[1])
scene, _ = load_scene(sys.argv[2], overrides={"RES": [24, 24], "DEPTH": 3})
out = {}
for kind in ("camera", "bounce1"):
    t, n, m = mesh_intersect(scene, jnp.int32(int(rays["root"])),
                             Vec3(*map(jnp.asarray, rays[kind + "_o"])),
                             Vec3(*map(jnp.asarray, rays[kind + "_d"])))
    out[kind + "_t"] = np.asarray(t)
    out[kind + "_n"] = np.stack([np.asarray(c) for c in n])
    out[kind + "_m"] = np.asarray(m)
np.savez(sys.argv[3], **out)
"""


def test_mesh_intersect_bit_equal_to_jax_without_fma(teapot, tmp_path):
    _, scene, rays = teapot
    root = scene.mesh_roots[0]
    arrays = {"root": np.int64(root)}
    for kind, (o, d) in rays.items():
        arrays[kind + "_o"], arrays[kind + "_d"] = o, d
    np.savez(tmp_path / "rays.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_max_isa=AVX").strip()
    res = subprocess.run(
        [sys.executable, "-c", JAX_WITHOUT_FMA, str(tmp_path / "rays.npz"),
         scene_path("teapot"), str(tmp_path / "out.npz")],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = np.load(tmp_path / "out.npz")
    for kind, (o, d) in rays.items():
        ref = tuple(out[f"{kind}_{k}"] for k in "tnm")
        assert _assert_match(_port(scene, root, o, d), ref, t_exact=True)


def _mesh_scenes(tris, max_leaf):
    """The same binary BVH over `tris` as a JAX and a port SceneArrays."""
    nodes, reordered = align_leaves(*build_bvh(tris, max_leaf=max_leaf))
    geoms = [{"type": 2, "material_id": 0, "transform": np.eye(4),
              "inverse_transform": np.eye(4), "inv_transpose": np.eye(4),
              "root_node": 0}]
    mats = [{"color": (0.5, 0.5, 0.5)}]
    cam = {"position": (0, 0, 5), "view": (0, 0, -1), "up": (0, 1, 0),
           "right": (1, 0, 0), "pixel_length": (0.01, 0.01),
           "lens_radius": 0.0, "focal_distance": 10.0}
    j_scene = j_types.make_scene_arrays(geoms, mats, nodes, reordered, cam)
    scene = types.make_scene_arrays(geoms, mats, nodes, reordered, cam, "cpu",
                                    triangle_table=True)
    return j_scene, scene


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tie_scenes_match_jax_bit_for_bit(name):
    """The crafted tie scenes of tests/torch_wide_scenes.py (exact ties on
    t, a shared edge, rays whose slab test is NaN), under a binary BVH of
    one triangle a leaf: dyadic coordinates make the arithmetic exact, so
    the port and JAX agree by their bits, and the same lanes hit as in the
    8-wide walk (the winner of a tie follows this walk's own order)."""
    _, tris, _, o, d, mats = SCENES[name]()
    j_scene, scene = _mesh_scenes(tris, max_leaf=1)
    port = _port(scene, 0, o, d)
    _assert_match(port, _jax(j_scene, 0, o, d), t_exact=True)
    np.testing.assert_array_equal(port[2] >= 0, mats >= 0)


def test_random_soup_with_inside_origins_matches_jax():
    """A random triangle soup, with origins inside the mesh's boxes, where
    the inside-origin prune quirk decides some hits (JAX's own oracle test
    of the quirk is tests/test_intersect.py). Its rays start close to the
    triangles, so XLA's FMA contraction moves t by up to 4.4e-6 absolute
    (measured) on t near 0, and u, v with it: its random, unnormalized
    vertex normals then move by up to 4.4e-6 (measured). Both within 1e-5
    absolute."""
    g = np.random.default_rng(3)
    n_tris = 200
    v = g.normal(0, 1.5, (n_tris, 3, 3)).astype(np.float32)
    nrm = g.normal(0, 1, (n_tris, 3, 3)).astype(np.float32)
    tris = {"v0": v[:, 0], "v1": v[:, 1], "v2": v[:, 2], "n0": nrm[:, 0],
            "n1": nrm[:, 1], "n2": nrm[:, 2],
            "material_id": np.arange(n_tris, dtype=np.int32) % 7}
    j_scene, scene = _mesh_scenes(tris, max_leaf=4)
    o = g.normal(0, 1.0, (3, 4096)).astype(np.float32)
    d = g.normal(0, 1.0, (3, 4096)).astype(np.float32)
    assert _assert_match(_port(scene, 0, o, d), _jax(j_scene, 0, o, d),
                         t_exact=False, t_atol=1e-5, n_atol=1e-5) > 1000


def test_triangle_intersect_matches_jax():
    g = np.random.default_rng(4)
    a = [g.normal(0, 1, (3, 512)).astype(np.float32) for _ in range(8)]
    t, n = intersect.triangle_intersect(
        *(Vec3(*map(torch.from_numpy, x)) for x in a))
    tj, nj = j_intersect.triangle_intersect(
        *(JVec3(*map(jnp.asarray, x)) for x in a))
    np.testing.assert_array_equal(t.numpy() > 0, np.asarray(tj) > 0)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), rtol=1e-5)
    hit = t.numpy() > 0
    assert hit.sum() > 10
    for c, cj in zip(n, nj):
        np.testing.assert_allclose(c.numpy()[hit], np.asarray(cj)[hit],
                                   atol=1e-6)


def test_intersect_scene_jnp_matches_jax(teapot):
    """intersect_scene with "jnp": the analytic geoms, then each mesh root
    walked without the analytic bound, as in the JAX package."""
    j_scene, scene, rays = teapot
    _, j_set = jax_load_scene(scene_path("teapot"), overrides=RES)
    o, d = rays["bounce1"]
    t, n, m = intersect.intersect_scene(
        scene, j_set.geom_types, Vec3(*map(torch.from_numpy, o)),
        Vec3(*map(torch.from_numpy, d)), bvh_impl="jnp")
    tj, nj, mj = j_intersect.intersect_scene(
        j_scene, j_set.geom_types, JVec3(*map(jnp.asarray, o)),
        JVec3(*map(jnp.asarray, d)), bvh_impl="jnp")
    _assert_match((t.numpy(), np.stack([c.numpy() for c in n]), m.numpy()),
                  (np.asarray(tj), np.stack([np.asarray(c) for c in nj]),
                   np.asarray(mj)), t_exact=False)


def test_triangle_table_matches_jax():
    """The per-triangle SoA table equals JAX's TriangleArrays, field for
    field, bit for bit; it is built only for "jnp" (zero rows otherwise),
    and carried across from a JAX scene."""
    from pathtracer_tpu_torch.scene.loader import scene_from_jax_arrays
    from test_torch_scene import jax_leaves

    j_scene, _ = jax_load_scene(scene_path("cow"))
    scene, settings = load_scene(scene_path("cow"), "cpu", bvh_impl="jnp")
    assert settings.bvh_impl == "jnp"
    ref = jax_leaves(j_scene)
    carried = scene_from_jax_arrays(ref, "cpu")
    for f in dataclasses.fields(types.TriangleArrays):
        want = ref[f"triangles.{f.name}"]
        for s in (scene, carried):
            got = getattr(s.triangles, f.name).numpy()
            assert got.dtype == want.dtype, f.name
            np.testing.assert_array_equal(got, want, err_msg=f.name)
    assert load_scene(scene_path("cow"), "cpu")[0].triangles.count == 0


def test_jnp_needs_the_triangle_table():
    """A scene loaded without the triangle table rejects "jnp"."""
    scene, settings = load_scene(scene_path("teapot"), "cpu",
                                 overrides={"RES": [8, 8], "DEPTH": 1})
    with pytest.raises(ValueError, match="triangle table"):
        wavefront.render_iteration(
            scene, dataclasses.replace(settings, bvh_impl="jnp"),
            wavefront.zero_accum(settings, "cpu"), 1)


def test_jnp_render_matches_binned_and_jax():
    """One teapot iteration through "jnp": the same image as "binned" in
    the port, and as "jnp" in the JAX package (pixels over 1e-4 in under
    1%, the criterion of tests/test_torch_engine.py)."""
    from pathtracer_tpu import render as jax_render

    ov = {"RES": [32, 32], "DEPTH": 3}
    j_scene, j_set = jax_load_scene(scene_path("teapot"), overrides=ov)
    img_j = np.asarray(jax_render(
        j_scene, dataclasses.replace(j_set, bvh_impl="jnp"), iterations=1,
        seed=0))
    scene, settings = load_scene(scene_path("teapot"), "cpu", overrides=ov,
                                 bvh_impl="jnp")
    img = wavefront.render(scene, settings, iterations=1, seed=0)
    img_b = wavefront.render(
        scene, dataclasses.replace(settings, bvh_impl="binned"),
        iterations=1, seed=0)
    assert np.isfinite(img).all() and img.max() > 0
    for ref in (img_j, img_b):
        assert (np.abs(img - ref).max(axis=-1) > 1e-4).mean() < 0.01


def test_command_line_bvh_jnp(tmp_path, capsys):
    from pathtracer_tpu_torch.__main__ import main

    out = tmp_path / "teapot.png"
    main([scene_path("teapot"), "--res", "16", "--spp", "1", "--depth", "2",
          "--out", str(out), "--bvh", "jnp", "--device", "cpu"])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "on cpu, bvh jnp:" in capsys.readouterr().out
