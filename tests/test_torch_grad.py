"""PyTorch port, differentiable rendering: gradients through the bounce
loop against the JAX package's jax.grad on the same scene, settings and
seed, against central finite differences, and the fits' steps against the
JAX steps.

The loss of tests/test_grad.py: the image sum over the pixel count of one
fixed-depth iteration (iteration 1, seed 0). Tolerances:
  - albedo and emittance gradients: 1e-6 absolute against JAX (measured:
    0.0, the pathwise part is the same arithmetic);
  - the IOR gradient: rtol 1e-4 against JAX (measured 1.8e-7 absolute on a
    largest |g| of 0.724); it carries the branch-probability surrogate;
  - finite differences: rtol 0.05, abs 1e-5, as tests/test_grad.py;
  - the fit steps: 1e-6 absolute in loss and new albedo (the loss is a sum
    over pixels, in another order in each package).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu import load_scene as jax_load_scene
from pathtracer_tpu.engine.wavefront import render_iteration as j_render_it
from pathtracer_tpu.engine.wavefront import zero_accum as j_zero_accum
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch import load_scene
from pathtracer_tpu_torch.engine.wavefront import (render_iteration,
                                                   zero_accum)
from pathtracer_tpu_torch.ops import intersect
from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.utils.grad import value_and_grad, with_materials
from pathtracer_tpu_torch.utils.vec import Vec3

torch.set_num_threads(2)

FIELDS = {"albedo": ("materials", "color"),
          "emittance": ("materials", "emittance"),
          "ior": ("materials", "ior"),
          "cam_pos": ("camera", "position")}


def _scenes(name, res, depth, bvh_impl=None):
    ov = {"RES": [res, res], "DEPTH": depth}
    j_scene, j_set = jax_load_scene(scene_path(name), overrides=ov)
    scene, settings = load_scene(scene_path(name), "cpu", overrides=ov,
                                 bvh_impl=bvh_impl)
    if bvh_impl:
        j_set = dataclasses.replace(j_set, bvh_impl=bvh_impl)
    return j_scene, j_set, scene, settings


def port_loss(scene, settings, param):
    """(loss(value), the parameter's value) for the port."""
    group, field = FIELDS[param]

    def replace(sc, **kw):
        return dataclasses.replace(sc, **{group: dataclasses.replace(
            getattr(sc, group), **kw)})

    def loss(value):
        img = render_iteration(replace(scene, **{field: value}), settings,
                               zero_accum(settings, "cpu"), 1, seed=0,
                               early_exit=False)
        return (img.x.sum() + img.y.sum() + img.z.sum()) / settings.pixel_count

    return loss, getattr(getattr(scene, group), field)


def jax_grad(j_scene, j_set, param, value=None):
    group, field = FIELDS[param]

    def loss(v):
        sub = getattr(j_scene, group)._replace(**{field: v})
        img = j_render_it(j_scene._replace(**{group: sub}), j_set,
                          j_zero_accum(j_set), jnp.int32(1), seed=0,
                          early_exit=False)
        return (img.x.sum() + img.y.sum() + img.z.sum()) / j_set.pixel_count

    p0 = getattr(getattr(j_scene, group), field) if value is None else value
    return np.asarray(jax.jit(jax.grad(loss))(p0))


@pytest.mark.parametrize("param", ["albedo", "emittance"])
def test_material_grad_matches_jax(param):
    j_scene, j_set, scene, settings = _scenes("cornell", 32, 3)
    _, g = value_and_grad(*port_loss(scene, settings, param))
    want = jax_grad(j_scene, j_set, param)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-6)


def test_ior_grad_matches_jax():
    """The IOR reaches the image only through the Fresnel pick's
    probability: without the surrogate the gradient is ~0 (1.9e-8 against
    JAX's 0.724, measured before it was ported)."""
    j_scene, j_set, scene, settings = _scenes("glass_slab", 32, 4)
    _, g = value_and_grad(*port_loss(scene, settings, "ior"))
    want = jax_grad(j_scene, j_set, "ior")
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_camera_grad_is_zero():
    """tests/test_grad.py test_camera_grad_zero_almost_everywhere: the
    loss does not depend on the camera position through anything
    differentiable, so the port's loss has no autograd graph at all; the
    helper returns zeros, as jax.grad does."""
    j_scene, j_set, scene, settings = _scenes("cornell", 16, 2)
    loss, p0 = port_loss(scene, settings, "cam_pos")
    value, g = value_and_grad(loss, p0)
    assert np.isfinite(float(value))
    np.testing.assert_array_equal(g.numpy(), np.zeros(3, np.float32))
    np.testing.assert_allclose(jax_grad(j_scene, j_set, "cam_pos"), 0.0,
                               atol=1e-5)


def test_unused_material_grad_is_zero():
    """A material that no geometry references (a row appended to Cornell's
    table, where every material is used) gets a zero albedo gradient, in
    the port and in JAX; the other rows keep their gradient."""
    j_scene, j_set, scene, settings = _scenes("cornell", 16, 2)
    extra = np.array([[0.3, 0.6, 0.9]], np.float32)
    color = torch.cat([scene.materials.color, torch.from_numpy(extra)])
    scene = with_materials(scene, color=color)
    for f in ("specular_color", "specular_exponent", "has_reflective",
              "has_refractive", "ior", "emittance"):
        a = getattr(scene.materials, f)
        scene = with_materials(scene, **{f: torch.cat([a, a[:1]])})
    _, g = value_and_grad(*port_loss(scene, settings, "albedo"))
    j_color = jnp.concatenate([j_scene.materials.color, jnp.asarray(extra)])
    j_mats = j_scene.materials._replace(**{
        f: jnp.concatenate([getattr(j_scene.materials, f),
                            getattr(j_scene.materials, f)[:1]])
        for f in ("specular_color", "specular_exponent", "has_reflective",
                  "has_refractive", "ior", "emittance")})
    want = jax_grad(j_scene._replace(materials=j_mats), j_set, "albedo",
                    value=j_color)
    g = g.numpy()
    np.testing.assert_array_equal(g[-1], np.zeros(3, np.float32))
    assert np.abs(g[:-1]).max() > 1e-3
    np.testing.assert_allclose(g, want, rtol=0, atol=1e-6)


def test_branch_prob_surrogate_expectation_gradient():
    """tests/test_grad.py's check of the surrogate on a dense uniform grid:
    E[w f] = p f_r + (1-p) f_t, dE/dp = f_r - f_t, and every sample keeps
    its value (w == 1 away from the clamp)."""
    from pathtracer_tpu_torch.ops.bsdf import _branch_prob_surrogate

    f_r, f_t = 3.0, 0.5
    u = (torch.arange(100000, dtype=torch.float32) + 0.5) / 100000.0
    for p0 in (0.2, 0.5, 0.9):
        p = torch.tensor(p0, requires_grad=True)
        took = u < p
        w = _branch_prob_surrogate(took, p.expand_as(u))
        assert torch.equal(w.detach(), torch.ones_like(u))
        val = (w * torch.where(took, f_r, f_t)).mean()
        (g,) = torch.autograd.grad(val, p)
        want = p0 * f_r + (1 - p0) * f_t
        assert float(val.detach()) == pytest.approx(want, rel=1e-3)
        assert float(g) == pytest.approx(f_r - f_t, rel=1e-3)


def test_ior_gradient_matches_finite_difference_expectation():
    """tests/test_grad.py's expectation-level FD check of the IOR gradient
    through the real scatter_ray: 2^19 refractive scatters from the real
    RNG streams, central FD at eps 0.01 (about 10^3 Fresnel branch flips)
    against autograd, within 5%."""
    import math

    from pathtracer_tpu_torch.ops import rng as prng
    from pathtracer_tpu_torch.ops.bsdf import LaneMaterials, scatter_ray

    n = 1 << 19
    lanes = torch.arange(n, dtype=torch.int32)
    st = prng.decision_state(7, 1, 0, lanes)
    u_pick, u1, u2, u_fres, ua, ub = prng.fast_uniforms_perlane(st, 6)
    phi = 2.0 * math.pi * ua
    cos_t = 0.05 + 0.9 * ub
    sin_t = torch.sqrt(1.0 - cos_t * cos_t)
    d = Vec3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), -cos_t)
    zero, one = torch.zeros(n), torch.ones(n)
    normal = Vec3(zero, zero, one)
    hit = Vec3(zero, zero, zero)

    def loss(ior):
        m = LaneMaterials(
            color=Vec3(0.2 * one, 0.5 * one, 0.9 * one),
            specular_color=Vec3(one, 0.8 * one, 0.6 * one),
            has_reflective=zero, has_refractive=one, ior=ior * one,
            emittance=zero)
        r = scatter_ray(d, hit, normal, m, u_pick, u1, u2, u_fres)
        smooth = (3.0 + r.direction.x + 2.0 * r.direction.y
                  + r.direction.z) / 6.0
        f = (r.throughput.x + r.throughput.y + r.throughput.z) * smooth
        return f.mean()

    at = torch.tensor(1.55)
    _, g = value_and_grad(loss, at)
    eps = 0.01
    with torch.no_grad():
        fd = (float(loss(at + eps)) - float(loss(at - eps))) / (2 * eps)
    assert np.isfinite(float(g)) and abs(fd) > 1e-4
    assert float(g) == pytest.approx(fd, rel=0.05), f"AD {g} vs FD {fd}"


@pytest.mark.parametrize("param", ["albedo", "emittance"])
def test_grad_matches_finite_difference(param):
    """The three largest-|grad| coordinates against central differences
    (eps 1e-3), as tests/test_grad.py does, on the port alone."""
    _, _, scene, settings = _scenes("cornell", 32, 3)
    loss, p0 = port_loss(scene, settings, param)
    _, g = value_and_grad(loss, p0)
    flat = g.numpy().ravel()
    assert np.isfinite(flat).all()
    p0 = p0.numpy().astype(np.float64)
    eps, checked = 1e-3, 0
    with torch.no_grad():
        for i in np.argsort(-np.abs(flat))[:3]:
            if abs(flat[i]) < 1e-6:
                continue
            dp = np.zeros_like(p0).ravel()
            dp[i] = eps
            dp = dp.reshape(p0.shape)
            lp = float(loss(torch.tensor(p0 + dp, dtype=torch.float32)))
            lm = float(loss(torch.tensor(p0 - dp, dtype=torch.float32)))
            fd = (lp - lm) / (2 * eps)
            assert fd == pytest.approx(flat[i], rel=0.05, abs=1e-5), (
                f"{param}[{i}]: autodiff {flat[i]} vs FD {fd}")
            checked += 1
    assert checked >= 1


@pytest.fixture(scope="module")
def teapot_jnp_grad():
    j_scene, j_set, scene, settings = _scenes("teapot", 24, 3,
                                              bvh_impl="jnp")
    _, g = value_and_grad(*port_loss(scene, settings, "albedo"))
    return g.numpy(), jax_grad(j_scene, j_set, "albedo")


def test_teapot_jnp_albedo_grad_matches_jax(teapot_jnp_grad):
    """The port's "jnp" walk against the JAX package's, through the whole
    bounce loop on a mesh scene."""
    g, want = teapot_jnp_grad
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(g, want, rtol=0, atol=1e-6)


def test_teapot_binned_albedo_grad_matches_jnp(teapot_jnp_grad):
    """tests/test_grad.py test_mesh_albedo_grad_binned_matches_jnp, in the
    port: the binned intersector's hits are constants, and the material
    gradient depends on the geometry only through their values."""
    _, _, scene, settings = _scenes("teapot", 24, 3)
    assert settings.bvh_impl == "binned"
    _, g = value_and_grad(*port_loss(scene, settings, "albedo"))
    np.testing.assert_allclose(g.numpy(), teapot_jnp_grad[0], rtol=1e-5,
                               atol=1e-7)


@pytest.fixture(scope="module")
def teapot_camera_grad_jax():
    """JAX's camera-position gradient on the teapot ("jnp"; every other
    intersector of the JAX package returns its hits under stop_gradient)."""
    j_scene, j_set, _, _ = _scenes("teapot", 16, 2, bvh_impl="jnp")
    return jax_grad(j_scene, j_set, "cam_pos")


@pytest.mark.parametrize("impl", ["binned", "wide", "wide_nosort", "pallas",
                                  "sorted", "brute"])
def test_mesh_intersectors_stop_gradient(impl, teapot_camera_grad_jax):
    """With the camera position requiring grad on a mesh scene, every
    intersector but "jnp" runs without a graph (its plain version writes
    hits in place from rays that carry one) and gives the JAX package's
    gradient, zero."""
    scene, settings = load_scene(scene_path("teapot"), "cpu", bvh_impl=impl,
                                 overrides={"RES": [16, 16], "DEPTH": 2})
    with torch.autograd.detect_anomaly():
        value, g = value_and_grad(*port_loss(scene, settings, "cam_pos"))
    assert np.isfinite(float(value))
    np.testing.assert_array_equal(g.numpy(), teapot_camera_grad_jax)
    np.testing.assert_array_equal(g.numpy(), np.zeros(3, np.float32))


def test_mesh_hits_are_constants_except_through_jnp():
    """intersect_scene on rays that require grad: where the teapot wins, t
    has a gradient through "jnp" and none through "binned"; the analytic
    walls' t keeps its gradient either way."""
    scene, settings = load_scene(scene_path("teapot"), "cpu", bvh_impl="jnp",
                                 overrides={"RES": [24, 24], "DEPTH": 1})
    n = settings.pixel_count
    g = np.random.default_rng(0)
    d = Vec3(*map(torch.from_numpy, g.normal(0, 1, (3, n)).astype(
        np.float32)))
    teapot_mat = int(scene.triangles.material_id[0])
    grads = {}
    for impl in ("jnp", "binned"):
        ox = torch.full((n,), 0.0, requires_grad=True)
        o = Vec3(ox, torch.full((n,), 3.0), torch.full((n,), 0.5))
        t, _, m = intersect.intersect_scene(scene, settings.geom_types, o, d,
                                            bvh_impl=impl)
        (gx,) = torch.autograd.grad(t.sum(), ox)
        grads[impl] = (gx.numpy(), m.numpy())
    gj, mj = grads["jnp"]
    gb, mb = grads["binned"]
    np.testing.assert_array_equal(mj, mb)
    on_mesh = mj == teapot_mat
    walls = (mj >= 0) & ~on_mesh
    assert on_mesh.sum() > 10 and walls.sum() > 10
    assert (gb[on_mesh] == 0).all() and (gj[on_mesh] != 0).any()
    np.testing.assert_array_equal(gb[walls], gj[walls])
    assert (gb[walls] != 0).any()


def test_albedo_fit_step_matches_jax():
    """One step of tools/fit_albedo.albedo_fit_step against the JAX
    package's on a 1-device mesh (make_ray_mesh(1): no interleave, and the
    fast RNG ignores the shard's key salt), from the same perturbed albedo
    against the same target."""
    from pathtracer_tpu.parallel.sharding import (albedo_fit_step as
                                                  j_albedo_fit_step)
    from pathtracer_tpu.parallel.sharding import make_ray_mesh, replicate
    from pathtracer_tpu_torch.tools.fit_albedo import (albedo_fit_step,
                                                       perturbed_albedo)

    j_scene, j_set, scene, settings = _scenes("cornell", 16, 2)
    with torch.no_grad():
        target = render_iteration(scene, settings,
                                  zero_accum(settings, "cpu"), 1, seed=0,
                                  early_exit=False)
    wrong = perturbed_albedo(scene.materials.color.numpy(), 0.25)
    new, loss = albedo_fit_step(
        with_materials(scene, color=torch.tensor(wrong, dtype=torch.float32)),
        settings, target, 1, lr=1.0, seed=0)
    mesh = make_ray_mesh(1)
    j_wrong = replicate(j_scene._replace(materials=j_scene.materials._replace(
        color=jnp.asarray(wrong, jnp.float32))), mesh)
    j_new, j_loss = j_albedo_fit_step(
        j_wrong, j_set, mesh, JVec3(*(jnp.asarray(c.numpy()) for c in target)),
        jnp.int32(1), lr=1.0, seed=0)
    assert float(loss) > 1e-4
    assert float(loss) == pytest.approx(float(j_loss), abs=1e-6)
    np.testing.assert_allclose(new.materials.color.numpy(),
                               np.asarray(j_new.materials.color), atol=1e-6)
    assert not np.allclose(new.materials.color.numpy(), wrong)


def test_ior_fit_step_matches_jax():
    """One step of tools/fit_ior.ior_fit_step against tools/fit_ior.py's
    step, written out in JAX (its step is local to that script's main):
    the spp-average, the loss, clip, momentum, clamp and mask."""
    from pathtracer_tpu_torch.tools.fit_ior import ior_fit_step, render_avg

    spp, lr, seed = 2, 0.08, 1
    j_scene, j_set, scene, settings = _scenes("glass_slab", 16, 4)
    with torch.no_grad():
        target = render_avg(scene, settings, spp, seed)
    ior0 = torch.where(scene.materials.has_refractive > 0,
                       scene.materials.ior + 0.2, scene.materials.ior)
    vel0 = torch.full_like(ior0, 0.05)
    ior, vel, loss = ior_fit_step(scene, settings, ior0, vel0, target, seed,
                                  spp, lr)

    refr = jnp.asarray(scene.materials.has_refractive.numpy() > 0)
    j_target = JVec3(*(jnp.asarray(c.numpy()) for c in target))

    def loss_fn(x):
        s = j_scene._replace(materials=j_scene.materials._replace(ior=x))
        acc = j_zero_accum(j_set)
        for k in range(spp):
            acc = j_render_it(s, j_set, acc, jnp.int32(k + 1), seed=seed,
                              early_exit=False)
        d = acc * (1.0 / spp) - j_target
        return jnp.mean(d.x * d.x + d.y * d.y + d.z * d.z)

    j_loss, g = jax.jit(jax.value_and_grad(loss_fn))(
        jnp.asarray(ior0.numpy()))
    g = jnp.clip(g, -2.0, 2.0)
    j_vel = 0.6 * jnp.asarray(vel0.numpy()) + g * refr.astype(jnp.float32)
    j_ior = jnp.where(refr, jnp.clip(jnp.asarray(ior0.numpy()) - lr * j_vel,
                                     1.05, 3.0), j_scene.materials.ior)
    assert float(loss) > 1e-5
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    np.testing.assert_allclose(vel.numpy(), np.asarray(j_vel), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(ior.numpy(), np.asarray(j_ior), rtol=0,
                               atol=1e-6)
    assert float(ior[2]) != float(ior0[2])


@pytest.mark.parametrize("name,bvh", [("cornell", None), ("teapot", None),
                                      ("teapot", "jnp"),
                                      ("glass_slab", None)])
def test_validate_iteration_passes(name, bvh):
    from pathtracer_tpu_torch.utils.debug import validate_iteration

    scene, settings = load_scene(scene_path(name), "cpu", bvh_impl=bvh,
                                 overrides={"RES": [16, 16], "DEPTH": 3})
    validate_iteration(scene, settings)


def test_validate_iteration_raises_on_nan():
    from pathtracer_tpu_torch.utils.debug import validate_iteration

    scene, settings = load_scene(scene_path("cornell"), "cpu",
                                 overrides={"RES": [16, 16], "DEPTH": 3})
    color = scene.materials.color.clone()
    color[1, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite"):
        validate_iteration(with_materials(scene, color=color), settings)


def test_value_and_grad_zero_where_unused():
    """Coordinates the loss never reads get zero gradient, and a loss with
    no graph gives all zeros, as jax.grad does."""
    p = torch.tensor([1.0, 2.0, 3.0])
    value, g = value_and_grad(lambda x: (x[:2] ** 2).sum(), p)
    assert float(value) == 5.0
    np.testing.assert_array_equal(g.numpy(), [2.0, 4.0, 0.0])
    value, g = value_and_grad(lambda x: torch.tensor(7.0), p)
    assert float(value) == 7.0 and not g.any() and g.shape == p.shape
    assert not p.requires_grad


def test_with_materials_replaces_only_the_named_fields():
    """utils/grad.with_materials returns a new scene whose named material
    fields are the given tensors; every other field is the original's, and
    the original scene is left as it was."""
    scene, _ = load_scene(scene_path("cornell"), "cpu",
                          overrides={"RES": [8, 8]})
    color = torch.zeros_like(scene.materials.color)
    ior = torch.full_like(scene.materials.ior, 2.0)
    new = with_materials(scene, color=color, ior=ior)
    assert new.materials.color is color and new.materials.ior is ior
    for f in dataclasses.fields(scene.materials):
        if f.name not in ("color", "ior"):
            assert (getattr(new.materials, f.name)
                    is getattr(scene.materials, f.name)), f.name
    assert new.geoms is scene.geoms and new.camera is scene.camera
    assert scene.materials.color.any() and not (scene.materials.ior
                                                == 2.0).all()


def test_fit_albedo_command_line(capsys):
    from pathtracer_tpu_torch.tools import fit_albedo

    assert fit_albedo.main([scene_path("cornell"), "--steps", "2", "--res",
                            "8", "--depth", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out and "final albedo MAE" in out


def test_fit_ior_command_line(capsys):
    """A short run: the exit code says whether the error halved (it need
    not in 2 steps); the run must reach its report."""
    from pathtracer_tpu_torch.tools import fit_ior

    rc = fit_ior.main(["--steps", "2", "--res", "8", "--depth", "3",
                       "--spp", "1", "--device", "cpu"])
    assert rc in (0, 1)
    out = capsys.readouterr().out
    assert "refractive materials: [2]" in out and "ior error:" in out


@pytest.mark.parametrize("tool", ["fit_albedo", "fit_ior"])
def test_fit_tools_need_a_card_unless_asked_for_the_cpu(monkeypatch, tool):
    import importlib

    mod = importlib.import_module(f"pathtracer_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--steps", "1"])


def test_material_gather_forms_agree():
    """ops/bsdf.py gather_material (index_select, whose backward is
    index_add_) gives the values and the gradient of advanced indexing
    (`table[mid]`, the JAX package's form) on ids that include misses."""
    from pathtracer_tpu_torch.ops.bsdf import gather_material

    scene, _ = load_scene(scene_path("cornell"), "cpu",
                          overrides={"RES": [8, 8]})
    mat_id = torch.from_numpy(np.random.default_rng(0).integers(
        -1, 5, 4096).astype(np.int32))
    mid = torch.clamp(mat_id, min=0).long()
    w = torch.arange(4096, dtype=torch.float32)
    mats = scene.materials
    m = gather_material(mats, mat_id)
    for got, table in ((m.color, mats.color),
                       (m.specular_color, mats.specular_color)):
        for c in range(3):
            assert torch.equal(got[c], table[:, c][mid])
    for name in ("has_reflective", "has_refractive", "ior", "emittance"):
        assert torch.equal(getattr(m, name), getattr(mats, name)[mid]), name
    grads = []
    for gather in (lambda c: gather_material(
                       with_materials(scene, color=c).materials,
                       mat_id).color,
                   lambda c: Vec3(c[:, 0][mid], c[:, 1][mid], c[:, 2][mid])):
        color = mats.color.detach().requires_grad_(True)
        col = gather(color)
        (g,) = torch.autograd.grad((col.x * w + col.z).sum(), color)
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=0)
    assert grads[0][:, 1].abs().sum() == 0 and grads[0][:, 0].abs().min() > 0
