"""PyTorch port, the mesh path's measurement layer against the JAX
package's, on the CPU: the ablation flags of ops/binned.py (FALLBACK,
STREAM_OFF, CULL_CHEAP), tools/sweep_mesh.py analytic_bound and
tools/diag_bins.py's per-pass statistics.

The rays are a teapot 32x32 bounce-ray pool made by the port
(tools/sweep_mesh.py make_bounce_rays), handed to both packages as numpy
arrays. JAX runs its pipeline as its own tests do (Pallas in interpret mode)
in a subprocess whose XLA may not contract multiply-adds into FMAs
(XLA_FLAGS=--xla_cpu_max_isa=AVX, as tests/test_torch_binned.py's
jax_without_fma): then t, the materials, the want ids of every pass and
the analytic bound are bit-equal; normals agree within 1e-6 (JAX
normalizes with rsqrt, the port with 1/sqrt).

One difference is by design: JAX's stream kernel tests every lane of a
2,048-lane block against every treelet the block wants, and its packet walk
every lane of a block that walks, so a lane can hold a hit from another
lane's treelet: a true hit, not always the closest. The port's kernels serve
a lane its own treelet, and active lanes only. The whole pipeline never
shows the extras (its images are bit-equal), but with a stage cut out
(FALLBACK=False, STREAM_OFF) a few lanes keep such a hit in JAX where the
port reports a miss; the flag tests hold every other lane bit for bit.
"""
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.ops import binned
from pathtracer_tpu_torch.scene.fixtures import REPO_ROOT, scene_path
from pathtracer_tpu_torch.tools import diag_bins, sweep_mesh
from pathtracer_tpu_torch.utils.vec import Vec3

torch.set_num_threads(2)

RES = 32
FLAGS = {"nofb": {"FALLBACK": False}, "streamoff": {"STREAM_OFF": True},
         "cullcheap": {"CULL_CHEAP": True}}

# JAX's analytic bound of the rays, and its binned pipeline under each
# ablation flag (FALLBACK=False with the debug_tids tap: the passes' want
# ids do not depend on the finish), in interpret mode, without FMA.
JAX_FLAGS = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import pathtracer_tpu.ops.binned as B
from pathtracer_tpu import load_scene
from pathtracer_tpu.utils.vec import Vec3
from tools.sweep_mesh import analytic_bound
rays = np.load(sys.argv[1])
scene, settings = load_scene(sys.argv[2])
roots = tuple(scene.geoms.root_node[i]
              for i, g in enumerate(settings.geom_types) if g == 2)
o = Vec3(*map(jnp.asarray, rays["o"]))
d = Vec3(*map(jnp.asarray, rays["d"]))
out = {"tb": np.asarray(analytic_bound(scene, settings, o, d))}
kw = dict(active=jnp.asarray(rays["hit"]), t_bound=jnp.asarray(rays["tb"]),
          interpret=True)
for name, flags in %r.items():
    saved = {k: getattr(B, k) for k in flags}
    for k, v in flags.items():
        setattr(B, k, v)
    B.mesh_intersect_binned.clear_cache()
    res = B.mesh_intersect_binned(scene, roots, o, d,
                                  debug_tids=name == "nofb", **kw)
    for k, v in saved.items():
        setattr(B, k, v)
    out[name + "_t"] = np.asarray(res[0])
    out[name + "_n"] = np.stack([np.asarray(c) for c in res[1]])
    out[name + "_m"] = np.asarray(res[2])
    if name == "nofb":
        for p, tid in enumerate(res[3]):
            out[f"tids_{p}"] = np.asarray(tid)
np.savez(sys.argv[3], **out)
""" % (FLAGS,)


@pytest.fixture(scope="module")
def pool():
    return sweep_mesh.make_pool(scene_path("teapot"), "cpu",
                                {"RES": [RES, RES]})


@pytest.fixture(scope="module")
def jax_ref(pool, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_flags")
    np.savez(tmp / "rays.npz",
             o=np.stack([c.numpy() for c in pool.o]),
             d=np.stack([c.numpy() for c in pool.d]),
             hit=pool.hit.numpy(), tb=pool.tb.numpy())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_max_isa=AVX").strip()
    res = subprocess.run(
        [sys.executable, "-c", JAX_FLAGS, str(tmp / "rays.npz"),
         scene_path("teapot"), str(tmp / "out.npz")],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = np.load(tmp / "out.npz")
    return {k: out[k] for k in out.files}


def test_analytic_bound_bit_equal_to_jax(pool, jax_ref):
    """The same rays give the same bound, bit for bit."""
    tb = sweep_mesh.analytic_bound(pool.scene, pool.settings, pool.o, pool.d)
    np.testing.assert_array_equal(tb.numpy().view(np.int32),
                                  jax_ref["tb"].view(np.int32))
    assert (jax_ref["tb"] < sweep_mesh.FLT_MAX).sum() > 100


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_ablation_flag_matches_jax(pool, jax_ref, name):
    """The port's pipeline under each flag gives JAX's (wrong on purpose)
    result: t and material bit-equal on active lanes, normals within
    1e-6; and the flag is restored after."""
    with sweep_mesh.flags(**FLAGS[name]):
        t, n, m = binned.mesh_intersect_binned(
            pool.scene, pool.roots, pool.o, pool.d, active=pool.hit,
            t_bound=pool.tb)
    assert (binned.FALLBACK, binned.STREAM_OFF, binned.CULL_CHEAP) == (
        True, False, False)
    full = binned.mesh_intersect_binned(pool.scene, pool.roots, pool.o,
                                        pool.d, active=pool.hit,
                                        t_bound=pool.tb)[0].numpy()
    act = pool.hit.numpy()
    tp, tj = t.numpy(), jax_ref[name + "_t"]
    # JAX's extra hits (module docstring): the port misses, JAX keeps a true
    # hit no closer than the closest one
    extra = act & (tp < 0) & (tj > 0)
    assert (tj[extra] >= full[extra]).all() and (full[extra] > 0).all()
    assert extra.sum() <= act.sum() // 50
    same = act & ~extra
    np.testing.assert_array_equal(tp[same].view(np.int32),
                                  tj[same].view(np.int32))
    np.testing.assert_array_equal(m.numpy()[same], jax_ref[name + "_m"][same])
    np.testing.assert_allclose(np.stack([c.numpy() for c in n])[:, same],
                               jax_ref[name + "_n"][:, same], rtol=0,
                               atol=1e-6)
    # each flag does cut its stage: without the finish or the stream lanes
    # lose their hits; without the cull every live lane wants treelet 0
    if name == "cullcheap":
        with sweep_mesh.flags(**FLAGS[name]):
            tids = diag_bins.pass_tids(pool)
        assert set(np.unique(np.concatenate(tids)).tolist()) == {
            0, binned.TREELET_NONE}
    else:
        assert ((full > 0) & (tp < 0)).sum() > 0


def jax_tool_lines(monkeypatch, capsys, tids, n_rays) -> list:
    """The JAX tool's (tools/diag_bins.py main) per-pass lines for these
    post-bin want ids: its loader, rays and pipeline replaced by stubs
    that hand it `tids`."""
    import pathtracer_tpu
    import pathtracer_tpu.ops.binned as jb
    import tools.sweep_mesh as js
    scene = types.SimpleNamespace(geoms=types.SimpleNamespace(root_node=[0]))
    settings = types.SimpleNamespace(geom_types=(2,))
    o = Vec3(*(jnp.zeros(n_rays) for _ in range(3)))
    monkeypatch.setattr(pathtracer_tpu, "load_scene",
                        lambda path: (scene, settings))
    monkeypatch.setattr(js, "make_bounce_rays",
                        lambda sc, st: (o, o, jnp.zeros(n_rays, bool)))
    monkeypatch.setattr(js, "analytic_bound",
                        lambda sc, st, o, d: jnp.zeros(n_rays))
    monkeypatch.setattr(jb, "mesh_intersect_binned",
                        lambda *a, **k: (None, None, None, tids))
    monkeypatch.setattr(sys, "argv", ["diag_bins.py", "scene.json"])
    from tools import diag_bins as jax_diag
    capsys.readouterr()
    jax_diag.main()
    return capsys.readouterr().out.splitlines()[1:]


def test_diag_bins_matches_jax(pool, jax_ref, monkeypatch, capsys):
    """The port's debug_tids equal JAX's pass for pass, and the port's
    statistics print the JAX tool's lines for them."""
    tids = diag_bins.pass_tids(pool)
    ref = [jax_ref[f"tids_{p}"] for p in range(len(tids))]
    assert f"tids_{len(tids)}" not in jax_ref and len(tids) == 2
    for got, want in zip(tids, ref):
        np.testing.assert_array_equal(got, want)
    lines = []
    stats = diag_bins.diagnose(pool, out=lines.append)
    assert stats[0]["live"] > 50 and stats[0]["visits"] >= stats[0]["blocks"]
    assert lines[1:] == jax_tool_lines(monkeypatch, capsys, ref,
                                       pool.o.x.shape[0])
    # and on a pool whose blocks are all empty
    empty = np.full_like(ref[0], binned.TREELET_NONE)
    assert diag_bins.pass_lines(0, diag_bins.pass_stats(empty)) == \
        jax_tool_lines(monkeypatch, capsys, [empty], pool.o.x.shape[0])
