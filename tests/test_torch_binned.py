"""PyTorch port, binned mesh intersection, on teapot tables carried over from
the JAX package (scene_from_jax_arrays), so both packages intersect the very
same tables.

On the CPU each wrapper runs its kernel's plain PyTorch version; these tests
hold those against the JAX package (Pallas in interpret mode, as its own
tests run it) and against a numpy oracle. Tolerances, and why:
  - cull (id, t0): exact. The slab test is subtractions, multiplications and
    min/max only, which no compiler contracts.
  - stream vs the numpy oracle: exact (both round every operation).
  - packet walk and the whole pipeline vs JAX as its tests run it: the hit
    set and the material ids are exact; t within 1e-6 relative, because
    XLA's CPU backend contracts the Moller-Trumbore multiply-adds into FMAs
    (tests/test_torch_ops.py test_xla_cpu_contracts_multiply_adds) and the
    port rounds each operation. Measured: 97% of t values bit-equal, the
    rest within 5e-7 absolute.
  - the same against JAX with FMA contraction off (a subprocess with
    XLA_FLAGS=--xla_cpu_max_isa=AVX, whose ISA has no FMA): t and material
    ids bit-equal on every active lane.
  - normals, always: 1e-6 absolute. JAX normalizes with lax.rsqrt, the
    port's kernels with 1/sqrt (so that they match their plain versions on
    the GPU bit for bit); measured within 1.2e-7.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pathtracer_tpu import load_scene as jax_load_scene
from pathtracer_tpu.ops import binned as j_binned
from pathtracer_tpu.ops.bvh_pallas import mesh_intersect_packet as j_packet
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch.ops import binned
from pathtracer_tpu_torch.ops.bvh_packet import mesh_intersect_packet
from pathtracer_tpu_torch.scene.fixtures import REPO_ROOT, scene_path
from pathtracer_tpu_torch.scene.loader import scene_from_jax_arrays
from pathtracer_tpu_torch.scene.types import TREELET_NONE
from pathtracer_tpu_torch.utils.vec import Vec3
from test_torch_kernels import plane_rays, tie_rays, write_tie_scene

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
    j_scene, j_set = jax_load_scene(scene_path("teapot"))
    return j_scene, j_set, scene_from_jax_arrays(jax_leaves(j_scene), "cpu")


def _rays(seed, n=N):
    """Random rays (as tests/test_binned.py makes them), a random active
    mask, and a bound that is finite on half the lanes."""
    r = np.random.default_rng(seed)
    o = r.uniform(-5, 5, size=(3, n)).astype(np.float32)
    d = r.normal(size=(3, n)).astype(np.float32)
    act = r.uniform(size=n) < 0.6
    tb = np.where(r.uniform(size=n) < 0.5, r.uniform(2, 12, size=n),
                  FLT_MAX).astype(np.float32)
    return o, d, act, tb


def _aimed_rays(scene, seed, n=N):
    """Rays aimed at random points of the mesh's root box, so most lanes
    want several treelets."""
    r = np.random.default_rng(seed)
    root = scene.mesh_roots[0]
    lo = np.array([scene.bvh.min_x[root], scene.bvh.min_y[root],
                   scene.bvh.min_z[root]], np.float32)
    hi = np.array([scene.bvh.max_x[root], scene.bvh.max_y[root],
                   scene.bvh.max_z[root]], np.float32)
    target = lo[:, None] + r.uniform(size=(3, n)) * (hi - lo)[:, None]
    o = (target + r.normal(size=(3, n)) * 4.0).astype(np.float32)
    d = (target - o).astype(np.float32)
    return o, d


def _jax_cull(j_scene, o, d, bound, pt0, pid, live, k=1):
    """The JAX package's _cull_kernel with k_wants=k on the given planes,
    launched as mesh_intersect_binned launches it (binned.py:839), in
    interpret mode: (ids, t0) planes [n] for k = 1, [k, n] for k > 1."""
    rows = o.shape[1] // 128
    ray_spec = pl.BlockSpec((j_binned.CULL_ROWS, 128), lambda i: (i, 0),
                            memory_space=pltpu.VMEM)
    table_spec = pl.BlockSpec(memory_space=pltpu.VMEM)
    planes = [*o, *d, bound, pt0, pid, live]
    out = pl.pallas_call(
        functools.partial(j_binned._cull_kernel, k_wants=k),
        grid=(rows // j_binned.CULL_ROWS,),
        in_specs=[table_spec, table_spec] + [ray_spec] * 10,
        out_specs=[ray_spec] * (2 * k),
        out_shape=[jax.ShapeDtypeStruct((rows, 128), jnp.int32),
                   jax.ShapeDtypeStruct((rows, 128), jnp.float32)] * k,
        interpret=True,
    )(j_scene.treelet_f, j_scene.treelet_super,
      *(jnp.asarray(p.reshape(rows, 128)) for p in planes))
    ids = np.stack([np.asarray(out[2 * s]).reshape(-1) for s in range(k)])
    t0s = np.stack([np.asarray(out[2 * s + 1]).reshape(-1)
                    for s in range(k)])
    return (ids[0], t0s[0]) if k == 1 else (ids, t0s)


def test_cull_plain_matches_jax_cull_kernel(teapot):
    """Two enumeration steps: from the start state, then resuming strictly
    after the first step's (t0, id)."""
    j_scene, _, scene = teapot
    o, d = _aimed_rays(scene, 0)
    r = np.random.default_rng(1)
    bound = np.where(r.uniform(size=N) < 0.3, r.uniform(1, 8, size=N),
                     FLT_MAX).astype(np.float32)
    live = (r.uniform(size=N) < 0.8).astype(np.int32)
    pt0 = np.full(N, -FLT_MAX, np.float32)
    pid = np.full(N, -1, np.int32)
    t = lambda a: torch.from_numpy(np.array(a))
    for step in range(2):
        j_id, j_t0 = _jax_cull(j_scene, o, d, bound, pt0, pid, live)
        p_id, p_t0 = binned.cull(scene.treelet_f, scene.treelet_super,
                                 *map(t, o), *map(t, d), t(bound), t(pt0),
                                 t(pid), t(live))
        np.testing.assert_array_equal(p_id.numpy(), j_id)
        np.testing.assert_array_equal(p_t0.numpy(), j_t0)
        assert (j_id < TREELET_NONE).mean() > 0.3, step
        pt0, pid = j_t0, j_id


@pytest.fixture(scope="module")
def tie(tmp_path_factory):
    """The tie scene (tests/test_torch_kernels.py write_tie_scene) as both
    packages load it: one coincident group of 150 triangles in two treelets
    of equal boxes, ids 0 and 1, and one of 40 in treelet 2."""
    path = write_tie_scene(str(tmp_path_factory.mktemp("tie")))
    j_scene, _ = jax_load_scene(path)
    return j_scene, scene_from_jax_arrays(jax_leaves(j_scene), "cpu")


def _cull_steps(j_scene, scene, o, d, bound, steps):
    """`steps` enumeration steps of every lane from the start state, each
    resuming strictly after the last step's (t0, id): cull_plain against
    the JAX kernel, ids equal and t0 equal in its bits (so in the sign of a
    zero). Returns each step's (ids, t0)."""
    n = o.shape[1]
    live = np.ones(n, np.int32)
    pt0 = np.full(n, -FLT_MAX, np.float32)
    pid = np.full(n, -1, np.int32)
    t = lambda a: torch.from_numpy(np.array(a))
    out = []
    for _ in range(steps):
        j_id, j_t0 = _jax_cull(j_scene, o, d, bound, pt0, pid, live)
        p_id, p_t0 = binned.cull_plain(scene.treelet_f, scene.treelet_super,
                                       *map(t, o), *map(t, d), t(bound),
                                       t(pt0), t(pid), t(live))
        np.testing.assert_array_equal(p_id.numpy(), j_id)
        np.testing.assert_array_equal(p_t0.numpy().view(np.int32),
                                      j_t0.view(np.int32))
        out.append((j_id, j_t0))
        pt0, pid = j_t0, j_id
    return out


def test_cull_plain_breaks_treelet_ties_as_jax(tie):
    """Treelets 0 and 1 have equal boxes, so every ray at the first group
    ties on t0: the lower id comes first, the other next at the same t0,
    then nothing; the second group's rays want treelet 2 alone."""
    j_scene, scene = tie
    o, d, group = tie_rays(N, 3)
    bound = np.full(N, FLT_MAX, np.float32)
    (id0, t00), (id1, t01), (id2, _) = _cull_steps(j_scene, scene, o, d,
                                                   bound, 3)
    g0 = group == 0
    assert (id0[g0] == 0).all() and (id1[g0] == 1).all()
    np.testing.assert_array_equal(t01[g0], t00[g0])
    assert (id0[~g0] == 2).all() and (id1[~g0] == TREELET_NONE).all()
    assert (id2 == TREELET_NONE).all()


def test_cull_plain_on_box_faces_matches_jax_bits(teapot):
    """Origins exactly on treelet box faces enter boxes at t0 = +0 or -0:
    ids and the bits of t0 as JAX's, over two enumeration steps."""
    j_scene, _, scene = teapot
    o, d = plane_rays(scene.treelet_f, N, 12)
    bound = np.full(N, FLT_MAX, np.float32)
    (ids, t0), _ = _cull_steps(j_scene, scene, o, d, bound, 2)
    zero = (t0 == 0) & (ids < TREELET_NONE)
    assert (zero & np.signbit(t0)).sum() > 50
    assert (zero & ~np.signbit(t0)).sum() > 50


@pytest.mark.parametrize("planes", [2, 3])
def test_cull_plain_on_box_edges_matches_jax_values(teapot, planes):
    """Origins on box edges and corners: a slab's t0 is then the max of two
    zeros of either sign, which torch's CPU maximum and XLA's may order
    differently, so t0 is held to JAX's value (-0 == +0); the ids, which
    decide the enumeration, exactly."""
    j_scene, _, scene = teapot
    o, d = plane_rays(scene.treelet_f, N, 20 + planes, planes)
    bound = np.full(N, FLT_MAX, np.float32)
    live = np.ones(N, np.int32)
    pt0 = np.full(N, -FLT_MAX, np.float32)
    pid = np.full(N, -1, np.int32)
    t = lambda a: torch.from_numpy(np.array(a))
    for _ in range(2):
        j_id, j_t0 = _jax_cull(j_scene, o, d, bound, pt0, pid, live)
        p_id, p_t0 = binned.cull_plain(scene.treelet_f, scene.treelet_super,
                                       *map(t, o), *map(t, d), t(bound),
                                       t(pt0), t(pid), t(live))
        np.testing.assert_array_equal(p_id.numpy(), j_id)
        np.testing.assert_array_equal(p_t0.numpy(), j_t0)
        assert ((j_t0 == 0) & (j_id < TREELET_NONE)).sum() > 50
        pt0, pid = j_t0, j_id


def _stream_oracle(scene, o, d, bound, tid):
    """Numpy, one triangle after another: the closest hit strictly below
    bound among treelet tid's rows, normal normalized and faced toward the
    ray with 1/sqrt as the kernels do."""
    ti = scene.treelet_i.numpy().reshape(-1, 4)
    tris = scene.tris_packed.numpy()
    ox, oy, oz = o
    dx, dy, dz = d
    t_min = bound.copy()
    n = np.zeros((3, o.shape[1]), np.float32)
    mat = np.full(o.shape[1], -1, np.int32)
    f32 = np.float32
    for lane in np.nonzero(tid < ti.shape[0])[0]:
        row0, n_rows = ti[tid[lane], 0], ti[tid[lane], 1]
        for row in range(row0, row0 + n_rows):
            for j in range(6):
                v = tris[row, 20 * j:20 * j + 20]
                hx = dy[lane] * v[8] - dz[lane] * v[7]
                hy = dz[lane] * v[6] - dx[lane] * v[8]
                hz = dx[lane] * v[7] - dy[lane] * v[6]
                a = v[3] * hx + v[4] * hy + v[5] * hz
                par = abs(a) < f32(1e-6)
                f = f32(1.0) / (f32(1.0) if par else a)
                sx, sy, sz = ox[lane] - v[0], oy[lane] - v[1], oz[lane] - v[2]
                u = f * (sx * hx + sy * hy + sz * hz)
                qx, qy, qz = (sy * v[5] - sz * v[4], sz * v[3] - sx * v[5],
                              sx * v[4] - sy * v[3])
                vv = f * (dx[lane] * qx + dy[lane] * qy + dz[lane] * qz)
                tt = f * (v[6] * qx + v[7] * qy + v[8] * qz)
                ok = (not par and 0 <= u <= 1 and vv >= 0 and u + vv <= 1
                      and tt >= f32(1e-6) and tt > 0 and tt < t_min[lane])
                if ok:
                    w = f32(1.0) - u - vv
                    t_min[lane] = tt
                    n[:, lane] = [w * v[9 + c] + u * v[12 + c]
                                  + vv * v[15 + c] for c in range(3)]
                    mat[lane] = np.int32(v[18])
    len2 = n[0] * n[0] + n[1] * n[1] + n[2] * n[2]
    inv = f32(1.0) / np.sqrt(np.maximum(len2, f32(1e-30)))
    fl = np.where(dx * n[0] + dy * n[1] + dz * n[2] > 0, -inv, inv)
    missed = t_min >= bound
    return (np.where(missed, f32(-1.0), t_min), n * fl,
            np.where(missed, -1, mat))


def test_stream_plain_matches_numpy_oracle(teapot):
    _, _, scene = teapot
    n = 512
    o, d = _aimed_rays(scene, 2, n)
    r = np.random.default_rng(3)
    bound = np.where(r.uniform(size=n) < 0.3, r.uniform(1, 8, size=n),
                     FLT_MAX).astype(np.float32)
    t = lambda a: torch.from_numpy(np.array(a))
    # each lane's nearest wanted treelet, as the first pass streams it
    tid, _ = binned.cull_plain(
        scene.treelet_f, scene.treelet_super, *map(t, o), *map(t, d),
        t(bound), torch.full((n,), -FLT_MAX), torch.full((n,), -1,
                                                          dtype=torch.int32),
        torch.ones(n, dtype=torch.int32))
    tid = tid.numpy()
    got = binned.stream(scene.treelet_i, scene.tris_packed, scene.tre_rows,
                        *map(t, o), *map(t, d), t(bound), t(tid))
    ref_t, ref_n, ref_m = _stream_oracle(scene, o, d, bound, tid)
    assert (ref_t > 0).sum() > 20
    np.testing.assert_array_equal(got[0].numpy(), ref_t)
    np.testing.assert_array_equal(got[4].numpy(), ref_m)
    hit = ref_t > 0
    for c in range(3):
        np.testing.assert_array_equal(got[1 + c].numpy()[hit], ref_n[c][hit])


def test_stream_plain_keeps_the_first_coincident_triangle(tie):
    """Every triangle of a coincident group ties on t: the stream of each
    ray's first treelet keeps the treelet's first one (m0, id 1, in
    treelet 0; m2, id 3, in treelet 2), as the numpy oracle does."""
    _, scene = tie
    o, d, group = tie_rays(N, 4)
    bound = np.full(N, FLT_MAX, np.float32)
    t = lambda a: torch.from_numpy(np.array(a))
    tid, _ = binned.cull_plain(
        scene.treelet_f, scene.treelet_super, *map(t, o), *map(t, d),
        t(bound), torch.full((N,), -FLT_MAX),
        torch.full((N,), -1, dtype=torch.int32),
        torch.ones(N, dtype=torch.int32))
    got = binned.stream(scene.treelet_i, scene.tris_packed, scene.tre_rows,
                        *map(t, o), *map(t, d), t(bound), tid)
    ref_t, ref_n, ref_m = _stream_oracle(scene, o, d, bound, tid.numpy())
    np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                  ref_t.view(np.int32))
    np.testing.assert_array_equal(got[4].numpy(), ref_m)
    for c in range(3):
        np.testing.assert_array_equal(got[1 + c].numpy(), ref_n[c])
    assert (ref_m[group == 0] == 1).all() and (ref_m[group == 1] == 3).all()


def _assert_hits_match(port, ref, act, t_exact):
    """port: (t, Vec3, mat) tensors; ref: (t, [3, N] normals, mat) arrays.
    Returns the number of active lanes that hit."""
    tp, np_, mp = (port[0].numpy(), np.stack([c.numpy() for c in port[1]]),
                   port[2].numpy())
    tj, nj, mj = (np.asarray(r) for r in ref)
    tp, tj, mp, mj = tp[act], tj[act], mp[act], mj[act]
    np.testing.assert_array_equal(tp > 0, tj > 0)
    np.testing.assert_array_equal(mp, mj)
    if t_exact:
        np.testing.assert_array_equal(tp, tj)
    else:
        np.testing.assert_allclose(tp, tj, rtol=1e-6, atol=0)
    np.testing.assert_allclose(np_[:, act], nj[:, act], rtol=0, atol=1e-6)
    return (tj > 0).sum()


def _port(fn, o, d, act, tb, *lead, **kw):
    return fn(*lead, Vec3(*map(torch.from_numpy, o)),
              Vec3(*map(torch.from_numpy, d)),
              active=torch.from_numpy(act), t_bound=torch.from_numpy(tb),
              **kw)


# The JAX package's packet walk on _rays(5) and binned pipeline (its
# default, adaptive shape) on _rays(0), in interpret mode, in a process whose
# XLA may not use FMA instructions.
JAX_WITHOUT_FMA = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from pathtracer_tpu import load_scene
from pathtracer_tpu.ops.binned import mesh_intersect_binned
from pathtracer_tpu.ops.bvh_pallas import mesh_intersect_packet
from pathtracer_tpu.utils.vec import Vec3
rays = np.load(sys.argv[1])
scene, settings = load_scene(sys.argv[2])
roots = tuple(scene.geoms.root_node[i]
              for i, g in enumerate(settings.geom_types) if g == 2)
out = {}
for name in ("binned", "packet"):
    o, d, act, tb = (rays[name + "_" + k] for k in ("o", "d", "act", "tb"))
    args = (Vec3(*map(jnp.asarray, o)), Vec3(*map(jnp.asarray, d)))
    kw = dict(active=jnp.asarray(act), t_bound=jnp.asarray(tb),
              interpret=True)
    if name == "binned":
        t, n, m = mesh_intersect_binned(scene, roots, *args, **kw)
    else:
        t, n, m = mesh_intersect_packet(scene, roots[0], *args, **kw)
    out[name + "_t"] = np.asarray(t)
    out[name + "_n"] = np.stack([np.asarray(c) for c in n])
    out[name + "_m"] = np.asarray(m)
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def jax_without_fma(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_without_fma")
    rays = {}
    for name, seed in (("binned", 0), ("packet", 5)):
        for k, v in zip(("o", "d", "act", "tb"), _rays(seed)):
            rays[f"{name}_{k}"] = v
    np.savez(tmp / "rays.npz", **rays)
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


def test_packet_walk_matches_jax_on_active_lanes(teapot):
    """Against JAX as its own tests run it (FMA contraction on)."""
    j_scene, _, scene = teapot
    o, d, act, tb = _rays(5)
    root = scene.mesh_roots[0]
    t, n, m = j_packet(j_scene, root, JVec3(*map(jnp.asarray, o)),
                       JVec3(*map(jnp.asarray, d)), active=jnp.asarray(act),
                       t_bound=jnp.asarray(tb), interpret=True)
    port = _port(mesh_intersect_packet, o, d, act, tb, scene, root)
    ref = (t, np.stack([np.asarray(c) for c in n]), m)
    assert _assert_hits_match(port, ref, act, t_exact=False) > 50
    # inactive lanes report a miss
    assert (port[0].numpy()[~act] == -1.0).all()


def test_packet_walk_bit_equal_to_jax_without_fma(teapot, jax_without_fma):
    _, _, scene = teapot
    o, d, act, tb = _rays(5)
    port = _port(mesh_intersect_packet, o, d, act, tb, scene,
                 scene.mesh_roots[0])
    ref = tuple(jax_without_fma["packet_" + k] for k in ("t", "n", "m"))
    assert _assert_hits_match(port, ref, act, t_exact=True) > 50


@pytest.mark.parametrize("passes,fb_compact", [
    (None, None),   # teapot's adaptive default: 2 passes, no compaction
    (3, True),      # the big-mesh branches, forced
    (0, False),     # cull + fallback only
])
def test_mesh_intersect_binned_matches_jax(teapot, jax_without_fma, passes,
                                           fb_compact):
    """The result is the true closest hit whatever the pass count, so every
    pipeline shape is held against JAX's default one: t and material ids
    bit-equal on active lanes."""
    _, _, scene = teapot
    o, d, act, tb = _rays(0)
    port = _port(binned.mesh_intersect_binned, o, d, act, tb, scene,
                 scene.mesh_roots, passes=passes, fb_compact=fb_compact)
    ref = tuple(jax_without_fma["binned_" + k] for k in ("t", "n", "m"))
    assert _assert_hits_match(port, ref, act, t_exact=True) > 50
    # and bit for bit the port's own packet walk
    walk = _port(mesh_intersect_packet, o, d, act, tb, scene,
                 scene.mesh_roots[0])
    np.testing.assert_array_equal(port[0].numpy()[act], walk[0].numpy()[act])
    np.testing.assert_array_equal(port[2].numpy()[act], walk[2].numpy()[act])
    for a, b in zip(port[1], walk[1]):
        np.testing.assert_array_equal(a.numpy()[act], b.numpy()[act])
