"""PyTorch port, the brute-force intersector (ops/brute.py) against the JAX
package's mesh_intersect_brute (its Pallas kernel in interpret mode, as its
own tests run it) and against the port's packet walk.

The TPU kernel sums each of its four 16-term linear forms in a matrix
product (an XLA dot on the CPU, in its own summation order); the port sums
them term by term. So t agrees within rtol 1e-4, atol 1e-5, the tolerance
tests/test_intersect.py:374 holds brute to the packet walk; the hit set and
the material ids must be equal. Normals: atol 1e-5 (u and v come from the
same forms).
"""
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu import load_scene as jax_load_scene
from pathtracer_tpu.ops.bvh_pallas import mesh_intersect_brute as j_brute
from pathtracer_tpu.ops.intersect import intersect_scene as j_intersect
from pathtracer_tpu.scene.types import pack_tris_mxu as j_pack_tris_mxu
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch import load_scene
from pathtracer_tpu_torch.ops import brute, bvh_packet
from pathtracer_tpu_torch.ops.intersect import intersect_scene
from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.scene.types import MXU_TRI_TILE, pack_tris_mxu
from pathtracer_tpu_torch.utils.vec import Vec3

torch.set_num_threads(2)

FLT_MAX = 3.402823466e38
N_TRIS = 1100     # three 512-triangle tiles
N_RAYS = 1024


def _soup(seed):
    """A random triangle soup of three tiles in which the last 64 triangles
    repeat the first 64 with other materials (7..13 instead of 0..6): a ray
    that hits one of them meets equal t in tile 0 and in tile 2, and the
    first in table order must win, as the TPU kernel's strict improvement
    across tiles gives."""
    r = np.random.default_rng(seed)
    v = r.normal(0, 1.5, (N_TRIS, 3, 3)).astype(np.float32)
    v[:, :, 2] -= 3.0
    v[-64:] = v[:64]
    n = r.normal(size=(N_TRIS, 3, 3)).astype(np.float32)
    mat = (np.arange(N_TRIS) % 7).astype(np.int32)
    mat[-64:] += 7
    return {"v0": v[:, 0], "v1": v[:, 1], "v2": v[:, 2], "n0": n[:, 0],
            "n1": n[:, 1], "n2": n[:, 2], "material_id": mat}


class BruteTables(NamedTuple):
    """The two fields of a JAX SceneArrays that mesh_intersect_brute
    reads, so the soup's tables keep its triangle order."""
    tris_mxu_c: jnp.ndarray
    tris_mxu_n: jnp.ndarray


def _rays(seed, n=N_RAYS):
    r = np.random.default_rng(seed)
    o = r.normal(0, 2.0, (3, n)).astype(np.float32)
    o[2] += 4.0
    target = r.normal(0, 1.5, (3, n)).astype(np.float32)
    target[2] -= 3.0
    d = (target - o).astype(np.float32)
    return o, d


def _port_brute(tables, o, d):
    return brute.brute_plain(*(torch.from_numpy(np.asarray(t))
                               for t in tables),
                             *map(torch.from_numpy, o),
                             *map(torch.from_numpy, d))


def _assert_close_hits(port, ref):
    tp, mp = port[0].numpy(), port[2].numpy()
    tj, mj = np.asarray(ref[0]), np.asarray(ref[2])
    bad = ((tp > 0) != (tj > 0)) | (mp != mj)
    assert not bad.any(), (f"{int(bad.sum())} lanes differ in hit or "
                           f"material, first {np.nonzero(bad)[0][:5]}")
    np.testing.assert_allclose(tp, tj, rtol=1e-4, atol=1e-5)
    for a, b in zip(port[1], ref[1]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    return int((tj > 0).sum())


def test_brute_plain_matches_jax_on_three_tiles():
    tris = _soup(0)
    tables = pack_tris_mxu(tris)
    j_tables = BruteTables(*j_pack_tris_mxu(tris))
    assert tables[1].shape[0] == 3 * MXU_TRI_TILE
    for a, b in zip(tables, j_tables):
        np.testing.assert_array_equal(a, np.asarray(b))
    o, d = _rays(1)
    t, n, m = j_brute(j_tables, JVec3(*map(jnp.asarray, o)),
                      JVec3(*map(jnp.asarray, d)), interpret=True)
    port = _port_brute(tables, o, d)
    assert _assert_close_hits((port[0], port[1:4], port[4]),
                              (t, n, m)) > 300
    # lanes whose winner is one of the repeated triangles (the first 64
    # alone give the same t): the copy in tile 0 won, in both packages
    first = _port_brute(pack_tris_mxu({k: v[:64] for k, v in tris.items()}),
                        o, d)
    tie = (first[0] > 0) & (first[0] == port[0])
    assert int(tie.sum()) > 5
    assert (port[4][tie] < 7).all()


def test_brute_plain_chunks_give_one_result():
    """The plain version's ray blocks do not change a ray's result."""
    o, d = _rays(3, 300)
    args = (*map(torch.from_numpy, pack_tris_mxu(_soup(2))),
            *map(torch.from_numpy, o), *map(torch.from_numpy, d))
    whole = brute.brute_plain(*args)
    for got in (brute.brute_plain(*args, chunk=7 * 1536),
                brute.brute_plain(*args, chunk=1)):
        for a, b in zip(got, whole):
            assert torch.equal(a, b)


def test_intersect_scene_brute_matches_jax():
    """Teapot (six boxes and a 6,320-triangle mesh in 13 tiles) through
    bvh_impl="brute" in both packages."""
    j_scene, j_set = jax_load_scene(scene_path("teapot"), brute_tables=True)
    p_scene, p_set = load_scene(scene_path("teapot"), "cpu",
                                brute_tables=True)
    r = np.random.default_rng(4)
    o = r.uniform(-5, 5, size=(3, N_RAYS)).astype(np.float32)
    d = r.normal(size=(3, N_RAYS)).astype(np.float32)
    d[:, :N_RAYS // 2] = -o[:, :N_RAYS // 2] + r.normal(
        size=(3, N_RAYS // 2)).astype(np.float32)
    act = r.uniform(size=N_RAYS) < 0.7
    tj, nj, mj = j_intersect(j_scene, j_set.geom_types,
                             JVec3(*map(jnp.asarray, o)),
                             JVec3(*map(jnp.asarray, d)), bvh_impl="brute",
                             active=jnp.asarray(act))
    port = intersect_scene(p_scene, p_set.geom_types,
                           Vec3(*map(torch.from_numpy, o)),
                           Vec3(*map(torch.from_numpy, d)),
                           bvh_impl="brute", active=torch.from_numpy(act))
    assert _assert_close_hits(port, (tj, nj, mj)) > 500
    # and the packet walk finds the same hits on the mesh
    walk = bvh_packet.mesh_intersect_packet(
        p_scene, p_scene.mesh_roots[0], Vec3(*map(torch.from_numpy, o)),
        Vec3(*map(torch.from_numpy, d)))
    mesh = brute.mesh_intersect_brute(p_scene, Vec3(*map(torch.from_numpy,
                                                         o)),
                                      Vec3(*map(torch.from_numpy, d)))
    assert _assert_close_hits(mesh, walk) > 100


def test_brute_needs_its_tables():
    scene, settings = load_scene(scene_path("teapot"), "cpu")
    assert scene.tris_mxu_n.shape[0] == 0
    o = Vec3(*(torch.zeros(4) for _ in range(3)))
    d = Vec3(*(torch.ones(4) for _ in range(3)))
    with pytest.raises(ValueError, match="brute_tables"):
        intersect_scene(scene, settings.geom_types, o, d, bvh_impl="brute")
    # a meshless scene has nothing to reject
    c_scene, c_set = load_scene(scene_path("cornell"), "cpu")
    t, _, _ = intersect_scene(c_scene, c_set.geom_types, o, d,
                              bvh_impl="brute")
    assert t.shape == (4,)


def test_pack_tris_mxu_forms():
    """Each coefficient row times the features of a ray gives the
    Moller-Trumbore quantities of that (ray, triangle) pair: a, u*a, v*a and
    t*a (checked in float64 against the textbook formulas)."""
    tris = _soup(5)
    coeffs, attrs = pack_tris_mxu(tris)
    o, d = (x[:, 0].astype(np.float64) for x in _rays(6, 1))
    f = np.concatenate([d, o, np.cross(o, d), [1.0], np.zeros(6)])
    c = coeffs.reshape(-1, 4, MXU_TRI_TILE, 16).transpose(1, 0, 2, 3)
    forms = c.reshape(4, -1, 16)[:, :N_TRIS].astype(np.float64) @ f
    v0, v1, v2 = (tris[k].astype(np.float64) for k in ("v0", "v1", "v2"))
    e1, e2 = v1 - v0, v2 - v0
    h = np.cross(d, e2)
    a = (e1 * h).sum(1)
    s = o - v0
    q = np.cross(s, e1)
    want = [a, (s * h).sum(1), (q * d).sum(1), (q * e2).sum(1)]
    for got, ref in zip(forms, want):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(attrs[:N_TRIS, 9], tris["material_id"])
    assert (attrs[N_TRIS:] == 0).all()
