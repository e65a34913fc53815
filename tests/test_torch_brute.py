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
from pathtracer_tpu_torch.scene.types import (BRUTE_TERMS, MXU_TRI_TILE,
                                              pack_tris_brute, pack_tris_mxu)
from pathtracer_tpu_torch.utils.vec import Vec3
from test_torch_kernels import (EXACT_CASES, _same_bits, brute_args,
                                exact_rays, exact_soup, plain_args)

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


@pytest.mark.parametrize("fault", ["table_doubled", "coeffs_doubled",
                                   "n_tris_past_the_table", "n_tris_negative"])
def test_brute_rejects_tables_that_disagree(fault):
    """The wrapper checks, on CPU tensors as on CUDA ones, that the table,
    its triangle count and the coefficients describe the same tiles, so a
    table of another scene cannot give the card and the CPU different
    answers unnoticed."""
    tris = _soup(5)
    coeffs, attrs = pack_tris_mxu(tris)
    o, d = _rays(7, 16)
    args = list(brute_args(coeffs, attrs, o, d, "cpu"))
    if fault == "table_doubled":
        args[2] = torch.cat([args[2], args[2]])
    elif fault == "coeffs_doubled":
        args[0] = torch.cat([args[0], args[0]])
    elif fault == "n_tris_past_the_table":
        args[3] = args[2].shape[0] + 1
    else:
        args[3] = -1
    with pytest.raises(ValueError, match="brute:"):
        brute.brute(*args)
    brute.brute(*brute_args(coeffs, attrs, o, d, "cpu"))   # as built: runs


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


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _kernel_arithmetic(coeffs, attrs, table, n_tris, ox, oy, oz, dx, dy, dz,
                       zero=0.0):
    """csrc/brute.cu's arithmetic, written out in torch on the CPU: the
    structural terms of each form from the compact table, in feature order;
    the validity test; the first triangle of smallest t; `+ zero` on the
    winner's un and vn (the kernel adds +0.0); a miss for a ray with a
    non-finite feature; brute_plain's epilogue. Returns the five outputs and
    the winner's un and vn before `+ zero`."""
    feats = [dx, dy, dz, ox, oy, oz, oy * dz - oz * dy, oz * dx - ox * dz,
             ox * dy - oy * dx]
    f = [x[:, None] for x in feats]
    cols = iter(table[None, :n_tris].unbind(-1))
    forms = []
    for terms in BRUTE_TERMS:
        acc = None
        for k in terms:
            term = next(cols) * (f[k] if k < 9 else 1.0)
            acc = term if acc is None else acc + term
        forms.append(acc)
    a, un, vn, tn = forms
    a2 = a * a
    ua = un * a
    va = vn * a
    valid = ((a2 > brute.EPS * brute.EPS) & (ua >= 0.0) & (va >= 0.0)
             & (ua + va <= a2) & (tn * a >= brute.EPS * a2))
    inv_a = 1.0 / torch.where(valid, a, 1.0)
    t = torch.where(valid, tn * inv_a, FLT_MAX)
    k = torch.argmin(t, dim=1, keepdim=True)
    pick = lambda x: torch.gather(x, 1, k)[:, 0]
    w_un, w_vn = pick(un), pick(vn)
    finite = torch.stack([torch.isfinite(x) for x in feats]).all(0)
    hit = finite & (pick(t) < FLT_MAX)
    u = torch.where(hit, (w_un + zero) * pick(inv_a), 0.0)
    v = torch.where(hit, (w_vn + zero) * pick(inv_a), 0.0)
    at = torch.where(hit[:, None], attrs[k[:, 0]], 0.0)
    w = 1.0 - u - v
    nn = [w * at[:, c] + u * at[:, 3 + c] + v * at[:, 6 + c]
          for c in range(3)]
    inv_len = 1.0 / torch.sqrt(torch.clamp(
        nn[0] * nn[0] + nn[1] * nn[1] + nn[2] * nn[2], min=1e-30))
    fl = torch.where(dx * nn[0] + dy * nn[1] + dz * nn[2] > 0.0, -inv_len,
                     inv_len)
    out = (torch.where(hit, pick(t), -1.0), nn[0] * fl, nn[1] * fl,
           nn[2] * fl, torch.where(hit, at[:, 9].to(torch.int32), -1))
    return out, w_un[hit], w_vn[hit]


@pytest.mark.parametrize("name", ["teapot", "cow", "exact_soup"])
def test_pack_tris_brute_keeps_the_structural_coefficients(name):
    """The compact table holds each form's structural coefficients bit for
    bit, every other coefficient of pack_tris_mxu is +0 by its bits, and the
    sweep ends after the last triangle whose a row is not zero."""
    if name == "exact_soup":     # axis-plane triangles, origin vertices
        coeffs, _ = pack_tris_mxu(exact_soup())
        scene_table = None
    else:
        scene, _ = load_scene(scene_path(name), "cpu", brute_tables=True)
        coeffs = scene.tris_mxu_c.numpy()
        scene_table = scene.tris_brute, scene.brute_tris
    table, n_tris = pack_tris_brute(coeffs)
    c = coeffs.reshape(-1, 4, MXU_TRI_TILE, 16).transpose(1, 0, 2, 3)
    c = c.reshape(4, -1, 16)
    assert table.shape == (c.shape[1], 20)
    col = 0
    rest = c.copy()
    for q, terms in enumerate(BRUTE_TERMS):
        for k in terms:
            np.testing.assert_array_equal(table[:, col].view(np.uint32),
                                          c[q, :, k].view(np.uint32))
            rest[q, :, k] = 0.0
            col += 1
    assert (table[:, 19].view(np.uint32) == 0).all()
    assert (rest.view(np.uint32) == 0).all()
    a_rows = np.nonzero((c[0] != 0).any(1))[0]
    assert n_tris == a_rows[-1] + 1 and (c[0, n_tris:] == 0).all()
    assert n_tris % MXU_TRI_TILE     # the sweep ends before the padding
    if scene_table is not None:
        assert np.array_equal(scene_table[0].numpy().view(np.uint32),
                              table.view(np.uint32))
        assert scene_table[1] == n_tris


@pytest.mark.parametrize("stray", [-0.0, 1e-30])
def test_pack_tris_brute_rejects_a_stray_coefficient(stray):
    """A coefficient outside the structural terms that is not +0.0 by its
    bits (even -0.0) breaks the kernel's bit-equality: refuse the table."""
    coeffs, _ = pack_tris_mxu(_soup(9))
    coeffs[3 * MXU_TRI_TILE + 5, 12] = stray    # tn row, feature 12
    with pytest.raises(ValueError, match="not \\+0.0"):
        pack_tris_brute(coeffs)


@pytest.mark.parametrize("kind", EXACT_CASES)
def test_kernel_arithmetic_equals_brute_plain_bits(kind):
    """The kernel's sums of the structural terms alone, with the winner's
    un and vn canonicalized by + 0.0 and non-finite rays missing, give
    brute_plain's five outputs bit for bit: on rays whose sums cancel
    exactly (vertices and edge midpoints, o = 0, through the origin) and on
    lanes with Inf or NaN features."""
    tris = exact_soup()
    coeffs, attrs = pack_tris_mxu(tris)
    args = brute_args(coeffs, attrs, *exact_rays(tris, kind), "cpu")
    got, w_un, w_vn = _kernel_arithmetic(*args)
    ref = brute.brute_plain(*plain_args(args))
    _same_bits(got, ref)
    hits = int((ref[0] > 0).sum())
    if kind == "non_finite":
        assert 0 < hits < 300      # only the two finite lanes of eight hit
    else:
        assert hits > 300
    if kind == "vertices":       # hits on a vertex or an edge
        assert int(((w_un == 0) | (w_vn == 0)).sum()) > 20


def test_kernel_arithmetic_needs_the_canonical_zero():
    """Through the origin, exact_soup's triangle 0 gets un = -0 from the
    structural terms where the dense sum gives +0: without the + 0.0 the
    sign reaches nx, with it the bits are brute_plain's."""
    tris = exact_soup()
    coeffs, attrs = pack_tris_mxu(tris)
    args = brute_args(coeffs, attrs, *exact_rays(tris, "signed_zero"),
                      "cpu")
    ref = brute.brute_plain(*plain_args(args))
    got, w_un, _ = _kernel_arithmetic(*args)
    _same_bits(got, ref)
    assert int(torch.signbit(w_un[w_un == 0]).sum()) > 50
    raw, _, _ = _kernel_arithmetic(*args, zero=-0.0)   # x + -0.0 is x
    assert not torch.equal(_bits(raw[1]), _bits(ref[1]))
    _same_bits([raw[0], raw[4]], [ref[0], ref[4]])
