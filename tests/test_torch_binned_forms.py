"""PyTorch port, the binned pipeline's other shapes and kernel forms: the
K-want cull (expansion and slot pipelines), the stream's uv, deferral and
chunk-gate forms, contiguous bins and the octcell key, on teapot tables
carried over from the JAX package (scene_from_jax_arrays).

On the CPU each wrapper runs its kernel's plain PyTorch version. Tolerances,
and why:
  - the K-want cull against the JAX kernel (interpret mode): ids and the
    bits of t0, as test_torch_binned.py holds the one-want cull (slab tests
    are subtractions, multiplications and min/max, which no compiler
    contracts; origins are off every box face here).
  - the stream's forms against its default form, and every pipeline shape
    against the default pipeline and the packet walk: bit for bit. Each
    form tests the same triangles with the same arithmetic, or skips only
    tests that cannot win; the uv form's normal is rebuilt after the passes
    by the stream's own formula on the same values (tri_attrs holds the
    bits of tris_packed's normal fields), so it is bit-equal too (measured:
    every active lane; STREAM_UV_NORMAL_ATOL = 0).
"""
from unittest import mock

import numpy as np
import pytest
import torch

from pathtracer_tpu import load_scene as jax_load_scene
from pathtracer_tpu_torch.ops import binned
from pathtracer_tpu_torch.ops.bvh_packet import mesh_intersect_packet
from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.scene.loader import scene_from_jax_arrays
from pathtracer_tpu_torch.scene.types import TREELET_NONE
from pathtracer_tpu_torch.utils.vec import Vec3
from test_torch_binned import _aimed_rays, _jax_cull, _rays, jax_leaves

torch.set_num_threads(2)

N = 2048
FLT_MAX = 3.402823466e38
STREAM_UV_NORMAL_ATOL = 0.0   # the uv epilogue's normals (see above)


@pytest.fixture(scope="module")
def teapot():
    j_scene, _ = jax_load_scene(scene_path("teapot"))
    return j_scene, scene_from_jax_arrays(jax_leaves(j_scene), "cpu")


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("k", [2, 4])
def test_cull_plain_k_wants_matches_jax_cull_kernel(teapot, k):
    """Two enumeration steps of k wants each: from the start state, then
    resuming strictly after the first step's last slot, as the expansion
    and slot pipelines resume."""
    j_scene, scene = teapot
    o, d = _aimed_rays(scene, 0)
    r = np.random.default_rng(1)
    bound = np.where(r.uniform(size=N) < 0.3, r.uniform(1, 8, size=N),
                     FLT_MAX).astype(np.float32)
    live = (r.uniform(size=N) < 0.8).astype(np.int32)
    pt0 = np.full(N, -FLT_MAX, np.float32)
    pid = np.full(N, -1, np.int32)
    for step in range(2):
        j_id, j_t0 = _jax_cull(j_scene, o, d, bound, pt0, pid, live, k)
        p_id, p_t0 = binned.cull(scene.treelet_f, scene.treelet_super,
                                 *map(t_, o), *map(t_, d), t_(bound),
                                 t_(pt0), t_(pid), t_(live), k=k)
        assert p_id.shape == (k, N)
        np.testing.assert_array_equal(p_id.numpy(), j_id)
        np.testing.assert_array_equal(p_t0.numpy().view(np.int32),
                                      j_t0.view(np.int32))
        assert (j_id[0] < TREELET_NONE).mean() > (0.3 if step == 0 else 0.02)
        # slot 0 is the one-want cull's answer
        one = binned.cull(scene.treelet_f, scene.treelet_super,
                          *map(t_, o), *map(t_, d), t_(bound), t_(pt0),
                          t_(pid), t_(live))
        assert torch.equal(one[0], p_id[0]) and torch.equal(one[1], p_t0[0])
        pt0, pid = j_t0[k - 1], j_id[k - 1]


def test_cull_rejects_more_wants_than_the_kernel_holds(teapot):
    _, scene = teapot
    o, d, _, tb = _rays(0, 256)
    args = (scene.treelet_f, scene.treelet_super, *map(t_, o), *map(t_, d),
            t_(tb), torch.full((256,), -FLT_MAX),
            torch.full((256,), -1, dtype=torch.int32),
            torch.ones(256, dtype=torch.int32))
    for k in (0, binned.MAX_WANTS + 1):
        with pytest.raises(ValueError):
            binned.cull(*args, k=k)


def _first_pass(scene, seed, n=N):
    """A first-pass stream input: aimed rays, a bound finite on a third of
    the lanes, each lane's nearest wanted treelet, the pool sorted by it
    per column as the bin sort leaves it."""
    o, d = _aimed_rays(scene, seed, n)
    r = np.random.default_rng(seed + 100)
    bound = np.where(r.uniform(size=n) < 0.3, r.uniform(1, 8, size=n),
                     FLT_MAX).astype(np.float32)
    planes = [*map(t_, o), *map(t_, d), t_(bound)]
    tid, _ = binned.cull(scene.treelet_f, scene.treelet_super, *planes,
                         torch.full((n,), -FLT_MAX),
                         torch.full((n,), -1, dtype=torch.int32),
                         torch.ones(n, dtype=torch.int32))
    tid, *planes = binned._seg_sort(tid, *planes)
    return (scene.treelet_i, scene.tris_packed, scene.tre_rows, *planes,
            tid)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_stream_uv_is_the_default_streams_hit(teapot):
    """t is the default form's bit for bit; the triangle index names the
    winner's row of tri_attrs (its material the default form's), u and v
    its barycentrics."""
    _, scene = teapot
    args = _first_pass(scene, 2)
    ref = binned.stream(*args)
    t, u, v, nz, tri = binned.stream(*args, uv=True)
    assert torch.equal(_bits(t), _bits(ref[0]))
    hit = ref[0] > 0
    assert int(hit.sum()) > 200
    assert bool((tri[~hit] == -1).all()) and bool((tri[hit] >= 0).all())
    attrs = scene.tri_attrs[tri[hit].long()]
    assert torch.equal(attrs[:, 9].to(torch.int32), ref[4][hit])
    assert bool((u[hit] >= 0).all() and (v[hit] >= 0).all()
                and (u[hit] + v[hit] <= 1).all())
    assert bool((nz == 0).all())
    # the winner's normal, rebuilt from (u, v) as the uv epilogue does, is
    # the default form's bit for bit
    w = 1.0 - u[hit] - v[hit]
    raw = [w * attrs[:, c] + u[hit] * attrs[:, 3 + c]
           + v[hit] * attrs[:, 6 + c] for c in range(3)]
    inv_len = 1.0 / torch.sqrt(torch.clamp(
        raw[0] * raw[0] + raw[1] * raw[1] + raw[2] * raw[2], min=1e-30))
    dot = raw[0] * args[6][hit] + raw[1] * args[7][hit] + raw[2] * args[8][hit]
    fl = torch.where(dot > 0.0, -inv_len, inv_len)
    for c in range(3):
        assert torch.equal(_bits(raw[c] * fl), _bits(ref[1 + c][hit]))


def _support_oracle(tid, n_treelets, min_support):
    """numpy: JAX's block-support rule (binned.py:629-639), block by block
    of 2,048 lanes (the TPU kernel's 16 x 128 block)."""
    tid = np.asarray(tid)
    inc = np.zeros(tid.shape[0], np.int32)
    for b0 in range(0, tid.shape[0], 2048):
        blk = tid[b0:b0 + 2048]
        for g in np.unique(blk):
            if 0 <= g < n_treelets:
                sup = blk == g
                if sup.sum() < min_support:
                    inc[b0:b0 + 2048][sup] = 1
    return inc


@pytest.mark.parametrize("min_support", [16, 64])
def test_stream_defer_marks_the_minority_wants(teapot, min_support):
    """inc is the JAX rule's, the deferred lanes test nothing (a miss), and
    every other lane is the default form's bit for bit."""
    _, scene = teapot
    args = _first_pass(scene, 3, 2 * N + 384)   # a partial last block
    ref = binned.stream(*args)
    got = binned.stream(*args, min_support=min_support)
    assert len(got) == 6
    inc = got[5]
    want = _support_oracle(args[-1].numpy(), scene.treelet_i.numel() // 4,
                           min_support)
    np.testing.assert_array_equal(inc.numpy(), want)
    assert 50 < int(inc.sum()) < int((args[-1] < TREELET_NONE).sum())
    d = inc > 0
    assert bool((got[0][d] == -1).all()) and bool((got[4][d] == -1).all())
    for a, b in zip(got[:5], ref):
        assert torch.equal(_bits(a[~d]), _bits(b[~d]))


@pytest.mark.parametrize("name", ["teapot", "animal"])
def test_stream_gate_equals_the_ungated_stream(teapot, name):
    """The chunk gate only skips chunks the ray cannot hit closer than its
    best, so every output is the ungated one's bit for bit; animal's
    48-row treelets read the best once every 16 rows."""
    if name == "teapot":
        _, scene = teapot
    else:
        j_scene, _ = jax_load_scene(scene_path(name))
        scene = scene_from_jax_arrays(jax_leaves(j_scene), "cpu")
    args = _first_pass(scene, 4, 1024)
    ref = binned.stream(*args)
    for uv in (False, True):
        plain = binned.stream(*args, uv=uv)
        got = binned.stream(*args, uv=uv, treelet_chunk=scene.treelet_chunk)
        for a, b in zip(got, plain):
            assert torch.equal(_bits(a), _bits(b))
    assert int((ref[0] > 0).sum()) > 100


def _port_binned(scene, o, d, act, tb, **kw):
    return binned.mesh_intersect_binned(
        scene, scene.mesh_roots, Vec3(*map(t_, o)), Vec3(*map(t_, d)),
        active=t_(act), t_bound=t_(tb), **kw)


FORMS = [
    ("expand1", dict(expand=1), {}),
    ("expand2", dict(expand=2), {}),
    ("expand4", dict(expand=4), {}),
    ("slots1", dict(slots=1), {}),
    ("slots3", dict(slots=3), {}),
    ("expand_over_slots", dict(expand=2, slots=3), {}),
    ("min_support", {}, dict(MIN_SUPPORT=64)),
    ("expand_defer", dict(expand=2), dict(MIN_SUPPORT=64)),
    ("slots_defer_gate", dict(slots=3), dict(MIN_SUPPORT=16,
                                             CHUNK_GATE=True)),
    ("chunk_gate", {}, dict(CHUNK_GATE=True)),
    ("stream_uv", {}, dict(STREAM_UV=True)),
    ("bin_contiguous", {}, dict(BIN_CONTIGUOUS=True)),
    ("octcell", {}, dict(CAND_KEY="octcell")),
    ("no_cand_sort_compact", {}, dict(CAND_SORT=False, FB_COMPACT=True)),
]


@pytest.mark.parametrize("label,kw,flags", FORMS, ids=[f[0] for f in FORMS])
def test_binned_forms_equal_the_default_pipeline(teapot, label, kw, flags):
    """Every pipeline shape and kernel form gives the default pipeline's
    true closest hit, and the packet walk's, on active lanes bit for bit
    (the uv normals within STREAM_UV_NORMAL_ATOL)."""
    _, scene = teapot
    o, d, act, tb = _rays(0)
    ref = _port_binned(scene, o, d, act, tb)
    with mock.patch.multiple(binned, **flags, PASSES=None):
        got = _port_binned(scene, o, d, act, tb, **kw)
    walk = mesh_intersect_packet(scene, scene.mesh_roots[0],
                                 Vec3(*map(t_, o)), Vec3(*map(t_, d)),
                                 active=t_(act), t_bound=t_(tb))
    a = t_(act)
    assert int((ref[0][a] > 0).sum()) > 50
    for other in (ref, walk):
        assert torch.equal(_bits(got[0][a]), _bits(other[0][a]))
        assert torch.equal(got[2][a], other[2][a])
        for x, y in zip(got[1], other[1]):
            if STREAM_UV_NORMAL_ATOL:
                torch.testing.assert_close(x[a], y[a], rtol=0,
                                           atol=STREAM_UV_NORMAL_ATOL)
            else:
                assert torch.equal(_bits(x[a]), _bits(y[a]))


def test_binned_forms_launch_their_kernel_forms(teapot):
    """The pipeline hands each form's wrapper its arguments: the K-want
    cull once for expand and slots, the stream's keywords under the flags,
    and debug_tids returns one post-bin id plane a pass."""
    _, scene = teapot
    o, d, act, tb = _rays(1)
    calls = []

    def recording(name, fn):
        def wrapper(*args, **kwargs):
            calls.append((name, kwargs))
            return fn(*args, **kwargs)
        return wrapper

    with mock.patch.object(binned, "cull", recording("cull", binned.cull)), \
            mock.patch.object(binned, "stream",
                              recording("stream", binned.stream)):
        _port_binned(scene, o, d, act, tb, expand=4)
        assert [c for c in calls if c[0] == "cull"][0][1] == {"k": 4}
        calls.clear()
        with mock.patch.multiple(binned, MIN_SUPPORT=64, CHUNK_GATE=True,
                                 STREAM_UV=True):
            *_, dbg = _port_binned(scene, o, d, act, tb, debug_tids=True)
        kws = [c[1] for c in calls if c[0] == "stream"]
        assert len(kws) == 2 and len(dbg) == 2
        assert kws[0]["uv"] and kws[0]["min_support"] == 64
        assert kws[0]["treelet_chunk"] is scene.treelet_chunk
    with mock.patch.object(binned, "STREAM_UV", True), \
            pytest.raises(ValueError):
        _port_binned(scene, o, d, act, tb, slots=2)
    with mock.patch.object(binned, "BIN_CONTIGUOUS", True), \
            pytest.raises(ValueError):
        _port_binned(scene, o, d, act, tb, expand=2)


@pytest.mark.parametrize("name", ["teapot", "cow"])
def test_chunk_and_attr_tables_match_jax(name):
    """treelet_chunk and tri_attrs, built at load, equal the JAX loader's
    bit for bit, and survive the carry across."""
    from pathtracer_tpu_torch import load_scene
    j_scene, _ = jax_load_scene(scene_path(name))
    p_scene, _ = load_scene(scene_path(name), "cpu")
    carried = scene_from_jax_arrays(jax_leaves(j_scene), "cpu")
    for key in ("treelet_chunk", "tri_attrs"):
        ref = np.asarray(getattr(j_scene, key))
        for sc in (p_scene, carried):
            got = getattr(sc, key).numpy()
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got.view(np.int32),
                                          ref.view(np.int32))
    # every real treelet's first chunk is a real box
    n_t = int((p_scene.treelet_i.reshape(-1, 4)[:, 1] > 0).sum())
    assert bool(torch.isfinite(p_scene.treelet_chunk[:n_t, :6]).all())
