"""PyTorch port, the CUDA kernels' wrappers. Imports no JAX, so it also runs
on a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

On the CPU the wrappers must take the plain version and the kernel library
must not be built; the tests marked `cuda` build the library with nvcc and
hold each kernel against its plain version on the card (bit for bit: the
library is built with -fmad=false, see csrc/common.cuh), and skip where
there is no CUDA device.
"""
import json
import os

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import load_scene
from pathtracer_tpu_torch.ops import (binned, brute, bvh_packet, kernels,
                                      scan, wide)
from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.utils.vec import Vec3

torch.set_num_threads(2)

FLT_MAX = 3.402823466e38


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _planes(n, seed, device):
    r = np.random.default_rng(seed)
    o = r.uniform(-5, 5, size=(3, n)).astype(np.float32)
    d = r.normal(size=(3, n)).astype(np.float32)
    bound = np.where(r.uniform(size=n) < 0.5, r.uniform(2, 12, size=n),
                     FLT_MAX).astype(np.float32)
    act = (r.uniform(size=n) < 0.7).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return [t(c) for c in o], [t(c) for c in d], t(bound), t(act)


def write_tie_scene(directory) -> str:
    """A scene of one mesh made of coincident triangles that carry different
    materials (MTL m0..m3, ids 1..4): 150 copies of one triangle, which the
    BVH builder cuts at the median into two leaves of 75 (their centroids
    are equal), and 40 copies of another, in one leaf. Returns the scene
    JSON's path. Every ray that hits a group ties on t; the walk keeps the
    first copy of the group (leaves left first, triangles in order): m0 for
    the first group, m2 for the second."""
    with open(os.path.join(directory, "tie.mtl"), "w") as f:
        for k in range(4):
            f.write(f"newmtl m{k}\nKd {0.2 + 0.2 * k} 0.5 0.5\n")
    lines = ["mtllib tie.mtl", "v 0 0 0", "v 1 0 0", "v 0 1 0", "v 5 0 0",
             "v 6 0 0", "v 5 1 0"]
    lines += [f"usemtl m{k % 4}\nf 1 2 3" for k in range(150)]
    lines += [f"usemtl m{(k + 2) % 4}\nf 4 5 6" for k in range(40)]
    obj = os.path.join(directory, "tie.obj")
    with open(obj, "w") as f:
        f.write("\n".join(lines) + "\n")
    scene = {
        "Materials": {"white": {"TYPE": "Diffuse", "RGB": [0.9, 0.9, 0.9]}},
        "Camera": {"RES": [16, 16], "FOVY": 45.0, "ITERATIONS": 1,
                   "DEPTH": 2, "FILE": "tie", "EYE": [0.0, 0.0, 5.0],
                   "LOOKAT": [0.0, 0.0, 0.0], "UP": [0.0, 1.0, 0.0]},
        "Objects": [{"TYPE": "mesh", "FILE": obj, "TRANS": [0.0, 0.0, 0.0],
                     "ROTAT": [0.0, 0.0, 0.0], "SCALE": [1.0, 1.0, 1.0]}]}
    path = os.path.join(directory, "tie.json")
    with open(path, "w") as f:
        json.dump(scene, f)
    return path


def tie_rays(n: int, seed: int):
    """(origin [3, n], direction [3, n], group [n]) as float32 / int arrays:
    rays from either side aimed at points inside the first (group 0) or the
    second (group 1) triangle of write_tie_scene."""
    r = np.random.default_rng(seed)
    group = r.integers(0, 2, n)
    u, v = r.uniform(0.05, 0.45, size=(2, n))
    p = np.stack([u + 5.0 * group, v, np.zeros(n)])
    side = np.where(r.uniform(size=n) < 0.5, -1.0, 1.0)
    o = p + np.stack([r.normal(size=n) * 0.3, r.normal(size=n) * 0.3,
                      3.0 * side])
    return o.astype(np.float32), (p - o).astype(np.float32), group


def aimed_planes(scene, n, seed, device):
    """Rays aimed at random points of the mesh's root box (most want several
    leaves), a bound finite on half the lanes, all lanes active."""
    r = np.random.default_rng(seed)
    root = scene.mesh_roots[0]
    b = scene.bvh
    lo = np.array([float(b.min_x[root]), float(b.min_y[root]),
                   float(b.min_z[root])], np.float32)
    hi = np.array([float(b.max_x[root]), float(b.max_y[root]),
                   float(b.max_z[root])], np.float32)
    target = lo[:, None] + r.uniform(size=(3, n)) * (hi - lo)[:, None]
    o = (target + r.normal(size=(3, n)) * 4.0).astype(np.float32)
    d = (target - o).astype(np.float32)
    bound = np.where(r.uniform(size=n) < 0.5, r.uniform(2, 12, size=n),
                     FLT_MAX).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return [t(c) for c in o], [t(c) for c in d], t(bound)


def test_cpu_tensors_take_the_plain_versions():
    scene, _ = load_scene(scene_path("teapot"), "cpu")
    before = dict(kernels.LAUNCHES)
    o, d, bound, act = _planes(256, 0, "cpu")
    pt0 = torch.full((256,), -FLT_MAX)
    pid = torch.full((256,), -1, dtype=torch.int32)
    got = binned.cull(scene.treelet_f, scene.treelet_super, *o, *d, bound,
                      pt0, pid, act)
    ref = binned.cull_plain(scene.treelet_f, scene.treelet_super, *o, *d,
                            bound, pt0, pid, act)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    bvh_packet.packet_walk(scene.bvh_packed_f, scene.bvh_packed_i,
                           scene.tris_packed, scene.mesh_roots[0], *o, *d,
                           act, bound)
    binned.stream(scene.treelet_i, scene.tris_packed, scene.tre_rows,
                  *o, *d, bound, got[0])
    assert kernels.LAUNCHES == before


def test_cpu_tensors_take_the_plain_versions_of_wide_and_brute():
    scene, _ = load_scene(scene_path("teapot"), "cpu", brute_tables=True,
                          wide_tables=True)
    before = dict(kernels.LAUNCHES)
    o, d, bound, act = _planes(256, 0, "cpu")
    w_args = (scene.nodes8_f, scene.nodes8_i, scene.tris8, scene.wide_root,
              *o, *d, act, bound)
    for variant in wide.VARIANTS:
        for a, b in zip(wide.wide_walk(*w_args, variant=variant),
                        wide.wide_walk_plain(*w_args, variant=variant)):
            assert torch.equal(a, b)
    b_args = (scene.tris_mxu_c, scene.tris_mxu_n, *o, *d)
    for a, b in zip(brute.brute(*b_args), brute.brute_plain(*b_args)):
        assert torch.equal(a, b)
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError):
        wide.wide_walk(*w_args, variant="mask", cull=True)
    with pytest.raises(ValueError):
        wide.wide_walk(*w_args, variant="stack")


def test_binned_big_mesh_equals_packet_walk():
    """animal.json is the big-mesh case: 48-row treelets, 3 passes and the
    pre-fallback compaction sort by default. The pipeline must give the
    packet walk's true closest hit bit for bit (plain versions on the
    CPU)."""
    scene, _ = load_scene(scene_path("animal"), "cpu")
    assert scene.tre_rows == 48
    assert scene.tris_packed.shape[0] * 6 > binned.PASSES_BIG_TRIS
    o, d, bound, act = _planes(2048, 4, "cpu")
    a = act > 0
    res = binned.mesh_intersect_binned(scene, scene.mesh_roots, Vec3(*o),
                                       Vec3(*d), active=a, t_bound=bound)
    walk = bvh_packet.mesh_intersect_packet(scene, scene.mesh_roots[0],
                                            Vec3(*o), Vec3(*d), active=a,
                                            t_bound=bound)
    assert int((res[0][a] > 0).sum()) > 50
    assert torch.equal(res[0][a], walk[0][a])
    assert torch.equal(res[2][a], walk[2][a])
    for x, y in zip(res[1], walk[1]):
        assert torch.equal(x[a], y[a])


def test_library_path_tracks_the_sources():
    path = kernels.library_path()
    assert path.startswith(kernels.BUILD_DIR)
    assert path == kernels.library_path()
    for name in kernels.SOURCES:    # each notes the TPU kernel it replaces
        with open(f"{kernels.CSRC}/{name}") as f:
            assert "Replaces the TPU kernel" in f.read(), name


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs():
    _need_cuda()
    scene, _ = load_scene(scene_path("teapot"), "cuda", brute_tables=True,
                          wide_tables=True)
    o, d, bound, act = _planes(256, 0, "cuda")
    with pytest.raises(TypeError):
        bvh_packet.packet_walk(scene.bvh_packed_f, scene.bvh_packed_i,
                               scene.tris_packed, 0, *o, *d,
                               act.to(torch.float32), bound)
    with pytest.raises(ValueError):
        bvh_packet.packet_walk(scene.bvh_packed_f, scene.bvh_packed_i,
                               scene.tris_packed, 0, *o, *d, act,
                               bound[:100])
    tabs = (scene.nodes8_f, scene.nodes8_i, scene.tris8)
    for variant in wide.VARIANTS:
        with pytest.raises(TypeError):     # an f32 root
            wide.wide_walk(*tabs, scene.wide_root.float(), *o, *d, act,
                           bound, variant=variant)
        with pytest.raises(ValueError):    # a root of two values
            wide.wide_walk(*tabs, scene.wide_root.repeat(2), *o, *d, act,
                           bound, variant=variant)
        with pytest.raises(ValueError):    # a CPU plane beside CUDA rays
            wide.wide_walk(*tabs, scene.wide_root, *o, *d, act.cpu(),
                           bound, variant=variant)
    with pytest.raises(ValueError):        # tables cut mid-block
        wide.wide_walk(scene.nodes8_f[:4], scene.nodes8_i[:4], scene.tris8,
                       scene.wide_root, *o, *d, act, bound)
    with pytest.raises(ValueError):        # a 128-wide coefficient table
        brute.brute(scene.nodes8_f, scene.tris_mxu_n, *o, *d)
    with pytest.raises(ValueError):        # part of a tile
        brute.brute(scene.tris_mxu_c[:1024], scene.tris_mxu_n[:256], *o,
                    *d)
    with pytest.raises(ValueError):        # not 16-byte aligned
        brute.brute(scene.tris_mxu_c.reshape(-1)[1:1 + 2048 * 16].reshape(
            2048, 16), scene.tris_mxu_n[:512], *o, *d)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["teapot", "animal"])
def test_kernels_match_plain_versions_on_the_card(name):
    _need_cuda()
    scene, _ = load_scene(scene_path(name), "cuda")
    n = 65536
    o, d, bound, act = _planes(n, 1, "cuda")
    pt0 = torch.full((n,), -FLT_MAX, device="cuda")
    pid = torch.full((n,), -1, dtype=torch.int32, device="cuda")
    args = (scene.treelet_f, scene.treelet_super, *o, *d, bound, pt0, pid,
            act)
    k_id, k_t0 = binned.cull(*args)
    p_id, p_t0 = binned.cull_plain(*args)
    assert torch.equal(k_id, p_id) and torch.equal(k_t0, p_t0)
    s_args = (scene.treelet_i, scene.tris_packed, scene.tre_rows, *o, *d,
              bound, k_id)
    for a, b in zip(binned.stream(*s_args), binned.stream_plain(*s_args)):
        assert torch.equal(a, b)
    w_args = (scene.bvh_packed_f, scene.bvh_packed_i, scene.tris_packed,
              scene.mesh_roots[0], *o, *d, act, bound)
    for a, b in zip(bvh_packet.packet_walk(*w_args),
                    bvh_packet.packet_walk_plain(*w_args)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["teapot", "animal"])
def test_wide_kernels_match_plain_versions_on_the_card(name):
    """Both stack disciplines (and the push cull) against the plain walk:
    t and integers bit for bit, normals too (-fmad=false); push and mask
    equal."""
    _need_cuda()
    scene, _ = load_scene(scene_path(name), "cuda", wide_tables=True)
    o, d, bound, act = _planes(65536, 1, "cuda")
    args = (scene.nodes8_f, scene.nodes8_i, scene.tris8, scene.wide_root,
            *o, *d, act, bound)
    push = wide.wide_walk(*args)
    assert int((push[0] > 0).sum()) > 100
    for kw in ({"variant": "push"}, {"variant": "push", "cull": True},
               {"variant": "mask"}):
        got = wide.wide_walk(*args, **kw)
        for a, b, c in zip(got, wide.wide_walk_plain(*args, **kw), push):
            assert torch.equal(a, b), kw
            assert torch.equal(a, c), kw
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_brute_kernel_matches_plain_version_on_the_card():
    _need_cuda()
    scene, _ = load_scene(scene_path("teapot"), "cuda", brute_tables=True)
    o, d, _, _ = _planes(16384, 2, "cuda")
    args = (scene.tris_mxu_c, scene.tris_mxu_n, *o, *d)
    got = brute.brute(*args)
    assert int((got[0] > 0).sum()) > 100
    for a, b in zip(got, brute.brute_plain(*args)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cull_reads_large_tables_through_the_cache():
    """Treelet tables over SMEM_MAX_ROWS rows (csrc/cull.cu) take the path
    that reads them through L1/L2: the teapot's tables repeated 16 times
    (96 rows) must give the plain version's (id, t0) exactly."""
    _need_cuda()
    scene, _ = load_scene(scene_path("teapot"), "cuda")
    tf = torch.cat([scene.treelet_f] * 16)
    sup = torch.cat([scene.treelet_super] * 16)
    assert tf.shape[0] == 96
    n = 65536
    o, d, bound, act = _planes(n, 3, "cuda")
    pt0 = torch.full((n,), -FLT_MAX, device="cuda")
    pid = torch.full((n,), -1, dtype=torch.int32, device="cuda")
    args = (tf, sup, *o, *d, bound, pt0, pid, act)
    k_id, k_t0 = binned.cull(*args)
    p_id, p_t0 = binned.cull_plain(*args)
    assert int((k_id < binned.TREELET_NONE).sum()) > 1000
    assert torch.equal(k_id, p_id) and torch.equal(k_t0, p_t0)


@pytest.mark.cuda
def test_binned_pipeline_on_the_card_matches_cpu():
    """The whole pipeline on the card (three kernels, torch sorts) against
    the plain pipeline on the CPU, same tables and rays."""
    _need_cuda()
    gpu, _ = load_scene(scene_path("teapot"), "cuda")
    cpu, _ = load_scene(scene_path("teapot"), "cpu")
    o, d, bound, act = _planes(8192, 2, "cpu")
    res_c = binned.mesh_intersect_binned(cpu, cpu.mesh_roots, Vec3(*o),
                                         Vec3(*d), active=act > 0,
                                         t_bound=bound)
    g = lambda xs: [x.cuda() for x in xs]
    res_g = binned.mesh_intersect_binned(gpu, gpu.mesh_roots, Vec3(*g(o)),
                                         Vec3(*g(d)),
                                         active=act.cuda() > 0,
                                         t_bound=bound.cuda())
    a = act > 0
    assert torch.equal(res_g[0].cpu()[a], res_c[0][a])
    assert torch.equal(res_g[2].cpu()[a], res_c[2][a])
    for x, y in zip(res_g[1], res_c[1]):
        torch.testing.assert_close(x.cpu()[a], y[a], rtol=0, atol=1e-6)


def _packet_equal(args):
    """The packet kernel against its plain version, every output of every
    lane (inactive lanes' misses too) bit for bit, one launch a call."""
    before = kernels.LAUNCHES["packet"]
    got = bvh_packet.packet_walk(*args)
    assert kernels.LAUNCHES["packet"] == before + 1
    for a, b in zip(got, bvh_packet.packet_walk_plain(*args)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["scattered", "clustered", "all"])
def test_packet_kernel_on_sparse_pools(layout):
    """1 active lane in 75, as on the binned fallback, scattered over the
    pool or in runs of 300 (a few rays a warp); and every lane active (32
    rays a warp)."""
    _need_cuda()
    scene, _ = load_scene(scene_path("teapot"), "cuda")
    n = 75 * 4096
    o, d, bound = aimed_planes(scene, n, 5, "cuda")
    r = np.random.default_rng(6)
    if layout == "scattered":
        act = np.zeros(n, np.int32)
        act[r.choice(n, n // 75, replace=False)] = 1
    elif layout == "clustered":
        act = (np.arange(n) % (75 * 300) < 300).astype(np.int32)
    else:
        act = np.ones(n, np.int32)
    act = torch.from_numpy(act).cuda()
    got = _packet_equal((scene.bvh_packed_f, scene.bvh_packed_i,
                         scene.tris_packed, scene.mesh_roots[0], *o, *d, act,
                         bound))
    assert int((got[0] > 0).sum()) > 500


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["teapot", "animal"])
def test_packet_kernel_reads_large_node_tables_through_the_cache(
        name, monkeypatch):
    """Node tables over SMEM_NODES nodes are read through L1/L2, not staged:
    with SMEM_NODES = 0 every table is too large for shared memory."""
    _need_cuda()
    monkeypatch.setattr(bvh_packet, "SMEM_NODES", 0)
    scene, _ = load_scene(scene_path(name), "cuda")
    o, d, bound = aimed_planes(scene, 65536, 7, "cuda")
    act = (torch.arange(65536, device="cuda") % 3 > 0).to(torch.int32)
    got = _packet_equal((scene.bvh_packed_f, scene.bvh_packed_i,
                         scene.tris_packed, scene.mesh_roots[0], *o, *d, act,
                         bound))
    assert int((got[0] > 0).sum()) > 1000


@pytest.mark.cuda
def test_packet_kernel_keeps_the_tie_rule(tmp_path):
    """Coincident triangles in one leaf and across two: the first copy of
    each group wins, as in the plain walk."""
    _need_cuda()
    scene, _ = load_scene(write_tie_scene(str(tmp_path)), "cuda")
    o, d, group = tie_rays(4096, 8)
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    n = o.shape[1]
    got = _packet_equal((scene.bvh_packed_f, scene.bvh_packed_i,
                         scene.tris_packed, scene.mesh_roots[0],
                         *map(c, o), *map(c, d),
                         torch.ones(n, dtype=torch.int32, device="cuda"),
                         torch.full((n,), FLT_MAX, device="cuda")))
    mat = got[4].cpu().numpy()
    assert (mat[group == 0] == 1).all() and (mat[group == 1] == 3).all()


def test_cpu_scan_takes_the_plain_version_without_building(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path built the kernel library")

    monkeypatch.setattr(kernels, "build", no_build)
    monkeypatch.setattr(kernels, "_lib", None)
    before = dict(kernels.LAUNCHES)
    x = torch.arange(5000, dtype=torch.int32)
    assert torch.equal(scan.exclusive_scan(x), scan.exclusive_scan_plain(x))
    scan.sort_by_key(x % 7, x, n_bits=3)
    scan.compact(x, x % 3 == 0)
    assert kernels.LAUNCHES == before


# the scan's float32 tolerance: two orders of summing n float32 values differ
# by at most about (the longer chain of dependent adds) * 2**-24 * sum |x|;
# 1e-5 * sum |x| allows chains of some 170 adds (the kernel's is under 60)
SCAN_F32_RTOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 4095, 4097, 640000, 2 ** 24 + 3])
def test_scan_kernel_equals_plain_int32(n):
    """Bit for bit, including sums that wrap int32."""
    _need_cuda()
    r = np.random.default_rng(n)
    for x in (r.integers(0, 2, n), r.integers(-2 ** 31, 2 ** 31 - 1, n)):
        x = torch.from_numpy(x.astype(np.int32)).cuda()
        before = kernels.LAUNCHES["scan"]
        got = scan.exclusive_scan(x)
        assert kernels.LAUNCHES["scan"] == before + 1
        assert got.dtype == torch.int32
        assert torch.equal(got, scan.exclusive_scan_plain(x))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097, 640000])
def test_scan_kernel_float32_within_tolerance_and_repeatable(n):
    _need_cuda()
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        n).astype(np.float32)).cuda()
    got = scan.exclusive_scan(x)
    err = float((got - scan.exclusive_scan_plain(x)).abs().max())
    assert err <= SCAN_F32_RTOL * float(x.abs().sum()), err
    assert float(got[0]) == 0.0
    assert torch.equal(got, scan.exclusive_scan(x))     # the same bits


@pytest.mark.cuda
def test_scan_kernel_back_to_back_on_one_stream():
    """n shrinking and growing between calls on one stream: each call's
    epoch and the tile counter's reset keep every result exact."""
    _need_cuda()
    r = np.random.default_rng(9)
    for n in (1, 4097, 2 ** 24 + 3, 31, 640000, 4095):
        x = torch.from_numpy(r.integers(-2 ** 31, 2 ** 31 - 1, n).astype(
            np.int32)).cuda()
        before = kernels.LAUNCHES["scan"]
        got = scan.exclusive_scan(x)
        assert kernels.LAUNCHES["scan"] == before + 1
        assert torch.equal(got, scan.exclusive_scan_plain(x)), n
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097, 640001, 2 ** 24 + 4])
def test_scan_kernel_on_a_slice(n):
    """x[1:] is 4 bytes past a 16-byte boundary: the kernel's scalar
    loads, bit for bit."""
    _need_cuda()
    base = torch.from_numpy(np.random.default_rng(n).integers(
        -2 ** 31, 2 ** 31 - 1, n).astype(np.int32)).cuda()
    x = base[1:]
    assert x.data_ptr() % 16 == 4
    assert torch.equal(scan.exclusive_scan(x), scan.exclusive_scan_plain(x))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_scan_kernel_float32_same_bits_three_calls_big():
    _need_cuda()
    n = 2 ** 24 + 3
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        n).astype(np.float32)).cuda()
    got = scan.exclusive_scan(x)
    err = float((got - scan.exclusive_scan_plain(x)).abs().max())
    assert err <= SCAN_F32_RTOL * float(x.abs().sum()), err
    for _ in range(2):
        assert torch.equal(got, scan.exclusive_scan(x))


@pytest.mark.cuda
def test_scan_kernel_rejects_bad_inputs():
    _need_cuda()
    x = torch.arange(100, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        scan.exclusive_scan(x.long())
    with pytest.raises(ValueError):
        scan.exclusive_scan(x[::2])                    # not contiguous
    with pytest.raises(ValueError):
        scan.scan_kernel(x.cpu())                      # off the card
    with pytest.raises(ValueError):
        scan.exclusive_scan(x.reshape(10, 10))
