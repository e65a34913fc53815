"""PyTorch port, the CUDA kernels' wrappers. Imports no JAX, so it also runs
on a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

On the CPU the wrappers must take the plain version and the kernel library
must not be built; the tests marked `cuda` build the library with nvcc and
hold each kernel against its plain version on the card (bit for bit: the
library is built with -fmad=false, see csrc/common.cuh), and skip where
there is no CUDA device.
"""
import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import load_scene
from pathtracer_tpu_torch.ops import binned, brute, bvh_packet, kernels, wide
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
