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
import re
from unittest import mock

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import load_scene
from pathtracer_tpu_torch.ops import (binned, brute, bvh_packet, kernels,
                                      scan, wide)
from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.scene.types import pack_wide_nodes, pack_wide_tables
from pathtracer_tpu_torch.utils import profiling
from pathtracer_tpu_torch.utils.vec import Vec3
from torch_wide_scenes import SCENES

torch.set_num_threads(2)

FLT_MAX = 3.402823466e38


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _same_bits(got, ref):
    """Every output equal, float32 outputs by their bits (torch.equal takes
    -0 == +0)."""
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    for k, (a, b) in enumerate(zip(got, ref)):
        assert torch.equal(bits(a), bits(b)), f"output {k}"


def _cull_then_stream(scene, o, d, bound, live, pt0=None, pid=None):
    """The cull kernel, then the stream kernel on the cull's ids, on one
    pool: each one launch, each equal to its plain version bit for bit.
    Returns the cull's and the stream's outputs."""
    n = bound.shape[0]
    if pt0 is None:
        pt0 = torch.full((n,), -FLT_MAX, device="cuda")
        pid = torch.full((n,), -1, dtype=torch.int32, device="cuda")
    before = dict(kernels.LAUNCHES)
    c_args = (scene.treelet_f, scene.treelet_super, *o, *d, bound, pt0, pid,
              live)
    got = binned.cull(*c_args)
    _same_bits(got, binned.cull_plain(*c_args))
    s_args = (scene.treelet_i, scene.tris_packed, scene.tre_rows, *o, *d,
              bound, got[0])
    got_s = binned.stream(*s_args)
    _same_bits(got_s, binned.stream_plain(*s_args))
    assert kernels.LAUNCHES["cull"] == before["cull"] + 1
    assert kernels.LAUNCHES["stream"] == before["stream"] + 1
    torch.cuda.synchronize()
    return got, got_s


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


def plane_rays(treelet_f, n: int, seed: int, planes: int = 1):
    """(origin [3, n], direction [3, n]) as float32 arrays: rays whose
    origins lie exactly on `planes` of the lo / hi planes of a random
    treelet box (1: on a face, 2: an edge, 3: a corner; the other
    coordinates inside its range), so many enter a box at t0 = +0 or -0;
    directions random."""
    r = np.random.default_rng(seed)
    tab = np.asarray(treelet_f).reshape(-1, 8)
    ok = np.nonzero(np.isfinite(tab[:, :6]).all(1))[0]
    k = r.choice(ok, n)
    lo, hi = tab[k, 0:3], tab[k, 3:6]
    o = lo + r.uniform(size=(n, 3)).astype(np.float32) * (hi - lo)
    lane, first = np.arange(n), r.integers(0, 3, n)
    for p in range(planes):
        axis = (first + p) % 3
        o[lane, axis] = np.where(r.uniform(size=n) < 0.5, lo[lane, axis],
                                 hi[lane, axis])
    d = r.normal(size=(n, 3))
    return (np.ascontiguousarray(o.T, np.float32),
            np.ascontiguousarray(d.T, np.float32))


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


EXACT_CASES = ("random", "vertices", "origin", "signed_zero", "non_finite")


def exact_soup(n: int = 700, seed: int = 0) -> dict:
    """A triangle soup (the dict pack_tris_mxu takes) on a grid of eighths,
    where many (ray, triangle) sums cancel exactly: a third of the triangles
    lie in an axis plane and a tenth have a vertex at the origin. Triangle 0
    has v0 at the origin, e2 < 0 and corner normals with zero components,
    and the others lie in x >= 0: a ray through the origin with d > 0
    (signed_zero) meets triangle 0 first, at its vertex v0, and gets un = -0
    from its structural terms where the 16-term sum gives +0; the sign
    reaches nx. 700 triangles make two 512-triangle tiles and a sweep that is not a
    whole number of the brute kernel's chunks."""
    r = np.random.default_rng(seed)
    v = r.integers(-16, 17, (n, 3, 3)) / 8.0
    for i in np.nonzero(r.uniform(size=n) < 1 / 3)[0]:
        axis = r.integers(0, 3)
        v[i, :, axis] = v[i, 0, axis]
    for i in np.nonzero(r.uniform(size=n) < 0.1)[0]:
        v[i, r.integers(0, 3)] = 0.0
    v[:, :, 0] = np.abs(v[:, :, 0])
    v[0] = [[0.0, 0.0, 0.0], [-1.0, 0.5, -0.25], [-0.5, -1.0, -0.75]]
    nrm = r.integers(-8, 9, (n, 3, 3)) / 8.0
    nrm[0] = [[-0.0, 0.0, 1.0], [1.0, 0.0, 1.0], [0.0, 1.0, 1.0]]
    v, nrm = v.astype(np.float32), nrm.astype(np.float32)
    return {"v0": v[:, 0], "v1": v[:, 1], "v2": v[:, 2], "n0": nrm[:, 0],
            "n1": nrm[:, 1], "n2": nrm[:, 2],
            "material_id": (np.arange(n) % 7).astype(np.int32)}


def exact_rays(tris: dict, kind: str, n: int = 1000, seed: int = 0):
    """(origin [3, n], direction [3, n]) float32 arrays for the brute-force
    kernel, by `kind` (EXACT_CASES): "random" rays through the soup;
    "vertices", origins on a grid of eighths aimed exactly at vertices and
    edge midpoints of the soup, so that un or vn is often exactly zero;
    "origin", o = 0 (half aimed at vertices and midpoints); "signed_zero",
    rays o = -k d through the origin (exact_soup's triangle 0), d > 0 on half
    the lanes and d < 0 on the rest; "non_finite", the "vertices" rays with
    an Inf or NaN in o or d on five lanes of eight, finite origins whose
    o x d overflows to NaN on one, and two left as they are."""
    r = np.random.default_rng(seed)
    corners = np.stack([tris[k] for k in ("v0", "v1", "v2")], 1)
    j, a, b = r.integers(0, len(corners), n), r.integers(0, 3, n), \
        r.integers(0, 3, n)
    aim = (corners[j, a] + corners[j, b]) / 2    # a vertex where a == b
    o = r.integers(-32, 33, (n, 3)) / 8.0
    if kind == "random":
        o = r.normal(0, 2.0, (n, 3))
        d = r.normal(0, 1.0, (n, 3)) - o
    elif kind == "origin":
        o = np.zeros((n, 3))
        d = np.where(r.uniform(size=(n, 1)) < 0.5, aim,
                     r.normal(size=(n, 3)))
    elif kind == "signed_zero":
        d = r.integers(1, 33, (n, 3)) / 16.0
        d[n // 2:] *= -1.0
        o = -(2.0 ** r.integers(0, 4, (n, 1))) * d
    else:
        d = aim - o
    o, d = o.astype(np.float32), d.astype(np.float32)
    if kind == "non_finite":
        lane = np.arange(n)
        axis = r.integers(0, 3, n)
        bad = (np.inf, -np.inf, np.nan, np.inf, np.nan)
        for k, x in enumerate(bad):
            sel = lane % 8 == k
            (o if k % 2 == 0 else d)[sel, axis[sel]] = x
        o[lane % 8 == 5] = 1e30     # d stays finite; o x d is Inf - Inf
        d[lane % 8 == 5] *= 1e10
    return (np.ascontiguousarray(o.T, np.float32),
            np.ascontiguousarray(d.T, np.float32))


def brute_args(coeffs, attrs, o, d, device):
    """The brute wrapper's arguments for pack_tris_mxu's numpy tables and
    numpy ray planes, on `device`."""
    from pathtracer_tpu_torch.scene.types import pack_tris_brute
    table, n_tris = pack_tris_brute(coeffs)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(coeffs), t(attrs), t(table), n_tris, *map(t, o), *map(t, d))


def plain_args(args):
    """brute_plain's arguments from the brute wrapper's."""
    return args[:2] + args[4:]


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
    b_args = (scene.tris_mxu_c, scene.tris_mxu_n, scene.tris_brute,
              scene.brute_tris, *o, *d)
    for a, b in zip(brute.brute(*b_args),
                    brute.brute_plain(*plain_args(b_args))):
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


@pytest.mark.parametrize("entry", kernels.KERNELS, ids=lambda k: k.name)
def test_the_kernel_table_entry(entry):
    """Each entry's source holds its device kernel and its C entry point,
    which takes as many arguments as its argtypes list; the library builds
    the source and loads the entry; LAUNCHES, the profiler's PORT_KERNELS
    and KINDS read the kernel from the table."""
    with open(os.path.join(kernels.CSRC, entry.source)) as f:
        src = f.read()
    assert re.search(rf"__global__[^;{{]*\b{entry.device_kernel}\(", src)
    sig = re.search(rf'extern "C" int pt_{entry.name}\(([^)]*)\)', src)
    assert sig is not None
    assert len(sig.group(1).split(",")) == len(entry.argtypes)
    assert kernels._ARGTYPES["pt_" + entry.name] is entry.argtypes
    assert entry.source in kernels.SOURCES
    assert kernels.LAUNCHES[entry.name] >= 0
    assert dict(profiling.PORT_KERNELS)[entry.device_kernel] == entry.name
    assert profiling.kernel_kind(entry.device_kernel) == entry.kind
    assert profiling.kernel_kind(f"void {entry.device_kernel}<1>(A)") == (
        entry.kind)


def _twin(a, b, c=None):
    """A stand-in's plain twin: two float outputs, then an int32 and a
    bool one."""
    y = a * b + (0.0 if c is None else c)
    return y, torch.sin(a) * b, (a > 0).to(torch.int32), b > 0.5


_stand_in = torch.no_grad()(_twin)


@pytest.mark.parametrize("case", ["both", "one_and_none", "int_and_bool",
                                  "no_grad"])
def test_the_bridge_gives_the_twins_gradients(case):
    """kernels.with_twin with a stand-in kernel: its outputs are the
    kernel's; gradients equal the twin's under autograd for the inputs that
    need them (None for the others, and a None input passes through);
    integer and bool outputs carry no gradient; where no input needs a
    gradient, nothing records and the twin never runs."""
    gen = torch.Generator().manual_seed(4)
    a, b = torch.randn(64, generator=gen), torch.rand(64, generator=gen)
    c = None if case == "one_and_none" else torch.randn(64, generator=gen)
    need = {"both": (a, b), "one_and_none": (a,), "int_and_bool": (b,),
            "no_grad": ()}[case]
    for x in need:
        x.requires_grad_(True)
    calls = []

    def twin(*xs):
        calls.append(1)
        return _twin(*xs)

    got = kernels.with_twin(_stand_in, twin, a, b, c)
    ref = _twin(a, b, c)
    for y, r in zip(got, ref):
        assert torch.equal(y, r)
    assert not got[2].requires_grad and not got[3].requires_grad
    if not need:
        assert not got[0].requires_grad and calls == []
        return
    w = torch.randn(64, generator=gen)
    g_got = torch.autograd.grad((got[0] * w + got[1]).sum(), need,
                                retain_graph=True)
    g_ref = torch.autograd.grad((ref[0] * w + ref[1]).sum(), need)
    assert calls == [1]
    for x, y in zip(g_got, g_ref):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    if case == "int_and_bool":      # the int and bool outputs feed a loss
        (g,) = torch.autograd.grad(
            (got[0] * got[2] + got[3].float()).sum(), b)
        assert torch.equal(g, a.detach() * got[2])


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
    c_tab = {"nodes8_c": scene.nodes8_c}
    shifted = torch.empty(scene.nodes8_c.numel() + 1, dtype=torch.int32,
                          device="cuda")[1:].view(scene.nodes8_c.shape)
    shifted.copy_(scene.nodes8_c)
    for variant in wide.VARIANTS:
        with pytest.raises(TypeError):     # an f32 root
            wide.wide_walk(*tabs, scene.wide_root.float(), *o, *d, act,
                           bound, variant=variant, **c_tab)
        with pytest.raises(ValueError):    # a root of two values
            wide.wide_walk(*tabs, scene.wide_root.repeat(2), *o, *d, act,
                           bound, variant=variant, **c_tab)
        with pytest.raises(ValueError):    # a CPU plane beside CUDA rays
            wide.wide_walk(*tabs, scene.wide_root, *o, *d, act.cpu(),
                           bound, variant=variant, **c_tab)
        with pytest.raises(ValueError):    # no kernel node table
            wide.wide_walk(*tabs, scene.wide_root, *o, *d, act, bound,
                           variant=variant)
        with pytest.raises(ValueError):    # the node table of fewer nodes
            wide.wide_walk(*tabs, scene.wide_root, *o, *d, act, bound,
                           variant=variant, nodes8_c=scene.nodes8_c[:128])
        with pytest.raises(ValueError):    # not 16-byte aligned
            wide.wide_walk(*tabs, scene.wide_root, *o, *d, act, bound,
                           variant=variant, nodes8_c=shifted)
    with pytest.raises(ValueError):        # tables cut mid-block
        wide.wide_walk(scene.nodes8_f[:4], scene.nodes8_i[:4], scene.tris8,
                       scene.wide_root, *o, *d, act, bound, **c_tab)
    b_tabs = (scene.tris_mxu_c, scene.tris_mxu_n)
    with pytest.raises(ValueError):        # a 128-wide compact table
        brute.brute(*b_tabs, scene.nodes8_f, scene.brute_tris, *o, *d)
    with pytest.raises(ValueError):        # part of a tile
        brute.brute(*b_tabs, scene.tris_brute[:256], 256, *o, *d)
    with pytest.raises(ValueError):        # more triangles than the table
        brute.brute(*b_tabs, scene.tris_brute, scene.tris_brute.shape[0] + 1,
                    *o, *d)
    with pytest.raises(ValueError):        # not 16-byte aligned
        brute.brute(b_tabs[0][:4 * 512], b_tabs[1][:512],
                    scene.tris_brute.reshape(-1)[1:1 + 512 * 20].reshape(
                        512, 20), 512, *o, *d)


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
    _same_bits((k_id, k_t0), binned.cull_plain(*args))
    s_args = (scene.treelet_i, scene.tris_packed, scene.tre_rows, *o, *d,
              bound, k_id)
    _same_bits(binned.stream(*s_args), binned.stream_plain(*s_args))
    w_args = (scene.bvh_packed_f, scene.bvh_packed_i, scene.tris_packed,
              scene.mesh_roots[0], *o, *d, act, bound)
    for a, b in zip(bvh_packet.packet_walk(*w_args),
                    bvh_packet.packet_walk_plain(*w_args)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()


def _wide_kernels_match(args, nodes8_c, min_hits=0):
    """Push, push with the cull and mask on the card against the plain walk,
    every output bit for bit, each one launch; the three equal. Returns the
    push outputs."""
    before = dict(kernels.LAUNCHES)
    push = wide.wide_walk(*args, nodes8_c=nodes8_c)
    assert int((push[0] > 0).sum()) >= min_hits
    for kw in ({"variant": "push"}, {"variant": "push", "cull": True},
               {"variant": "mask"}):
        got = wide.wide_walk(*args, nodes8_c=nodes8_c, **kw)
        _same_bits(got, wide.wide_walk_plain(*args, **kw))
        _same_bits(got, push)
    assert kernels.LAUNCHES["wide_push"] == before["wide_push"] + 3
    assert kernels.LAUNCHES["wide_mask"] == before["wide_mask"] + 1
    return push


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["teapot", "animal"])
def test_wide_kernels_match_plain_versions_on_the_card(name):
    """Both stack disciplines (and the push cull) against the plain walk:
    t and integers bit for bit, normals too (-fmad=false); push and mask
    equal. Also on a pool with no active lane, a pool of one lane, one
    whose length is no multiple of 32, and one with 1.3% of its lanes
    active (as the binned fallback's)."""
    _need_cuda()
    scene, _ = load_scene(scene_path(name), "cuda", wide_tables=True)
    o, d, bound, act = _planes(65536, 1, "cuda")
    tabs = (scene.nodes8_f, scene.nodes8_i, scene.tris8, scene.wide_root)
    _wide_kernels_match((*tabs, *o, *d, act, bound), scene.nodes8_c, 100)
    sparse = (torch.rand(65536, generator=torch.Generator().manual_seed(3))
              < 0.013).to(torch.int32).cuda()
    pools = {"none active": (65536, torch.zeros_like(act)),
             "one lane": (1, act[:1] * 0 + 1),
             "1000 lanes": (1000, act[:1000]),
             "1.3% active": (65536, sparse)}
    for label, (n, a) in pools.items():
        got = _wide_kernels_match(
            (*tabs, *(c[:n] for c in o), *(c[:n] for c in d), a, bound[:n]),
            scene.nodes8_c)
        if label == "none active":
            assert (got[0] == -1).all() and (got[4] == -1).all(), label
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENES))
def test_wide_kernels_keep_the_tie_rules_on_the_card(name):
    """The crafted ties of tests/torch_wide_scenes.py: the kernels keep the
    triangle each tie rule names, bit for bit with the plain walk."""
    _need_cuda()
    nodes, tris, root, o, d, mats = SCENES[name]()
    nf, ni, t8 = pack_wide_tables(nodes, tris)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    n = o.shape[1]
    args = (t(nf), t(ni), t(t8), t(np.array([root], np.int32)),
            *map(t, o), *map(t, d), t(np.ones(n, np.int32)),
            t(np.full(n, FLT_MAX, np.float32)))
    push = _wide_kernels_match(args, t(pack_wide_nodes(nf, ni)))
    assert (push[4].cpu().numpy() == mats).all()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_brute_kernel_matches_plain_version_on_the_card():
    _need_cuda()
    scene, _ = load_scene(scene_path("teapot"), "cuda", brute_tables=True)
    o, d, _, _ = _planes(16384, 2, "cuda")
    args = (scene.tris_mxu_c, scene.tris_mxu_n, scene.tris_brute,
            scene.brute_tris, *o, *d)
    before = kernels.LAUNCHES["brute"]
    got = brute.brute(*args)
    assert kernels.LAUNCHES["brute"] == before + 1
    assert int((got[0] > 0).sum()) > 100
    _same_bits(got, brute.brute_plain(*plain_args(args)))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", EXACT_CASES)
def test_brute_kernel_on_exact_and_non_finite_rays(kind):
    """exact_soup (a sweep of 700 triangles, not a whole number of chunks)
    against rays whose sums cancel exactly, through the origin, and with
    non-finite features, on 1,000 lanes (not a whole number of blocks):
    every output by its bits."""
    _need_cuda()
    from pathtracer_tpu_torch.scene.types import pack_tris_mxu
    tris = exact_soup()
    coeffs, attrs = pack_tris_mxu(tris)
    args = brute_args(coeffs, attrs, *exact_rays(tris, kind), "cuda")
    assert args[3] % 128 and args[4].shape[0] % 256   # chunk, rays a block
    got = brute.brute(*args)
    _same_bits(got, brute.brute_plain(*plain_args(args)))
    if kind != "non_finite":
        assert int((got[0] > 0).sum()) > 100
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 4097])
def test_brute_kernel_on_ragged_pools(n):
    _need_cuda()
    scene, _ = load_scene(scene_path("teapot"), "cuda", brute_tables=True)
    o, d, _, _ = _planes(n, 3, "cuda")
    args = (scene.tris_mxu_c, scene.tris_mxu_n, scene.tris_brute,
            scene.brute_tris, *o, *d)
    _same_bits(brute.brute(*args), brute.brute_plain(*plain_args(args)))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", ["one", "animal"])
def test_brute_kernel_on_one_tile_and_many(tiles):
    """One 512-triangle tile (exact_soup's first 300 triangles) and the
    93 tiles of animal.json (47,238 triangles swept) on rays aimed at its
    mesh's box."""
    _need_cuda()
    from pathtracer_tpu_torch.scene.types import pack_tris_mxu
    if tiles == "one":
        tris = {k: v[:300] for k, v in exact_soup().items()}
        coeffs, attrs = pack_tris_mxu(tris)
        args = brute_args(coeffs, attrs, *exact_rays(tris, "vertices"),
                          "cuda")
    else:
        scene, _ = load_scene(scene_path("animal"), "cuda",
                              brute_tables=True)
        o, d, _ = aimed_planes(scene, 8192, 4, "cuda")
        args = (scene.tris_mxu_c, scene.tris_mxu_n, scene.tris_brute,
                scene.brute_tris, *o, *d)
    got = brute.brute(*args)
    assert int((got[0] > 0).sum()) > 100
    _same_bits(got, brute.brute_plain(*plain_args(args)))
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
    assert int((k_id < binned.TREELET_NONE).sum()) > 1000
    _same_bits((k_id, k_t0), binned.cull_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["teapot", "animal"])
def test_cull_and_stream_on_every_binned_pass(name):
    """Every cull and stream call of the binned pipeline on the card gets
    the pool that pass hands it (sorted per column, live lanes and lanes
    with a treelet at the column heads): each bit-equal to its plain
    version on those inputs."""
    _need_cuda()
    scene, _ = load_scene(scene_path(name), "cuda")
    o, d, bound = aimed_planes(scene, 65536, 11, "cuda")
    act = (torch.arange(65536, device="cuda") % 5 > 0)
    calls = {"cull": [], "stream": []}

    def recording(key, fn):
        def wrapper(*args):
            calls[key].append(args)
            return fn(*args)
        return wrapper

    with mock.patch.object(binned, "cull", recording("cull", binned.cull)), \
            mock.patch.object(binned, "stream",
                              recording("stream", binned.stream)):
        binned.mesh_intersect_binned(scene, scene.mesh_roots, Vec3(*o),
                                     Vec3(*d), active=act, t_bound=bound)
    passes = 3 if name == "animal" else 2
    assert len(calls["cull"]) == passes + 1
    assert len(calls["stream"]) == passes
    for args in calls["cull"]:
        _same_bits(binned.cull(*args), binned.cull_plain(*args))
    assert int((calls["stream"][0][-1] < binned.TREELET_NONE).sum()) > 1000
    for args in calls["stream"]:
        _same_bits(binned.stream(*args), binned.stream_plain(*args))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["teapot", "animal"])
def test_cull_and_stream_on_box_faces(name):
    """Origins exactly on treelet box faces: entry t0 of +0 and -0, whose
    bits the cull must keep; two enumeration steps."""
    _need_cuda()
    scene, _ = load_scene(scene_path(name), "cuda")
    o, d = (list(torch.from_numpy(c).cuda() for c in a)
            for a in plane_rays(scene.treelet_f.cpu(), 16384, 12))
    n = 16384
    bound = torch.full((n,), FLT_MAX, device="cuda")
    live = torch.ones(n, dtype=torch.int32, device="cuda")
    (k_id, k_t0), _ = _cull_then_stream(scene, o, d, bound, live)
    zero = k_t0 == 0
    assert int((zero & torch.signbit(k_t0)).sum()) > 100
    assert int((zero & ~torch.signbit(k_t0)).sum()) > 100
    _cull_then_stream(scene, o, d, bound, live, k_t0, k_id)


@pytest.mark.cuda
def test_cull_and_stream_keep_the_tie_rule(tmp_path):
    """Equal treelet boxes (the tie scene's two treelets of one coincident
    group) tie on t0: the lower id first, then the other at the same t0;
    the stream keeps the first coincident triangle of its treelet."""
    _need_cuda()
    scene, _ = load_scene(write_tie_scene(str(tmp_path)), "cuda")
    o, d, group = tie_rays(4096, 8)
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    o, d = list(map(c, o)), list(map(c, d))
    n = group.shape[0]
    bound = torch.full((n,), FLT_MAX, device="cuda")
    live = torch.ones(n, dtype=torch.int32, device="cuda")
    (k_id, k_t0), hit = _cull_then_stream(scene, o, d, bound, live)
    g0 = torch.from_numpy(group == 0).cuda()
    assert bool((k_id[g0] == 0).all())
    assert bool((hit[4][g0] == 1).all()) and bool((hit[4][~g0] == 3).all())
    (k2_id, k2_t0), _ = _cull_then_stream(scene, o, d, bound, live, k_t0,
                                          k_id)
    assert bool((k2_id[g0] == 1).all())
    assert torch.equal(k2_t0[g0], k_t0[g0])


@pytest.mark.cuda
@pytest.mark.parametrize("n,live_share", [(1, 1.0), (31, 0.7), (33, 0.7),
                                          (4097, 0.7), (65536, 0.0)])
def test_cull_and_stream_on_ragged_and_dead_pools(n, live_share):
    """One lane, sizes that are not a multiple of 32 (or 256), and a pool
    with no live lane (every lane NONE, then every lane a miss)."""
    _need_cuda()
    scene, _ = load_scene(scene_path("teapot"), "cuda")
    o, d, bound = aimed_planes(scene, n, 13, "cuda")
    live = (torch.from_numpy(np.random.default_rng(n).uniform(size=n))
            < live_share).to(torch.int32).cuda()
    (k_id, k_t0), hit = _cull_then_stream(scene, o, d, bound, live)
    if live_share == 0.0:
        assert bool((k_id == binned.TREELET_NONE).all())
        assert bool((hit[4] == -1).all())


@pytest.mark.cuda
def test_cull_and_stream_back_to_back_on_one_stream():
    """n shrinking and growing between calls on one stream, the grid cached
    per (kernel, device, shared memory): every result exact."""
    _need_cuda()
    scene, _ = load_scene(scene_path("teapot"), "cuda")
    for n in (65536, 1, 4097, 641024, 31, 65536):
        o, d, bound = aimed_planes(scene, n, n, "cuda")
        live = torch.ones(n, dtype=torch.int32, device="cuda")
        _cull_then_stream(scene, o, d, bound, live)


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


def _stream_pool(scene, n, seed, device):
    """A first-pass stream input on `device`: aimed rays, each lane's
    nearest wanted treelet, the pool sorted by it per column as the bin
    sort leaves it (n a multiple of 128)."""
    o, d, bound = aimed_planes(scene, n, seed, device)
    tid, _ = binned.cull(scene.treelet_f, scene.treelet_super, *o, *d, bound,
                         torch.full((n,), -FLT_MAX, device=device),
                         torch.full((n,), -1, dtype=torch.int32,
                                    device=device),
                         torch.ones(n, dtype=torch.int32, device=device))
    tid, *planes = binned._seg_sort(tid, *o, *d, bound)
    return (scene.treelet_i, scene.tris_packed, scene.tre_rows, *planes,
            tid)


def test_cpu_tensors_take_the_plain_versions_of_the_forms():
    """The K-want cull and every stream form take their plain versions on
    CPU tensors: no launch, no build."""
    scene, _ = load_scene(scene_path("teapot"), "cpu")
    before = dict(kernels.LAUNCHES)
    o, d, bound, act = _planes(256, 0, "cpu")
    c_args = (scene.treelet_f, scene.treelet_super, *o, *d, bound,
              torch.full((256,), -FLT_MAX),
              torch.full((256,), -1, dtype=torch.int32), act)
    for a, b in zip(binned.cull(*c_args, k=3),
                    binned.cull_plain(*c_args, k=3)):
        assert torch.equal(a, b)
    s_args = _stream_pool(scene, 256, 0, "cpu")
    kw = dict(uv=True, min_support=8, treelet_chunk=scene.treelet_chunk)
    for a, b in zip(binned.stream(*s_args, **kw),
                    binned.stream_plain(*s_args, **kw)):
        assert torch.equal(a, b)
    assert kernels.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["teapot", "animal"])
@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_cull_k_wants_match_plain_version_on_the_card(name, k):
    """The K-want cull against its plain version, [k, n] ids and t0s bit
    for bit, over two enumeration steps (resuming after slot k-1), one
    launch a call logged as cull_k<k>; slot 0 is the one-want cull's."""
    _need_cuda()
    scene, _ = load_scene(scene_path(name), "cuda")
    n = 65536
    o, d, bound = aimed_planes(scene, n, 21, "cuda")
    live = (torch.arange(n, device="cuda") % 7 > 0).to(torch.int32)
    pt0 = torch.full((n,), -FLT_MAX, device="cuda")
    pid = torch.full((n,), -1, dtype=torch.int32, device="cuda")
    for step in range(2):
        args = (scene.treelet_f, scene.treelet_super, *o, *d, bound, pt0,
                pid, live)
        kernels.reset_counts()
        got = binned.cull(*args, k=k)
        assert kernels.LAUNCHES["cull"] == 1
        assert kernels.FORMS == {f"cull_k{k}": 1}
        assert got[0].shape == (k, n)
        _same_bits(got, binned.cull_plain(*args, k=k))
        _same_bits((got[0][0], got[1][0]), binned.cull(*args))
        if step == 0:
            assert int((got[0][k - 1] < binned.TREELET_NONE).sum()) > 1000
        pt0, pid = got[1][k - 1].contiguous(), got[0][k - 1].contiguous()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["teapot", "animal"])
@pytest.mark.parametrize("form", ["uv", "defer", "gate", "uv_gate",
                                  "defer_gate"])
def test_stream_forms_match_plain_versions_on_the_card(name, form):
    """Each stream form against its plain version on a first-pass pool,
    every output bit for bit (inc too), one launch logged with its form;
    the gated outputs equal the ungated ones, and the deferring form's
    inc covers a partial last block of lanes."""
    _need_cuda()
    scene, _ = load_scene(scene_path(name), "cuda")
    n = 65536 + 384
    args = _stream_pool(scene, n, 23, "cuda")
    kw = {}
    if "uv" in form:
        kw["uv"] = True
    if "defer" in form:
        kw["min_support"] = 64
    if "gate" in form:
        kw["treelet_chunk"] = scene.treelet_chunk
    kernels.reset_counts()
    got = binned.stream(*args, **kw)
    assert kernels.LAUNCHES["stream"] == 1
    assert kernels.FORMS == {"stream_" + form: 1}
    _same_bits(got, binned.stream_plain(*args, **kw))
    if "gate" in form:
        kw.pop("treelet_chunk")
        _same_bits(got, binned.stream(*args, **kw))
    if "defer" in form:
        inc = got[5]
        assert 0 < int(inc.sum()) < int((args[-1] < binned.TREELET_NONE)
                                        .sum())
    assert int((got[0] > 0).sum()) > 1000
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_stream_kernel_on_the_expanded_pool():
    """The default stream on a four-fold pool (the expansion pipeline's
    2.6 million lanes at 800x800): its persistent grid covers every lane,
    bit for bit against the plain version on a sample of them."""
    _need_cuda()
    scene, _ = load_scene(scene_path("teapot"), "cuda")
    args = _stream_pool(scene, 4 * 655360, 29, "cuda")
    got = binned.stream(*args)
    idx = torch.arange(0, args[-1].shape[0], 97, device="cuda")
    sub = args[:3] + tuple(a[idx].contiguous() for a in args[3:])
    ref = binned.stream_plain(*sub)
    _same_bits(tuple(g[idx] for g in got), ref)
    assert int((got[0] > 0).sum()) > 100000


BINNED_FORMS = [
    (dict(expand=2), {}), (dict(expand=4), {}), (dict(slots=3), {}),
    ({}, dict(MIN_SUPPORT=64)), ({}, dict(CHUNK_GATE=True)),
    ({}, dict(STREAM_UV=True)), ({}, dict(BIN_CONTIGUOUS=True)),
    ({}, dict(CAND_KEY="octcell")),
    (dict(slots=3), dict(MIN_SUPPORT=16, CHUNK_GATE=True)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kw,flags", BINNED_FORMS)
def test_binned_forms_on_the_card_match_the_default(kw, flags):
    """Each pipeline shape and kernel form on the card gives the default
    pipeline's hits on active lanes bit for bit (tests/
    test_torch_binned_forms.py holds them to it on the CPU)."""
    _need_cuda()
    scene, _ = load_scene(scene_path("teapot"), "cuda")
    o, d, bound, act = _planes(16384, 5, "cuda")
    a = act > 0
    ref = binned.mesh_intersect_binned(scene, scene.mesh_roots, Vec3(*o),
                                       Vec3(*d), active=a, t_bound=bound)
    with mock.patch.multiple(binned, **flags, PASSES=None):
        got = binned.mesh_intersect_binned(scene, scene.mesh_roots, Vec3(*o),
                                           Vec3(*d), active=a, t_bound=bound,
                                           **kw)
    assert int((ref[0][a] > 0).sum()) > 500
    _same_bits((got[0][a], *(c[a] for c in got[1]), got[2][a]),
               (ref[0][a], *(c[a] for c in ref[1]), ref[2][a]))


@pytest.mark.cuda
def test_threefry_draws_on_the_card_match_the_cpu():
    """The threefry streams on the card: uniforms equal the CPU's bit for
    bit, normals within 4 ulp (the libms' log1p may round differently)."""
    _need_cuda()
    from pathtracer_tpu_torch.ops import rng
    key = rng.fold_in(rng.key(5), 3)
    for n, m in ((640000, 5), (1001, 2)):
        u = rng.uniforms(key, n, m, "cuda")
        assert torch.equal(u.cpu().view(torch.int32),
                           rng.uniforms(key, n, m, "cpu").view(torch.int32))
        z = rng.normals(key, n, m, "cuda").cpu()
        ref = rng.normals(key, n, m, "cpu")
        ulp = (z.view(torch.int32).long() - ref.view(torch.int32).long())
        assert int(ulp.abs().max()) <= 4
