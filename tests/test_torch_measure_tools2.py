"""PyTorch port, the mesh path's measurement tools (pathtracer_tpu_torch/
tools/: trace_stats, sweep_mesh, profile_binned, profile_binned2,
diag_bins, bench_sorts, exp_r5, exp_r5b, union_model, sim_wide) and the
engine's profiler ranges, on the CPU.

Held against the JAX tools (tools/, loaded from the repo root) where they
compute the same thing: make_bounce_rays (hit exact; o, d and the bound
within 1e-5 relative, the cosine-hemisphere transcendentals), union_model's
costs and sim_wide's pop counts (exact integers on the same rays and
tables), and the _seg_sort calls of the binned pipeline (count, operands,
key dtype, traced from JAX's pipeline without running it). The rest is held
against the port itself: the profile_binned2 replica against
mesh_intersect_binned bit for bit, the radix sort against torch.sort, every
exp_r5b arm's image against base's, the engine's ranges against a render
without them, and trace_stats' attribution on synthetic events and on a
CPU profile of a teapot frame.
"""
import ast
import os
import sys
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from pathtracer_tpu_torch import load_scene
from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.ops import binned
from pathtracer_tpu_torch.scene.fixtures import REPO_ROOT, scene_path
from pathtracer_tpu_torch.tools import (bench_sorts, diag_bins, exp_r5,
                                        exp_r5b, profile_binned,
                                        profile_binned2, sim_wide,
                                        sweep_mesh, trace_stats, union_model)
from pathtracer_tpu_torch.utils import profiling

torch.set_num_threads(2)

TOOLS = ("trace_stats", "sweep_mesh", "profile_binned", "profile_binned2",
         "diag_bins", "bench_sorts", "exp_r5", "exp_r5b", "union_model",
         "sim_wide")


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def same(a, b) -> bool:
    return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def pool():
    return sweep_mesh.make_pool(scene_path("teapot"), "cpu",
                                {"RES": [32, 32]})


# ---------------------------------------------------------------------------
# sweep_mesh: the bounce-ray pool against the JAX tool's
# ---------------------------------------------------------------------------

def test_make_bounce_rays_matches_jax(pool):
    from pathtracer_tpu import load_scene as jax_load
    from tools import sweep_mesh as jsweep
    j_scene, j_set = jax_load(scene_path("teapot"),
                              overrides={"RES": [32, 32]})
    o, d, hit = jsweep.make_bounce_rays(j_scene, j_set)
    tb = jsweep.analytic_bound(j_scene, j_set, o, d)
    np.testing.assert_array_equal(pool.hit.numpy(), np.asarray(hit))
    for got, want in zip((*pool.o, *pool.d), (*o, *d)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    # a bound is a distance from the origin: its error is the origins'
    # absolute one (1e-5 of coordinates up to ~5), also where it is short
    np.testing.assert_allclose(pool.tb.numpy(), np.asarray(tb), rtol=1e-5,
                               atol=1e-5)
    assert pool.hit.sum() > 500


@pytest.mark.parametrize("mode", ["split", "prod", "tune"])
def test_sweep_modes_run_and_restore_flags(pool, mode):
    flags = {k: getattr(binned, k) for k in (
        "FALLBACK", "STREAM_OFF", "CULL_CHEAP", "FB_COMPACT", "CAND_SORT")}
    lines = []
    rows = sweep_mesh.sweep(pool, mode, reps=1, out=lines.append)
    assert len(rows) == len(lines) == {"split": 5, "prod": 1,
                                       "tune": 8}[mode]
    assert all(ms > 0 for _, ms in rows)
    assert {k: getattr(binned, k) for k in flags} == flags


def test_flags_restore_after_an_error():
    with pytest.raises(ZeroDivisionError):
        with sweep_mesh.flags(FALLBACK=False, PASSES=4):
            1 / 0
    assert binned.FALLBACK is True and binned.PASSES is None


# ---------------------------------------------------------------------------
# the engine's ranges and the flags at their defaults
# ---------------------------------------------------------------------------

def render_image(scene, settings):
    return wavefront.render(scene, settings, iterations=2, seed=0)


@pytest.fixture(scope="module")
def teapot64():
    return load_scene(scene_path("teapot"), "cpu",
                      overrides={"RES": [64, 64], "DEPTH": 4})


def test_default_image_equals_the_replica_pipeline(teapot64):
    """With the flags at their defaults, the 64x64 teapot image through
    mesh_intersect_binned equals, bit for bit, the image through
    profile_binned2.pipeline, the default pipeline written without the
    flags; with and without the engine's ranges."""
    scene, settings = teapot64

    def replica(sc, roots, o, d, active=None, t_bound=None):
        return profile_binned2.pipeline(sc, roots, o, d, active, t_bound)

    img = render_image(scene, settings)
    with trace_stats.ranges_off():
        np.testing.assert_array_equal(render_image(scene, settings), img)
    with mock.patch.object(binned, "mesh_intersect_binned", replica):
        np.testing.assert_array_equal(render_image(scene, settings), img)
    assert img.max() > 0


@pytest.mark.parametrize("mode", [{"sort_materials": True},
                                  {"compact": True, "compact_tile": 256}])
def test_engine_ranges_leave_the_modes_bit_equal(mode):
    import dataclasses
    scene, settings = load_scene(scene_path("teapot"), "cpu",
                                 overrides={"RES": [32, 32], "DEPTH": 3})
    settings = dataclasses.replace(settings, **mode)
    img = render_image(scene, settings)
    with trace_stats.ranges_off():
        np.testing.assert_array_equal(render_image(scene, settings), img)


# ---------------------------------------------------------------------------
# trace_stats
# ---------------------------------------------------------------------------

def ev(name, start, end, parent=None, device=False, id=0, linked=0):
    return types.SimpleNamespace(
        name=name, key=name, id=id, linked_correlation_id=linked,
        cpu_parent=parent,
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=start, end=end),
        is_user_annotation=False)


def test_stage_split_synthetic_events():
    """Nested ranges: a kernel goes to the first stage of STAGES open at its
    launch (pt_mi_sort inside pt_intersect), once; a range's device-side
    span counts nothing; a kernel launched outside every range is
    unattributed, one with no host call unlinked; host time is exclusive
    of nested stage ranges."""
    isect = ev("pt_intersect", 0, 100)
    sort = ev("pt_mi_sort", 10, 40, parent=isect)
    op = ev("aten::sort", 12, 30, parent=sort, id=7)
    shade = ev("pt_shade", 100, 150)
    events = [
        isect, sort, op, shade,
        ev("cudaLaunchKernel", 15, 16, parent=op, id=1001),   # in the sort
        ev("cuLaunchKernel", 50, 51, id=1002),        # ctypes, pt_intersect
        ev("cudaLaunchKernel", 120, 121, id=1003),            # pt_shade
        ev("cudaMemcpyAsync", 160, 161, id=1004),              # no range
        ev("sort_kernel", 200, 205, device=True, id=1001, linked=7),
        ev("cull_kernel", 205, 208, device=True, id=1002),
        ev("shade_kernel", 208, 210, device=True, id=1003),
        ev("Memcpy DtoH", 210, 211, device=True, id=1004),
        ev("lost_kernel", 211, 215, device=True, id=1005),
        ev("pt_mi_sort", 200, 206, device=True),   # a range's device span
        ev("elementwise", 215, 216, device=True, id=1006, linked=7),
    ]
    s = trace_stats.stage_split(events)
    assert s["device_us"] == {
        "pt_mi_sort": 6.0, "pt_mi_cull": 0.0, "pt_mi_stream": 0.0,
        "pt_mi_fb": 0.0, "pt_raygen": 0.0, "pt_intersect": 3.0,
        "pt_shade": 2.0, "pt_gather": 0.0, trace_stats.OTHER: 1.0,
        trace_stats.UNLINKED: 4.0}
    assert s["device_total_us"] == sum(s["device_us"].values()) == 16.0
    assert s["launches"]["pt_mi_sort"] == 2
    assert s["kernels"]["pt_mi_sort"] == {"sort_kernel": [5.0, 1],
                                          "elementwise": [1.0, 1]}
    assert s["host_us"]["pt_intersect"] == 70.0
    assert s["host_us"]["pt_mi_sort"] == 30.0
    assert s["host_us"]["pt_shade"] == 50.0
    assert s["ranges"]["pt_mi_sort"] == 1


def test_trace_stats_cpu_profile_of_a_teapot_frame(capsys):
    scene, settings = load_scene(scene_path("teapot"), "cpu",
                                 overrides={"RES": [16, 16], "DEPTH": 2})
    res = trace_stats.split_frames(scene, settings, frames=1)
    assert not res["on_device"] and res["wall_ms"] > 0
    for stage in trace_stats.STAGES:
        assert res["ranges"][stage] >= 1, stage
        assert res["host_ms"][stage] >= 0
    assert res["ranges"]["pt_intersect"] == 2        # one a bounce
    assert res["ranges"]["pt_mi_sort"] == 8          # 4 a bounce
    text = trace_stats.table(res)
    assert all(s in text for s in trace_stats.STAGES)


def test_range_cost_runs_both_arms():
    scene, settings = load_scene(scene_path("cornell"), "cpu",
                                 overrides={"RES": [16, 16], "DEPTH": 2})
    lines = []
    res = trace_stats.range_cost(scene, settings, chunk=1, rounds=1,
                                 out=lines.append)
    assert len(res["on"]) == len(res["off"]) == 2 and len(lines) == 2
    assert wavefront.record_function is torch.profiler.record_function


def test_profiler_ranges_are_the_stages():
    """Every range the engine and the binned pipeline open is a stage of
    trace_stats and a range that utils/profiling leaves out of device time;
    a device-side span of one is no kernel there."""
    names = set()
    for mod in (wavefront, binned):
        tree = ast.parse(open(mod.__file__).read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", "") == "record_function"):
                names.add(node.args[0].value)
    assert names == set(trace_stats.STAGES) == profiling.RANGES
    span = types.SimpleNamespace(key="pt_mi_sort", is_user_annotation=False)
    kern = types.SimpleNamespace(key="void cull_kernel<1>()",
                                 is_user_annotation=False)
    assert profiling.is_range_span(span) and not profiling.is_range_span(kern)


# ---------------------------------------------------------------------------
# profile_binned, profile_binned2: the sorts and the prefix cuts
# ---------------------------------------------------------------------------

def jax_seg_sort_calls(monkeypatch) -> list:
    """(operands, key dtype) of each _seg_sort call of JAX's binned pipeline
    on the teapot (its default shape), traced with jax.make_jaxpr."""
    import pathtracer_tpu.ops.binned as jb
    from pathtracer_tpu import load_scene as jax_load
    from pathtracer_tpu.utils.vec import Vec3 as JVec3
    calls = []
    orig = jb._seg_sort

    def recording(chunk, key, *arrays):
        calls.append((1 + len(arrays), str(key.dtype)))
        return orig(chunk, key, *arrays)

    monkeypatch.setattr(jb, "_seg_sort", recording)
    scene, settings = jax_load(scene_path("teapot"),
                               overrides={"RES": [16, 16]})
    roots = tuple(scene.geoms.root_node[i]
                  for i, g in enumerate(settings.geom_types) if g == 2)
    n = 2048
    v = JVec3(*(jnp.ones(n) for _ in range(3)))
    jax.make_jaxpr(lambda o, d: jb.mesh_intersect_binned.__wrapped__(
        scene, roots, o, d, active=jnp.ones(n, bool),
        t_bound=jnp.ones(n), interpret=True))(v, v)
    return calls


def test_sort_sites_are_the_jax_pipelines(pool, monkeypatch):
    """The port sorts what the JAX pipeline sorts: the same _seg_sort calls
    in the same order, with the same operand counts and int32 keys."""
    port = [(1 + len(a), str(k.dtype).replace("torch.", ""))
            for _, k, a in profile_binned.sort_calls(pool)]
    assert port == [(10, "int32"), (15, "int32"), (15, "int32"),
                    (6, "int32")]
    assert port == jax_seg_sort_calls(monkeypatch)


def test_profile_binned_runs(pool):
    lines = []
    res = profile_binned.profile(pool, reps=1, out=lines.append)
    assert len(res["sort_sites"]) == 4 and res["seg sort 16 operands"] > 0
    assert all(r["site"].startswith("binned.py:") for r in res["sort_sites"])


@pytest.mark.parametrize("big", [False, True])
def test_profile_binned2_full_cut_equals_the_pipeline(pool, big):
    """stop=300 is mesh_intersect_binned bit for bit, on the small-mesh
    shape and with the big-mesh compaction sort forced; every cut runs and
    the residual is counted."""
    with mock.patch.object(binned, "PASSES_BIG_TRIS", 0 if big else 24000):
        got = profile_binned2.pipeline(pool.scene, pool.roots, pool.o,
                                       pool.d, pool.hit, pool.tb)
        ref = binned.mesh_intersect_binned(pool.scene, pool.roots, pool.o,
                                           pool.d, active=pool.hit,
                                           t_bound=pool.tb)
        assert same([got[0], *got[1], got[2]], [ref[0], *ref[1], ref[2]])
        lines = []
        res = profile_binned2.prefix_times(pool, reps=1, out=lines.append)
    passes = 3 if big else 2
    assert set(res) == set(profile_binned2.cuts(passes)) | {"remaining"}
    assert 0 <= res["remaining"] <= int(pool.hit.sum())
    assert len(lines) == len(profile_binned2.cuts(passes)) + 1


# ---------------------------------------------------------------------------
# diag_bins, exp_r5, exp_r5b, bench_sorts
# ---------------------------------------------------------------------------

def test_pass_stats_by_hand():
    none = binned.TREELET_NONE
    tid = np.full(4096, none, np.int32)
    tid[:3] = [5, 5, 7]                # block 0: ids 5 (x2), 7
    tid[2048:2049] = 9                 # block 1: id 9
    st = diag_bins.pass_stats(tid)
    assert (st["live"], st["blocks"], st["visits"], st["max"]) == (4, 2, 3, 2)
    assert st["mean"] == 1.5 and st["ideal"] == 4 / 2048 + 2
    assert st["support_cdf"][:2] == [2 / 3, 1.0]
    assert diag_bins.pass_stats(np.full(2048, none)) is None


def test_exp_r5_modes(pool):
    lines = []
    res = exp_r5.diag(pool, out=lines.append)
    assert set(res) == {False, True} and res[False] > 0 and res[True] > 0
    assert lines[-1] == f"contig=True TOTAL visits={res[True]}"
    key, payload = exp_r5.sort_operands(pool)
    assert key.shape[0] % binned.CONTIGUOUS == 0 and len(payload) == 14
    assert set(exp_r5.sorts(pool, reps=1, out=lambda s: None)) == {
        "column", "contiguous"}


def test_exp_r5b_arms_equal_base():
    res = exp_r5b.run_arms(scene_path("teapot"),
                           ["base", "p2", "p4", "gate", "contig"], "cpu",
                           {"RES": [32, 32], "DEPTH": 2}, rounds=1, chunk=1,
                           out=lambda s: None)
    assert res["equal"] == dict.fromkeys(
        ["base", "p2", "p4", "gate", "contig"], True)
    assert all(len(v) == 1 and v[0] > 0 for v in res["ms"].values())
    assert binned.PASSES is None and binned.BIN_CONTIGUOUS is False


def test_bench_sorts_radix_equals_torch_sort():
    keys, payload = bench_sorts.inputs("cpu", n=20000)
    got = bench_sorts.chain(bench_sorts.radix, keys, payload, 3)
    ref = bench_sorts.chain(bench_sorts.multisort, keys, payload, 3)
    assert torch.equal(got[0], ref[0]) and same(got[1], ref[1])
    assert len(got[1]) == bench_sorts.PAYLOADS
    ks, _ = bench_sorts.radix(keys, payload)
    assert torch.equal(ks, torch.sort(keys, stable=True).values)
    res = bench_sorts.bench("cpu", m=1, n=4096, reps=1, out=lambda s: None)
    assert res["radix"] > 0 and res["multisort"] > 0


def test_bench_sorts_check_catches_a_wrong_sort(monkeypatch):
    keys, payload = bench_sorts.inputs("cpu", n=4096)
    monkeypatch.setattr(bench_sorts, "radix",
                        lambda k, p: (k, p))     # no sort at all
    with pytest.raises(AssertionError):
        bench_sorts.check(keys, payload)


# ---------------------------------------------------------------------------
# union_model, sim_wide against the JAX tools
# ---------------------------------------------------------------------------

def synthetic_rays(n, seed=0):
    """Rays toward the teapot's box from around it: (ox, oy, oz, dx, dy, dz,
    act, tb) as float32 numpy, a quarter of them dead, a bound on half."""
    r = np.random.default_rng(seed)
    o = r.uniform(-6, 6, size=(3, n)).astype(np.float32)
    target = r.uniform(-1.5, 1.5, size=(3, n)).astype(np.float32)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    act = r.uniform(size=n) < 0.75
    tb = np.where(r.uniform(size=n) < 0.5, r.uniform(2, 12, size=n),
                  3.4028235e38).astype(np.float32)
    return (*o, *d, act, tb)


def test_union_model_matches_jax(monkeypatch, capsys):
    rays = synthetic_rays(union_model.SAMPLE * 2)
    scene, _ = load_scene(scene_path("teapot"), "cpu")
    port = union_model.union_lines(scene_path("teapot"), scene, *rays)
    import pathtracer_tpu
    from pathtracer_tpu import load_scene as jax_load
    import tools.sweep_mesh as js
    from pathtracer_tpu.utils.vec import Vec3 as JVec3
    j_scene = jax_load(scene_path("teapot"), max_leaf=96)
    o = JVec3(*map(jnp.asarray, rays[0:3]))
    d = JVec3(*map(jnp.asarray, rays[3:6]))
    monkeypatch.setattr(pathtracer_tpu, "load_scene",
                        lambda path, max_leaf=None: j_scene)
    monkeypatch.setattr(js, "make_bounce_rays",
                        lambda sc, st: (o, d, jnp.asarray(rays[6])))
    monkeypatch.setattr(js, "analytic_bound",
                        lambda sc, st, o, d: jnp.asarray(rays[7]))
    monkeypatch.setattr(sys, "argv", ["union_model.py",
                                      scene_path("teapot"), "96"])
    from tools import union_model as jax_union
    capsys.readouterr()
    jax_union.main()
    assert port == capsys.readouterr().out.splitlines()
    assert len(port) == 2 + 2 * len(union_model.CONFIGS)


@pytest.fixture(scope="module")
def wide_tables():
    tris8, wide_nodes, root = sim_wide.host_wide_tree(scene_path("teapot"))
    return tris8, wide_nodes, root


def test_sim_wide_matches_jax(pool, wide_tables):
    from tools import sim_wide as jax_sim
    tris8, wide_nodes, root = wide_tables
    port_tab = sim_wide.pack_host_tables(wide_nodes, tris8)
    jax_tab = jax_sim.pack_host_tables(wide_nodes, tris8)
    for a, b in zip(port_tab[:3], jax_tab[:3]):
        np.testing.assert_array_equal(a, b)
    h = lambda t: t.numpy()
    o = np.stack([h(c) for c in pool.o], 1).astype(np.float64)
    d = np.stack([h(c) for c in pool.d], 1).astype(np.float64)
    act, tb = h(pool.hit), h(pool.tb).astype(np.float64)
    order = sim_wide.octant_order(d, act)
    o, d, act, tb = o[order], d[order], act[order], tb[order]
    tot = np.zeros(3, np.int64)
    for p in range(0, 1024, 128):
        s = slice(p, p + 128)
        if not act[s].any():
            continue            # simulate skips a packet with no live ray
        got = sim_wide.simulate_packet(*port_tab, root, o[s], d[s], act[s],
                                       tb[s])
        want = jax_sim.simulate_packet(*jax_tab, root, o[s], d[s], act[s],
                                       tb[s])
        assert got[:3] == want[:3]
        np.testing.assert_array_equal(got[3], want[3])
        tot += got[:3]
    res = sim_wide.simulate(port_tab, root, o, d, act, tb)
    assert [res["node"], res["leaf"], res["dead"]] == tot.tolist()
    assert res["node"] > 0 and res["leaf"] > 0


def test_host_wide_tree_is_the_loaders(wide_tables):
    """The simulated tree is the one load_scene packs for the wide walk."""
    from pathtracer_tpu_torch.scene.types import pack_wide_tables
    tris8, wide_nodes, root = wide_tables
    scene, _ = load_scene(scene_path("teapot"), "cpu", wide_tables=True)
    nodes8_f, nodes8_i, packed = pack_wide_tables(wide_nodes, tris8)
    assert int(scene.wide_root[0]) == root
    for got, want in ((scene.nodes8_f, nodes8_f), (scene.nodes8_i, nodes8_i),
                      (scene.tris8, packed)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the tools' entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TOOLS)
def test_tool_needs_a_card_unless_told(name):
    """Each tool runs on cuda by default and raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    mod = sys.modules[f"pathtracer_tpu_torch.tools.{name}"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


@pytest.mark.parametrize("name", TOOLS)
def test_tool_imports_no_jax(name):
    """No new module imports jax or the JAX package (an AST walk of its
    imports; import time is test_torch_scene.py's
    test_port_never_imports_jax)."""
    path = os.path.join(REPO_ROOT, "pathtracer_tpu_torch", "tools",
                        name + ".py")
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "pathtracer_tpu")
    assert name in open(os.path.join(REPO_ROOT, "pathtracer_tpu_torch",
                                     "tools", "__init__.py")).read()


@pytest.mark.parametrize("argv", [
    ["diag_bins", "scenes/teapot.json", "--res", "16"],
    ["profile_binned2", "scenes/teapot.json", "2", "--res", "16",
     "--reps", "1"],
    ["exp_r5", "diag", "scenes/teapot.json", "--res", "16"],
    ["sim_wide", "scenes/teapot.json", "--res", "16", "--rays", "128"],
    ["sweep_mesh", "scenes/teapot.json", "prod", "--res", "16", "--reps",
     "1"],
])
def test_tool_main_on_the_cpu(argv, capsys):
    name, *args = argv
    args = [os.path.join(REPO_ROOT, a) if a.endswith(".json") else a
            for a in args]
    sys.modules[f"pathtracer_tpu_torch.tools.{name}"].main(
        args + ["--device", "cpu"])
    assert capsys.readouterr().out.strip()
