"""PyTorch port, the benchmark entry points (pathtracer_tpu_torch/tools/
bench.py and bench_suite.py) against the repo's bench.py and
tools/bench_suite.py (the JAX package's), on the CPU.

The matrix, the timed schedules and the headline line are held against the
JAX tools with their renders replaced by recorders (nothing renders, no
mesh is built); the port's timed work is held bit for bit against
render_chunk / render_persistent_chunk at small sizes; both entry points
run with --device cpu at 8x8 and raise without a card.
"""
import json
import math
import os
import re
import sys
import types

import pytest
import torch

import bench as jax_bench
import pathtracer_tpu
from pathtracer_tpu.engine import persistent as jpersistent
from pathtracer_tpu.engine import wavefront as jwavefront
from pathtracer_tpu.scene.types import RenderSettings as JaxSettings
from pathtracer_tpu_torch import load_scene
from pathtracer_tpu_torch.engine import persistent, wavefront
from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.scene.types import RenderSettings
from pathtracer_tpu_torch.tools import bench, bench_suite
from tools import bench_suite as jax_suite

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--res", "8", "--depth", "1"]
# fixed ms per (scene, sorted) for the headline comparison
FIXED_MS = {("cornell", False): 123.456, ("cornell", True): 150.5,
            ("teapot", False): 80.25, ("animal", False): 140.125}


def scene_name(path: str) -> str:
    return os.path.basename(path)[:-len(".json")]


def jax_matrix(tmp_path, monkeypatch, quick: bool) -> list:
    """The JAX tool's rows as its main() calls them: name, scene, loader
    arguments, settings replacements, engine and chunk."""
    calls = []

    def load(path, overrides=None, wide_tables=False):
        calls.append({"scene": scene_name(path), "overrides": overrides,
                      "wide_tables": wide_tables, "replace": {}})
        return None, JaxSettings(width=800, height=800)

    def replace(settings, **kw):
        calls[-1]["replace"] = kw
        return settings

    def timer(engine):
        def fn(scene, settings, chunk=30):
            calls[-1].update(engine=engine, chunk=chunk)
            return 1.0
        return fn

    out = tmp_path / "BENCH.md"
    monkeypatch.setattr(sys, "argv", ["bench_suite.py", "--out", str(out)]
                        + (["--quick"] if quick else []))
    monkeypatch.setattr(pathtracer_tpu, "load_scene", load)
    monkeypatch.setattr(jax_suite, "dataclasses",
                        types.SimpleNamespace(replace=replace))
    monkeypatch.setattr(jax_suite, "bench_wavefront", timer("wavefront"))
    monkeypatch.setattr(jax_suite, "bench_persistent", timer("persistent"))
    jax_suite.main()
    names = [r["config"] for r in json.loads(
        (tmp_path / "BENCH.json").read_text())]
    assert len(names) == len(calls)
    return [dict(name=n, **c) for n, c in zip(names, calls)]


@pytest.mark.parametrize("quick", [False, True])
def test_rows_equal_the_jax_matrix(tmp_path, monkeypatch, quick):
    want = jax_matrix(tmp_path, monkeypatch, quick)
    got = [{"name": r.name, "scene": r.scene, "overrides": r.overrides,
            "wide_tables": r.wide_tables, "replace": r.replace,
            "engine": r.engine, "chunk": r.chunk}
           for r in bench_suite.rows(quick)]
    assert got == want
    assert len(got) == (9 if quick else 17)


def check_timing(t: bench_suite.Timing, reps: int) -> None:
    assert len(t.reps_ms) == reps
    assert all(math.isfinite(x) and x > 0 for x in t.reps_ms)
    assert t.best <= t.median <= t.max


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


CASES = [("cornell", 16, 3), ("teapot", 16, 2)]


def small(name, res, depth):
    return load_scene(scene_path(name), "cpu", bvh_impl="binned"
                      if name == "teapot" else None,
                      overrides={"RES": [res, res], "DEPTH": depth})


@pytest.mark.parametrize("name,res,depth", CASES)
def test_bench_wavefront_times_the_render(name, res, depth):
    """The accumulator after the warm-up and the timed chunks is
    render_chunk's over the same iterations."""
    scene, settings = small(name, res, depth)
    timing, accum = bench_suite.bench_wavefront(scene, settings, chunk=2,
                                                reps=2)
    check_timing(timing, 2)
    ref = wavefront.zero_accum(settings, "cpu")
    wavefront.render_chunk(scene, settings, ref, 1, 6, 0, True)
    for a, b in zip(accum, ref):
        assert same_bits(a, b)


@pytest.mark.parametrize("name,res,depth", CASES)
def test_bench_persistent_times_the_render(name, res, depth):
    """The lane state after the chunks is render_persistent_chunk's at the
    targets chunk, 2 chunk, 3 chunk."""
    scene, settings = small(name, res, depth)
    timing, state = bench_suite.bench_persistent(scene, settings, chunk=2,
                                                 reps=2)
    check_timing(timing, 2)
    ref = persistent.fresh_lanes(settings, "cpu")
    stride = persistent.pixel_stride(settings.pixel_count)
    for target in (2, 4, 6):
        ref = persistent.render_persistent_chunk(scene, settings, ref,
                                                 target, 0, stride)
    assert state.flushed == ref.flushed == 6
    for a, b in zip(state.accum, ref.accum):
        assert same_bits(a, b)
    assert same_bits(state.round_buf, ref.round_buf)
    assert torch.equal(state.assign, ref.assign)


def schedule(monkeypatch, kind: str, port: bool) -> list:
    """The (start iteration, iterations) or persistent targets that one
    timing function renders, its renders replaced by a recorder."""
    calls = []

    def chunk(scene, settings, accum, start, n, *a, **k):
        calls.append((int(start), n))
        return accum

    def persist(scene, settings, state, target, *a, **k):
        calls.append(int(target))
        return state

    if port:
        monkeypatch.setattr(wavefront, "render_chunk", chunk)
        monkeypatch.setattr(persistent, "render_persistent_chunk", persist)
        scene = types.SimpleNamespace(device=torch.device("cpu"))
        settings = RenderSettings(width=8, height=8)
        fns = {"bench": lambda: bench.bench(scene, settings, chunk=50),
               "wavefront": lambda: bench_suite.bench_wavefront(
                   scene, settings, chunk=30),
               "persistent": lambda: bench_suite.bench_persistent(
                   scene, settings, chunk=32)}
    else:
        monkeypatch.setattr(jwavefront, "render_chunk", chunk)
        monkeypatch.setattr(jpersistent, "render_persistent_chunk", persist)
        settings = JaxSettings(width=8, height=8)
        fns = {"bench": lambda: jax_bench.bench(None, settings, chunk=50),
               "wavefront": lambda: jax_suite.bench_wavefront(
                   None, settings, chunk=30),
               "persistent": lambda: jax_suite.bench_persistent(
                   None, settings, chunk=32)}
    fns[kind]()
    return calls


@pytest.mark.parametrize("kind", ["bench", "wavefront", "persistent"])
def test_timed_schedule_equals_jax(monkeypatch, kind):
    want = schedule(monkeypatch, kind, port=False)
    got = schedule(monkeypatch, kind, port=True)
    assert got == want and len(got) == {"bench": 5, "wavefront": 4,
                                        "persistent": 4}[kind]


def headline(monkeypatch, capsys, port: bool, fail: str | None = None):
    """One headline line with every scene's timing fixed by FIXED_MS:
    (the printed object, the timed calls, the exit code)."""
    calls = []

    def load(path, *a, **k):
        cls = RenderSettings if port else JaxSettings
        return scene_name(path), cls(width=800, height=800, trace_depth=8)

    def timed(scene, settings, chunk, warmup=2, reps=3):
        calls.append((scene, settings.sort_materials, chunk, warmup, reps))
        if scene == fail:
            raise RuntimeError("boom")
        ms = FIXED_MS[(scene, settings.sort_materials)]
        return bench_suite.Timing([ms + 2, ms, ms + 1]) if port else ms

    if port:
        monkeypatch.setattr(bench, "load_scene", load)
        monkeypatch.setattr(bench, "bench", timed)
        rc = bench.main(["--device", "cpu"])
    else:
        monkeypatch.setattr(pathtracer_tpu, "load_scene", load)
        monkeypatch.setattr(jax_bench, "bench", timed)
        rc = jax_bench.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0]), calls, rc


def test_headline_line_equals_jax(monkeypatch, capsys):
    want, want_calls, _ = headline(monkeypatch, capsys, port=False)
    got, got_calls, rc = headline(monkeypatch, capsys, port=True)
    assert rc == 0 and got_calls == want_calls
    assert set(got) == set(want) | {"device"}
    assert got["device"] == {"name": "cpu", "power_limit": None}
    medians = {f"{s}_median_ms" for s in ("cornell", "cornell_sorted",
                                          "teapot", "animal")}
    assert set(got["extra"]) == set(want["extra"]) | medians
    for k in ("metric", "value", "unit", "vs_baseline"):
        assert got[k] == want[k], k
    for k, v in want["extra"].items():
        assert got["extra"][k] == v, k
    assert got["extra"]["teapot_median_ms"] == FIXED_MS[("teapot", False)] + 1


def test_headline_error_exits_nonzero(monkeypatch, capsys):
    got, _, rc = headline(monkeypatch, capsys, port=True, fail="teapot")
    assert rc == 1
    assert got["extra"]["teapot_error"] == "RuntimeError: boom"
    assert "animal_ms_per_frame" in got["extra"]


@pytest.mark.parametrize("tool", ["bench", "bench_suite"])
def test_no_cpu_fallback(monkeypatch, tmp_path, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "b.md"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if tool == "bench":
            bench.main([])
        else:
            bench_suite.main(["--quick", "--out", str(out)])
    assert not out.exists()


def test_bench_runs_on_cpu(capsys):
    assert bench.main(TINY) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "cornell_800x800_d8_ms_per_frame"
    assert line["value"] > 0 and line["device"]["name"] == "cpu"
    for s in ("cornell_sorted", "teapot", "animal"):
        assert line["extra"][f"{s}_ms_per_frame"] > 0


def test_bench_suite_runs_on_cpu(tmp_path):
    out = tmp_path / "q.md"
    assert bench_suite.main(TINY + ["--quick", "--out", str(out)]) == 0
    data = json.loads((tmp_path / "q.json").read_text())
    (run,) = data["runs"]
    assert run["card"] == "cpu" and run["size"] == {"RES": [8, 8],
                                                    "DEPTH": 1}
    assert [r["config"] for r in run["rows"]] == [
        r.name for r in bench_suite.rows(quick=True)]
    for rec in run["rows"]:
        assert rec["error"] is None and rec["device_ms"] is None
        assert rec["res"] == [8, 8] and rec["depth"] == 1
        check_timing(bench_suite.Timing(rec["reps_ms"]), bench_suite.REPS)
    md = out.read_text()
    assert bench_suite.REFERENCE_CARD in md and "TPU" not in md
    assert "## Failed rows\n\nNone." in md


def test_a_failing_row_fails_the_run(monkeypatch, tmp_path):
    """A row whose render raises is written with its error, the other rows
    still run, and the exit code is 1."""
    real = bench_suite.bench_wavefront

    def flaky(scene, settings, **kw):
        if settings.sort_materials:
            raise RuntimeError("boom")
        return real(scene, settings, **kw)

    monkeypatch.setattr(bench_suite, "bench_wavefront", flaky)
    monkeypatch.setattr(bench_suite, "rows", lambda quick: [
        bench_suite.row_named("cornell + material sort"),
        bench_suite.row_named("cornell defaults")])
    out = tmp_path / "f.md"
    assert bench_suite.main(TINY + ["--out", str(out)]) == 1
    rows = json.loads((tmp_path / "f.json").read_text())["runs"][0]["rows"]
    assert rows[0]["error"] == "RuntimeError: boom"
    assert rows[1]["error"] is None and rows[1]["ms_per_frame"] > 0
    assert ("- cornell + material sort, process 1: RuntimeError: boom"
            in out.read_text())


def test_merge_two_processes(tmp_path):
    """--merge writes one table of both runs and the headline lines."""
    size = {"RES": [4, 4], "DEPTH": 1}
    paths = []
    for i in range(2):
        recs = [bench_suite.run_row(bench_suite.row_named(n), "cpu", reps=1,
                                    size=size)
                for n in ("cornell defaults", "teapot d4")]
        run = {"card": "cpu", "device": "cpu", "torch": torch.__version__,
               "cuda": None, "quick": False, "reps": 1, "size": size,
               "rows": recs, "seconds": 1.0}
        paths.append(bench_suite.write_outputs([run], [], str(
            tmp_path / f"p{i}.md")))
    head = tmp_path / "head.txt"
    head.write_text('log line\n{"metric": "m", "value": 1.5}\n')
    out = tmp_path / "m.md"
    assert bench_suite.main(["--merge", *paths, "--headline", str(head),
                             "--out", str(out)]) == 0
    data = json.loads((tmp_path / "m.json").read_text())
    assert len(data["runs"]) == 2 and data["headline"] == [
        {"metric": "m", "value": 1.5}]
    md = out.read_text()
    row = next(ln for ln in md.splitlines() if ln.startswith("| teapot d4 "))
    cells = [c.strip() for c in row.split("|")]
    best = [data["runs"][i]["rows"][1]["ms_per_frame"] for i in range(2)]
    assert cells[3] == " / ".join(f"{b:.3f}" for b in best)
    assert re.fullmatch(r"\d+\.\d{3}×", cells[5])
    assert cells[-2] == "17.0"
    assert '{"metric": "m", "value": 1.5}' in md


@pytest.mark.parametrize("busy,error", [((1.5, 0.5), None),
                                        ((1.5, 1.2), "busy share 1.2")])
def test_profile_gaps_fail_the_row(monkeypatch, busy, error):
    """On the card a profile whose busy share is above 1 is taken again,
    and a second such one is the row's error."""
    seen = iter(busy)

    def fake(scene, settings, iters, mode):
        return {"wall_ms": 1.0, "device_ms": 1.0, "launches": 10.0,
                "busy_share": next(seen), "by_kind": {}}

    from pathtracer_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "device_profile", fake)
    scene = types.SimpleNamespace(device=torch.device("cuda"))
    prof, frames, err = bench_suite._profile(scene, None, "masked")
    assert frames == 2 * (1 + bench_suite.PROFILE_ITERS)
    assert (err is None) == (error is None)
    if error:
        assert error in err


IMPORT = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|pathtracer_tpu)"
                    r"(\.|\s|$)", re.M)


@pytest.mark.parametrize("module", ["bench", "bench_suite"])
def test_no_jax_import(module):
    """The new modules import neither jax nor the JAX package (import time
    is test_torch_scene.py's test_port_never_imports_jax)."""
    path = os.path.join(REPO, "pathtracer_tpu_torch", "tools",
                        module + ".py")
    with open(path) as f:
        src = f.read()
    assert "import torch" in src or "from .bench_suite" in src
    assert not IMPORT.search(src)
    assert not re.search(r"\bjax\b|pathtracer_tpu\.", src)
