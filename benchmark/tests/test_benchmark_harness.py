"""The harness on the CPU at tiny sizes: data-driven cells, metrics and
configurations, the result line, the refusal without a card, and the
trace reduction."""
from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from benchmark import run, spec
from benchmark import trace as tr
from benchmark.tests.tiny import tiny_copy

SEED = 3000000019   # above 2**31, as the driver's are


def run_cell(root, cell, trace=0, seconds=0.5, seed=SEED):
    """(exit code, the result line or None, stderr) of one CPU run."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)], root=root,
                      device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("cell", ["cornell.offline", "alien.offline",
                                  "cornell.interactive",
                                  "alien_1200_d12.sharded4"])
def test_result_line(tiny, cell):
    rc, line, err = run_cell(tiny, cell)
    assert rc == 0, err
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    want = {m["name"] for m in spec.load_cell(cell, tiny).end_to_end}
    assert set(line["metrics"]) == want
    assert all(m["value"] > 0 for m in line["metrics"].values())
    # the numbers compared are the last lines on standard error
    last = err.strip().splitlines()[-len(line["checks"]):]
    for (name, c), text in zip(line["checks"].items(), last):
        assert text.startswith(f"check {name} = ") and "limit" in text


def test_new_cell_config_and_metric_are_new_files(tiny, tmp_path):
    """A cell, a configuration and a per-layer metric added as files only,
    the harness's code untouched."""
    root = str(tmp_path / "copy")
    shutil.copytree(tiny, root, symlinks=True)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="cornell_12",
                                 file="benchmark/configs/cornell_12.json"))
    bench["workloads"].append({"name": "cornell_12.offline_c1",
                               "config": "cornell_12", "traffic": "offline_c1",
                               "chips": 1, "why": "a later cell"})
    bench["end_to_end"][0]["workloads"].append("cornell_12.offline_c1")
    bench["per_layer"].append({
        "name": "traced_iterations", "unit": "iterations", "better": "higher",
        "source": "device_trace", "layer": "engine: the compiled frame",
        "moves": "frame_ms", "workloads": ["cornell_12.offline_c1"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cfg = os.path.join(root, "benchmark", "configs")
    with open(os.path.join(cfg, "cornell.json")) as f:
        c = json.load(f)
    c["overrides"] = {"RES": [12, 12], "DEPTH": 2}
    with open(os.path.join(cfg, "cornell_12.json"), "w") as f:
        json.dump(c, f)
    wl = os.path.join(root, "benchmark", "workloads")
    with open(os.path.join(wl, "cornell.offline.json")) as f:
        w = json.load(f)
    w["chunk"] = 1
    with open(os.path.join(wl, "cornell_12.offline_c1.json"), "w") as f:
        json.dump(w, f)
    with open(os.path.join(root, "benchmark", "metrics",
                           "traced_iterations.py"), "w") as f:
        f.write("def read(out, cell):\n"
                "    return out.trace and out.trace['iterations']\n")
    rc, line, err = run_cell(root, "cornell_12.offline_c1", trace=1)
    assert rc == 0, err
    assert line["correct"] is True
    assert line["metrics"]["traced_iterations"]["value"] == 1
    rc, line, err = run_cell(root, "cornell_12.offline_c1", trace=0)
    assert rc == 0 and line["attempted"] % 1 == 0
    assert set(line["metrics"]) == {"frame_ms", "setup_s"}


def test_unknown_cell_exits_nonzero(tiny):
    rc, line, err = run_cell(tiny, "no.such_cell")
    assert rc != 0 and line is None and "no.such_cell" in err


def test_no_card_no_result(tiny):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = io.StringIO()
    with redirect_stdout(out), redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", "cornell.offline", "--seed", "1",
                       "--seconds", "1", "--trace", "0"], root=tiny)
    assert rc != 0 and out.getvalue() == ""


def test_forbidden_module_no_result(tiny, monkeypatch):
    """A loaded `jax` (top-level name, whole) fails the run; a module whose
    name only begins with the JAX package's does not."""
    monkeypatch.setitem(sys.modules, "pathtracer_tpu_torch_x", object())
    rc, line, err = run_cell(tiny, "cornell.offline")
    assert rc == 0 and line is not None
    monkeypatch.setitem(sys.modules, "jax", object())
    rc, line, err = run_cell(tiny, "cornell.offline")
    assert rc != 0 and line is None and "jax" in err


def test_only_the_benchmark_files_exit_nonzero(tmp_path):
    """A directory with BENCHMARK.json and the files under paths alone
    cannot run a cell."""
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "cornell.offline", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_trace_summary():
    """Busy is the union of device intervals inside the window; copies are
    busy but no kernels; range spans are left out; gaps carry the host
    range that covers them."""
    host = [(tr.WINDOW, 0.0, 100.0), ("bench.display", 60.0, 90.0)]
    dev = [("void cull_kernel<1>(float const*)", 10.0, 20.0),
           ("elementwise_kernel", 15.0, 30.0),
           ("Memcpy DtoH (Device -> Pageable)", 40.0, 50.0),
           ("elementwise_kernel", 95.0, 120.0)]
    s = tr.summarize(host, dev, 2)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(35e-6)
    assert s["n_kernels"] == 3
    assert set(s["kernel_s"]) == {"void cull_kernel<1>(float const*)",
                                  "elementwise_kernel"}
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0] == ["bench.display", pytest.approx(45e-6)]
    assert tr.is_mesh_kernel("void cull_kernel<1>(float const*)")
    assert not tr.is_mesh_kernel("scan_kernel_x") and tr.is_own_kernel(
        "void scan_kernel(int)")
    assert tr.summarize([], dev, 1) is None


def test_roofline_bytes():
    from benchmark import roofline
    # two iterations; the count after the last bounce is not a bounce
    live = [[100, 50, 0, 7], [100, 30, 10, 5]]
    per = [100 * 48 + 10 * 76 + 50 * 48 + 10 * 76,
           100 * 48 + 10 * 76 + 30 * 48 + 10 * 76 + 10 * 48 + 10 * 76]
    assert roofline.closest_hit_bytes(live, 10) == sum(per) / 2


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cornell.offline", "cornell.interactive"])
def test_cell_on_card(cell):
    """A short run of the cell as committed, on the card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        cell, "--seed", str(SEED), "--seconds", "2",
                        "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True


def test_failed_rank_ends_the_run_at_once(tiny, tmp_path, monkeypatch):
    """A rank that fails stops the others at once, not at the time limit;
    the run fails and prints no result."""
    import time
    from benchmark.traffic import sharded
    (tmp_path / "rank_fails.py").write_text(
        "import sys\nsys.exit(3 if '0' == sys.argv[sys.argv.index("
        "'--rank') + 1] else __import__('time').sleep(600))\n")
    monkeypatch.setattr(sharded, "RANK_MODULE", "rank_fails")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    t0 = time.time()
    with pytest.raises(RuntimeError, match="rank 0 exited 3"):
        run_cell(tiny, "alien_1200_d12.sharded4")
    assert time.time() - t0 < 60
