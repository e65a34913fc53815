"""The check that decides `correct`, on the CPU at tiny sizes: the plain
reference against the program, the bfloat16 control, each fault a cell
can have, and what the benchmark's processes import."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from benchmark import control, spec
from benchmark.reference import tracer
from benchmark.reference.scene import Scene
from benchmark.tests.test_benchmark_harness import SEED, run_cell
from benchmark.tests.tiny import tiny_copy

CELLS = ["cornell.offline", "alien.offline", "cornell.interactive",
         "alien_1200_d12.sharded4"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("scene,depth,n", [("cornell", 8, 3),
                                           ("animal", 4, 2)])
def test_reference_equals_program(scene, depth, n):
    """The program's averaged image and the reference's agree at every
    pixel (on this CPU to the last bit; held to 1e-6 of the image)."""
    from pathtracer_tpu_torch.engine.wavefront import render
    from pathtracer_tpu_torch.scene.loader import load_scene
    ov = {"RES": [12, 12], "DEPTH": depth}
    path = os.path.join(spec.ROOT, "scenes", f"{scene}.json")
    sc, st = load_scene(path, "cpu", overrides=ov)
    img = render(sc, st, iterations=n, seed=SEED).reshape(-1, 3)
    rs = Scene(path, ov)
    tb = tracer.Tables(rs, "cpu")
    from benchmark.traffic import reference_average, rel_l1
    ref = reference_average(tb, {k: v[None] for k, v in
                                 rs.startup_camera().items()}, 0,
                            np.arange(144), n, SEED)
    assert rel_l1(img, ref.numpy()) < 1e-6


def test_orbit_camera_equals_program():
    """The reference's orbit camera after moves is the program's."""
    from pathtracer_tpu_torch.scene.loader import derive_camera, orbit_camera
    from benchmark.reference.scene import startup_orbit
    from benchmark.traffic.interactive import move
    rs = Scene(os.path.join(spec.ROOT, "scenes", "cornell.json"))
    b = rs.camera_block
    cam = derive_camera(b["EYE"], b["LOOKAT"], b["UP"], float(b["FOVY"]),
                        800, 800, 8.0, 0.2)
    state = startup_orbit(b)
    for way in ("phi+", "theta-", "theta-", "phi-", "theta+"):
        state = move(state, way, 0.15)
        mine = rs.camera(*state)
        theirs = orbit_camera(cam, *state)
        for k in ("position", "view", "up", "right"):
            np.testing.assert_array_equal(
                mine[k], np.asarray(theirs[k], np.float32))


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny, cell):
    """The bfloat16 reference in the program's place fails the check on
    three seeds."""
    wl = spec.load_cell(cell, tiny).workload
    arg = (["--frames", "60"] if wl["mode"] == "interactive"
           else ["--iterations", "6"])
    lines = control.main(["--workload", cell, "--seeds", "11,12,13"] + arg,
                         root=tiny, device="cpu")
    assert all(line["fails"] for line in lines), lines


def _chunk_fault(kind):
    """A render_chunk broken in one of the ways a run can break."""
    from pathtracer_tpu_torch.engine.wavefront import render_chunk

    def broken(scene, settings, accum, start, n, seed, *a, **k):
        scratch = type(accum)(*(torch.zeros_like(c) for c in accum))
        render_chunk(scene, settings, scratch, start, n, seed, *a, **k)
        if kind == "unchanged":             # the work done, and dropped
            return accum
        half = accum[0].shape[0] // 2
        for c, s in zip(accum, scratch):
            if kind == "half":
                c[:half] += 2.0 * s[:half]
            else:                                   # "altered"
                c += 1.05 * s
        return accum
    return broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS[:3])
def test_fault_fails(tiny, cell, kind, monkeypatch):
    from pathtracer_tpu_torch.engine import wavefront
    monkeypatch.setattr(wavefront, "render_chunk", _chunk_fault(kind))
    rc, line, err = run_cell(tiny, cell)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


RANK_FAULTS = {
    "unchanged": """
        import torch
        def render(scene, settings, mesh, accum, start, n, seed, *a, **k):
            scratch = tuple(type(b)(*(torch.zeros_like(c) for c in b))
                            for b in accum)
            ORIG(scene, settings, mesh, scratch, start, n, seed, *a, **k)
            return accum
        sharding.render_chunk_sharded = render
    """,
    "half": """
        import torch
        def render(scene, settings, mesh, accum, start, n, seed, *a, **k):
            scratch = tuple(type(b)(*(torch.zeros_like(c) for c in b))
                            for b in accum)
            ORIG(scene, settings, mesh, scratch, start, n, seed, *a, **k)
            for b, s in zip(accum, scratch):
                half = b[0].shape[0] // 2
                for c, sc in zip(b, s):
                    c[:half] += 2.0 * sc[:half]
            return accum
        sharding.render_chunk_sharded = render
    """,
    "no_exchange": """
        import torch, torch.distributed as dist
        def local_only(t, mesh):
            r = dist.get_rank()
            return [t if i == r else torch.zeros_like(t)
                    for i in range(mesh.n_shards)]
        sharding._all_gather = local_only
    """,
    "altered": """
        def render(scene, settings, mesh, accum, start, n, seed, *a, **k):
            ORIG(scene, settings, mesh, accum, start, n, seed, *a, **k)
            for b in accum:
                for c in b:
                    c.mul_(1.05)
            return accum
        sharding.render_chunk_sharded = render
    """,
}


@pytest.mark.parametrize("kind", sorted(RANK_FAULTS))
def test_sharded_fault_fails(tiny, tmp_path, kind, monkeypatch):
    """Each rank runs a module that breaks the program, then the rank."""
    from benchmark.traffic import sharded
    src = ("import sys\n"
           "from pathtracer_tpu_torch.parallel import sharding\n"
           "from benchmark.traffic import sharded\n"
           "ORIG = sharding.render_chunk_sharded\n"
           + textwrap.dedent(RANK_FAULTS[kind])
           + "sys.exit(sharded.rank_main())\n")
    (tmp_path / f"fault_{kind}.py").write_text(src)
    monkeypatch.setattr(sharded, "RANK_MODULE", f"fault_{kind}")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    rc, line, err = run_cell(tiny, "alien_1200_d12.sharded4")
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


def test_imports(tiny):
    """Every traffic mode run (and the ranks it starts) leaves neither JAX
    nor the JAX package loaded, compared by whole top-level names; the
    reference loads nothing of the program."""
    code = textwrap.dedent(f"""
        import io, json, sys
        from contextlib import redirect_stdout, redirect_stderr
        from benchmark import run
        for cell in {CELLS!r}:
            with redirect_stdout(io.StringIO()), redirect_stderr(io.StringIO()):
                rc = run.main(["--workload", cell, "--seed", "5",
                               "--seconds", "0.2", "--trace", "1"],
                              root={tiny!r}, device="cpu")
            assert rc == 0, cell
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "pathtracer_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "pathtracer_tpu"}
    code = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        from benchmark.reference import rng, scene, tracer
        s = scene.Scene({os.path.join(spec.ROOT, 'scenes', 'animal.json')!r},
                        {{"RES": [4, 4], "DEPTH": 2}})
        tb = tracer.Tables(s, "cpu")
        tracer.radiance(tb, {{k: v[None] for k, v in
                             s.startup_camera().items()}},
                        np.zeros(16), np.arange(16), np.ones(16), 1)
        print(json.dumps(sorted(sys.modules)))
    """)
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    mods = json.loads(p.stdout.strip().splitlines()[-1])
    assert not [m for m in mods if m.split(".")[0].startswith(
        "pathtracer_tpu")]
