"""PyTorch port, the perfstats tool and the measure_stages harness it
prints (utils/profiling.py StageStats / measure_stages, tools/perfstats.py),
on the CPU: tests/test_tools.py's checks on the port's Cornell 64x64 d4,
the table's rows against the JAX package's StageStats.table on the same
numbers, and the tool's command line.
"""
import math

import numpy as np
import pytest
import torch

from pathtracer_tpu.utils import profiling as jprofiling
from pathtracer_tpu_torch import load_scene
from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.tools import perfstats
from pathtracer_tpu_torch.utils import profiling
from pathtracer_tpu_torch.utils.profiling import (StageStats, measure_stages,
                                                  ray_survival_report)

torch.set_num_threads(2)

STAGES = ("Ray generation", "Intersection", "Shading", "Gather")


@pytest.fixture(scope="module")
def cornell_small():
    return load_scene(scene_path("cornell"), "cpu",
                      overrides={"RES": [64, 64], "DEPTH": 4,
                                 "ITERATIONS": 8})


def test_perfstats_smoke(cornell_small):
    scene, settings = cornell_small
    report = ray_survival_report(scene, settings, iteration=2)
    assert "Initial rays: 4096" in report
    stats = measure_stages(scene, settings, iters=3)
    table = stats.table()
    for row in STAGES + ("SUM (isolated)", "Eager frame"):
        assert row in table
    assert "FUSED" not in table and "XLA" not in table
    assert stats.trace_depth == 4
    for ms in (stats.raygen_ms, stats.intersect_ms, stats.shade_ms,
               stats.gather_ms, stats.frame_ms):
        assert ms > 0 and math.isfinite(ms)


def test_stage_rows_match_jax_table():
    """On the same numbers, the stage rows and the sum are the JAX
    package's lines; only the title and the frame line name the port's
    eager frame."""
    nums = dict(raygen_ms=1.25, intersect_ms=7.5, shade_ms=2.0,
                gather_ms=0.125, frame_ms=40.0, trace_depth=8)
    ours = StageStats(**nums).table().splitlines()
    theirs = jprofiling.StageStats(**nums).table().splitlines()
    assert len(ours) == len(theirs) == 8
    assert ours[1:7] == theirs[1:7]
    assert ours[7].startswith("Eager frame") and ours[7].endswith(
        "(isolated sum / frame: 1.96x)")   # 78.25 / 40


def test_stages_time_distinct_inputs(cornell_small, monkeypatch):
    """Each stage is called iters + 1 times, on distinct inputs (eps and
    iteration vary with the call), and the frame runs the eager loop
    (render_chunk_eager, not the compiled frame) for one iteration at a
    time."""
    scene, settings = cornell_small
    seen = []
    real = profiling.wavefront.render_chunk_eager

    def spy(scene_, settings_, accum, start, n_iters, *a, **k):
        seen.append((start, n_iters))
        return real(scene_, settings_, accum, start, n_iters, *a, **k)

    monkeypatch.setattr(profiling.wavefront, "render_chunk_eager", spy)
    measure_stages(scene, settings, iters=2)
    assert seen == [(1, 1), (2, 1), (3, 1)]


def test_perfstats_main(capsys):
    perfstats.main([scene_path("cornell"), "--res", "32", "--depth", "3",
                    "--iters", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "32x32 d3" in out and "Initial rays: 1024" in out
    assert "After bounce 3: 0 rays remaining" in out
    assert "Eager frame" in out


def test_perfstats_mesh_scene(capsys):
    perfstats.main([scene_path("teapot"), "--res", "16", "--depth", "2",
                    "--iters", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "bvh binned" in out and "Intersection" in out


def test_perfstats_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        perfstats.main(["--res", "8"])
