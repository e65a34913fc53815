"""PyTorch port, profiling: the frame breakdown runs on the CPU at a tiny
size, counts the stages the main path goes through, and groups device kernel
names by kind. On the CPU there is no device to trace, so the device fields
are None."""
import json

import pytest
import torch

from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.utils import profiling

torch.set_num_threads(2)


@pytest.mark.parametrize("name,kind", [
    ("_ZN12_GLOBAL__N_111cull_kernelILb1EEEvPKfS2_iS2_", "cull kernel"),
    ("_ZN39_GLOBAL__N__75d827b5_7_wide_cu_e1e0c9de16wide_push_kernelEPKfPKi",
     "wide push kernel"),
    ("_ZN39_GLOBAL__N__75d827b5_7_wide_cu_e1e0c9de16wide_mask_kernelEPKfPKi",
     "wide mask kernel"),
    ("void (anonymous namespace)::wide_push_kernel<false>("
     "(anonymous namespace)::Args)", "wide push kernel"),
    ("void (anonymous namespace)::wide_compact_kernel("
     "(anonymous namespace)::Args, int)", "wide compaction kernel"),
    ("_ZN40_GLOBAL__N__a5541915_8_brute_cu_pt_brute12brute_kernelEPKfS1_i",
     "brute kernel"),
    ("_ZN12_GLOBAL__N_113stream_kernelEPKiiPKfiiS3_", "stream kernel"),
    ("_ZN12_GLOBAL__N_113packet_kernelEPKfPKiiS1_i", "packet kernel"),
    ("_ZN12_GLOBAL__N_118packet_kernel_walkILb1EEvPKfPKiiS3_i",
     "packet kernel"),
    ("_ZN12_GLOBAL__N_121packet_kernel_compactEPKiPKfS3_S3_S3_Pf",
     "packet kernel"),
    ("_ZN12_GLOBAL__N_111scan_kernelIjLi256ELi16ELb1EEvPKT_PS1_xiPyPjj",
     "scan kernel"),
    ("void at_cuda_detail::cub::DeviceScanKernel<>", "elementwise/other"),
    ("Memcpy DtoH (Device -> Pageable)", "memcpy/memset"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<>", "sorts"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 4>",
     "gathers/indexing"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>>", "fills"),
    ("void at::native::reduce_kernel<512, 1>", "reductions"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::BinaryFunctor<float>>", "elementwise/other"),
])
def test_kernel_kind(name, kind):
    assert profiling.kernel_kind(name) == kind


def test_teapot_report_on_cpu():
    rep = profiling.report(scene_path("teapot"), "cpu", iters=1,
                           overrides={"RES": [16, 16], "DEPTH": 2})
    assert rep["frame_ms"] > 0
    prof = rep["device_profile"]
    assert prof["wall_ms"] > 0 and prof["device_ms"] is None
    stages = rep["stage_times"]["stages"]
    assert stages["raygen"]["calls"] == 1
    assert 1 <= stages["intersect"]["calls"] <= 2
    # teapot: 6 boxes, no sphere, the binned mesh pipeline with 2 passes
    # and a final cull per bounce
    assert stages["intersect.box"]["calls"] == 6 * stages["intersect"]["calls"]
    assert "intersect.sphere" not in stages
    assert stages["mesh_binned.cull"]["calls"] == (
        3 * stages["intersect.mesh_binned"]["calls"])
    for name in ("mesh_binned.sorts", "mesh_binned.stream", "mesh.packet",
                 "shade"):
        assert stages[name]["calls"] >= 1 and stages[name]["ms"] >= 0


def test_command_line_writes_json(tmp_path, capsys):
    out = tmp_path / "prof.json"
    profiling.main([scene_path("cornell"), "--res", "16", "--depth", "2",
                    "--iters", "1", "--json", str(out), "--device", "cpu"])
    (rep,) = json.loads(out.read_text())
    assert rep["res"] == [16, 16] and rep["depth"] == 2
    assert "intersect.sphere" in rep["stage_times"]["stages"]
    assert "untraced" in capsys.readouterr().out


def test_command_line_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.main([scene_path("cornell"), "--res", "16", "--iters",
                        "1"])


@pytest.mark.parametrize("bvh,stage", [("wide", "mesh.wide"),
                                       ("brute", "mesh.brute")])
def test_other_mesh_paths_report_their_stage(bvh, stage):
    """--bvh goes through its intersector's stage and no binned one."""
    rep = profiling.report(scene_path("teapot"), "cpu", iters=1,
                           overrides={"RES": [16, 16], "DEPTH": 2}, bvh=bvh)
    assert rep["bvh"] == bvh
    stages = rep["stage_times"]["stages"]
    assert stages[stage]["calls"] == stages["intersect"]["calls"]
    assert "intersect.mesh_binned" not in stages


def test_binned_with_the_wide_fallback_reports_its_stage():
    """--fallback wide finishes the binned passes with the 8-wide walk."""
    rep = profiling.report(scene_path("teapot"), "cpu", iters=1,
                           overrides={"RES": [16, 16], "DEPTH": 2},
                           fallback="wide")
    assert rep["bvh"] == "binned" and rep["fallback"] == "wide"
    stages = rep["stage_times"]["stages"]
    assert stages["mesh.wide"]["calls"] >= 1
    assert "mesh.packet" not in stages
    assert profiling.binned.FALLBACK_IMPL == "packet"


@pytest.mark.parametrize("mode", ["sorted", "tiled", "persistent"])
def test_engine_modes_report_their_stages(mode):
    """--mode profiles the sorted and tiled bounces and the persistent
    engine; the stages are counted in each."""
    rep = profiling.report(scene_path("cornell"), "cpu", iters=1,
                           overrides={"RES": [16, 16], "DEPTH": 2},
                           mode=mode, tile=64)
    assert rep["mode"] == mode and rep["frame_ms"] > 0
    stages = rep["stage_times"]["stages"]
    assert stages["raygen"]["calls"] >= 1
    assert stages["shade"]["calls"] == stages["intersect"]["calls"] >= 1
    if mode == "sorted":
        # a sort a bounce and the final unsort
        assert stages["mode.sorts"]["calls"] == stages["shade"]["calls"] + 1
    else:
        assert "mode.sorts" not in stages
    if mode == "tiled":                   # 4 tiles of 64 a bounce
        assert stages["shade"]["calls"] % 4 == 0


def test_binned_stages_show_as_named_ranges():
    """The binned pipeline's sort, cull, stream and fallback stages run
    under the JAX package's scope names (ops/binned.py:703,833,861,1168),
    so a torch.profiler trace of one call holds all four."""
    from pathtracer_tpu_torch import load_scene
    from pathtracer_tpu_torch.ops.binned import mesh_intersect_binned
    from pathtracer_tpu_torch.utils.vec import Vec3
    scene, _ = load_scene(scene_path("teapot"), "cpu")
    r = torch.Generator().manual_seed(0)
    o = Vec3(*(torch.rand(512, generator=r) * 10 - 5 for _ in range(3)))
    d = Vec3(*(torch.randn(512, generator=r) for _ in range(3)))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mesh_intersect_binned(scene, scene.mesh_roots, o, d)
    names = {e.name for e in prof.events()}
    for scope in ("pt_mi_sort", "pt_mi_cull", "pt_mi_stream", "pt_mi_fb"):
        assert scope in names, scope


@pytest.mark.parametrize("fast_rng", [True, False])
def test_ray_survival_report_equals_jax(fast_rng):
    import dataclasses

    from pathtracer_tpu import load_scene as jax_load_scene
    from pathtracer_tpu.utils.profiling import (
        ray_survival_report as jax_report)
    from pathtracer_tpu_torch import load_scene
    overrides = {"RES": [32, 32]}
    scene, settings = load_scene(scene_path("cornell"), "cpu",
                                 overrides=overrides)
    j_scene, j_settings = jax_load_scene(scene_path("cornell"),
                                         overrides=overrides)
    settings = dataclasses.replace(settings, fast_rng=fast_rng)
    j_settings = dataclasses.replace(j_settings, fast_rng=fast_rng)
    text = profiling.ray_survival_report(scene, settings, seed=3)
    assert text == jax_report(j_scene, j_settings, seed=3)
    assert text.startswith("[Iter 10] Initial rays: 1024")
    assert text.count("\n") == settings.trace_depth
