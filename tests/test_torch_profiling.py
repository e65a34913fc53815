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
    ("_ZN40_GLOBAL__N__a5541915_8_brute_cu_pt_brute12brute_kernelEPKfS1_i",
     "brute kernel"),
    ("_ZN12_GLOBAL__N_113stream_kernelEPKiiPKfiiS3_", "stream kernel"),
    ("_ZN12_GLOBAL__N_113packet_kernelEPKfPKiiS1_i", "packet kernel"),
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
