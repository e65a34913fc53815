"""PyTorch port, multi-process rendering (parallel/distributed.py): real
processes of `python -m pathtracer_tpu_torch.tools.multihost_worker`, wired
by torch.distributed with gloo on the CPU over a localhost address, one
shard a rank.

The RNG is keyed on global pixel ids, so the ranks' images must equal each
other and the single-process render bit for bit; the albedo step's
all-reduce gives every rank the same sum, so the new albedo is equal on
every rank, and within atol 1e-6 of the step over local shards in one
process (the sums run in another order). Each worker is given a time limit
and killed at it (`communicate(timeout=...)`).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import load_scene, render
from pathtracer_tpu_torch.parallel import distributed
from pathtracer_tpu_torch.parallel import sharding as sh
from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.tools import multicard
from pathtracer_tpu_torch.tools.fit_albedo import perturbed_albedo
from pathtracer_tpu_torch.utils.grad import with_materials

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(world: int, out: str, scene: str, *extra) -> list:
    """Run `world` workers on the CPU with gloo; returns each rank's JSON
    report. Fails if a worker fails or outlives TIMEOUT (then killed)."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pathtracer_tpu_torch.tools.multihost_worker",
         scene, out, "--device", "cpu", "--backend", "gloo",
         "--init-method", init, "--world-size", str(world), "--rank",
         str(rank), *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(world)]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            stdout, _ = p.communicate()
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    return [json.loads(log.strip().splitlines()[-1]) for log in logs]


@pytest.mark.parametrize("name,res,depth,spp,world", [
    ("cornell", 48, 4, 4, 2),
    ("teapot", 32, 2, 2, 4),
])
def test_ranks_render_the_single_process_image(tmp_path, name, res, depth,
                                               spp, world):
    out = str(tmp_path / "mh")
    reports = _run_ranks(world, out, scene_path(name), "--res", str(res),
                         "--depth", str(depth), "--spp", str(spp))
    assert [r["rank"] for r in reports] == list(range(world))
    assert all(r["world"] == world and r["backend"] == "gloo"
               for r in reports)
    imgs = [np.load(f"{out}.{rank}.npy") for rank in range(world)]
    for img in imgs[1:]:
        np.testing.assert_array_equal(img, imgs[0])
    scene, settings = load_scene(scene_path(name), "cpu", overrides={
        "RES": [res, res], "DEPTH": depth})
    if name == "teapot":
        assert reports[0]["bvh_impl"] == "binned"
    np.testing.assert_array_equal(imgs[0], render(scene, settings,
                                                  iterations=spp))


def test_ranks_take_the_same_albedo_step(tmp_path):
    out = str(tmp_path / "fit")
    reports = _run_ranks(2, out, scene_path("cornell"), "--res", "24",
                         "--depth", "3", "--spp", "1", "--fit")
    new = [np.load(f"{out}.albedo.{rank}.npy") for rank in range(2)]
    np.testing.assert_array_equal(new[0], new[1])
    assert reports[0]["fit_loss"] == reports[1]["fit_loss"]

    scene, settings = load_scene(scene_path("cornell"), "cpu", overrides={
        "RES": [24, 24], "DEPTH": 3})
    mesh = sh.make_ray_mesh(2, devices="cpu")
    target = sh.render_chunk_sharded(
        scene, settings, mesh, distributed.make_global_accum(settings, mesh),
        1, 1, early_exit=False)
    wrong = with_materials(scene, color=torch.as_tensor(
        perturbed_albedo(scene.materials.color.numpy(), 0.25),
        dtype=torch.float32))
    local, loss = sh.albedo_fit_step(wrong, settings, mesh, target, 1,
                                     lr=1.0)
    np.testing.assert_allclose(new[0], local.materials.color.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(reports[0]["fit_loss"], float(loss), rtol=0,
                               atol=1e-6)
    assert not np.allclose(new[0], wrong.materials.color.numpy())


def test_init_distributed_without_cuda_needs_gloo():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="gloo"):
        distributed.init_distributed(init_method="tcp://127.0.0.1:1",
                                     world_size=1, rank=0)
    with pytest.raises(RuntimeError, match="gloo"):
        distributed.init_distributed("nccl", "tcp://127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="init_distributed"):
        distributed.global_ray_mesh("cpu")


def test_multicard_needs_cards():
    """The several-card check fails without CUDA rather than run elsewhere."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        multicard.main([])
