"""The multi-process render on the cards of one host, one card a rank,
against the single-process render, and its scaling.

    python -m pathtracer_tpu_torch.tools.multicard [scene.json]

For each world size N of 1, 2, 4, ... up to the cards torch sees, it
starts N processes of tools/multihost_worker (rank r on cuda:r, NCCL, a
free localhost port, SPP iterations and one albedo step, `--fit`), each
with a time limit. The ranks' images must equal each other and the image
this process renders with `render` on cuda:0, bit for bit; the ranks' new
albedos must equal each other bit for bit and one rank's within rtol 1e-5.
Prints each rank's report, then one JSON line: per world size the slowest
rank's ms a frame, rays/s (the image's pixels over that time), the
efficiency against linear scaling from one rank, the collectives' ms and
the peak memory a rank, with the card's name and power limit. Exits
non-zero on a failure. The scene defaults to teapot, at its checked-in
size.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

SPP = 4
WORKER_TIMEOUT = 600
FIT_RTOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(n: int, scene: str, out: str) -> list:
    """One NCCL rank a card, cards 0..n-1; each rank's JSON report."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pathtracer_tpu_torch.tools.multihost_worker",
         scene, out, "--spp", str(SPP), "--fit", "--device", f"cuda:{r}",
         "--backend", "nccl", "--init-method", init, "--world-size", str(n),
         "--rank", str(r)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
    logs, timed_out = [], False
    for p in procs:
        try:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            timed_out = True
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0])
    for r, (p, text) in enumerate(zip(procs, logs)):
        if timed_out or p.returncode != 0:
            raise RuntimeError(f"{n} ranks: rank {r} "
                               + ("timed out" if timed_out
                                  else f"exit {p.returncode}")
                               + f":\n{text[-3000:]}")
    return [json.loads(text.strip().splitlines()[-1]) for text in logs]


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def main(argv=None) -> int:
    from .. import load_scene, render
    from ..scene.fixtures import scene_path
    from ..utils.kernel_bench import card_line

    argv = sys.argv[1:] if argv is None else argv
    scene = argv[0] if argv else scene_path("teapot")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("multicard: torch sees no CUDA device")
    worlds = [1 << k for k in range(cards.bit_length())]

    card = card_line()
    results, imgs, first_albedo = {}, [], None
    with tempfile.TemporaryDirectory() as tmp:
        for n in worlds:
            out = os.path.join(tmp, f"w{n}")
            reports = run_world(n, scene, out)
            for r in reports:
                print(json.dumps(r), flush=True)
            ranks_imgs = [np.load(f"{out}.{r}.npy") for r in range(n)]
            albedo = [np.load(f"{out}.albedo.{r}.npy") for r in range(n)]
            if not all(_same_bits(i, ranks_imgs[0]) for i in ranks_imgs):
                raise AssertionError(f"{n} ranks: the ranks' images differ")
            if not all(_same_bits(a, albedo[0]) for a in albedo):
                raise AssertionError(f"{n} ranks: the new albedos differ")
            if first_albedo is None:
                first_albedo = albedo[0]
            np.testing.assert_allclose(albedo[0], first_albedo,
                                       rtol=FIT_RTOL, atol=0)
            imgs.append(ranks_imgs[0])
            ms = max(r["ms_per_frame"] for r in reports)
            rays_s = ranks_imgs[0].shape[0] * ranks_imgs[0].shape[1] / (
                ms / 1000.0)
            results[n] = {
                "ms_per_frame": ms, "rays_per_s": rays_s,
                "efficiency": rays_s / (results[1]["rays_per_s"] * n
                                        if n > 1 else rays_s),
                "gather_ms": max(r["gather_ms"] for r in reports),
                "all_reduce_ms": max(r["all_reduce_ms"] for r in reports),
                "peak_bytes": max(r["peak_bytes"] for r in reports),
                "launches_rank0": reports[0]["launches"]}
    sc, settings = load_scene(scene, "cuda:0")
    ref = render(sc, settings, iterations=SPP, seed=0)
    for n, img in zip(worlds, imgs):
        if not _same_bits(img, ref):
            raise AssertionError(f"{n} ranks: the image differs from "
                                 "render")
    print(json.dumps({"multicard": results, "backend": "nccl",
                      "scene": scene, "spp": SPP, "card": card,
                      "cards": cards}), flush=True)
    print(f"multicard: every world size bit-equal to render; {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
