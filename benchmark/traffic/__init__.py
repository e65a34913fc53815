"""Traffic modes: each module drives one kind of use of the renderer.

A mode has `run(run) -> Outcome` (set-up, the window, and what the
window produced) and `check(run, outcome) -> {name: (value, limit)}` (the
comparison with the plain reference, once the program's state is freed).
The cell's workload file names the mode and holds its parameters.
"""
from __future__ import annotations

import numpy as np
import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kind(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def peak_bytes(device: torch.device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def free(device: torch.device) -> None:
    """Drop the program's captured frames and cached memory."""
    from pathtracer_tpu_torch.engine.wavefront import clear_frames
    clear_frames()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def sample(seed: int, stream: int, population: int, k: int) -> np.ndarray:
    """k distinct integers below `population`, ascending, drawn from the
    seed (stream numbers keep the draws of one run apart)."""
    gen = np.random.default_rng([int(seed), stream])
    return np.sort(gen.choice(population, size=min(k, population),
                              replace=False))


def rel_l1(prog: np.ndarray, ref: np.ndarray) -> float:
    """sum |prog - ref| / sum |ref| (NaN where prog holds a NaN)."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    den = np.abs(ref).sum()
    return float(np.abs(prog - ref).sum() / den) if den > 0 else float(
        np.abs(prog - ref).sum())


def reference_average(tb, cams: dict, cam_idx, pixels, n_iter: int,
                      seed: int, first: int = 1) -> torch.Tensor:
    """[S, 3] average over iterations first..first+n_iter-1 of the pixels
    `pixels` seen from camera row `cam_idx`, summed in iteration order in
    the tables' dtype, as the renderer accumulates."""
    from ..reference import tracer
    its = np.arange(first, first + n_iter)
    pix = np.tile(np.asarray(pixels), n_iter)
    rad = tracer.radiance(tb, cams, np.full(pix.shape, cam_idx), pix,
                          np.repeat(its, len(pixels)), seed)
    rad = rad.reshape(n_iter, len(pixels), 3)
    acc = torch.zeros_like(rad[0])
    for i in range(n_iter):
        acc = acc + rad[i]
    return acc * (1.0 / float(n_iter))
