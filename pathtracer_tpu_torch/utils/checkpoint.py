"""Render checkpoint and resume: a copy of pathtracer_tpu/utils/checkpoint.py.

A checkpoint holds the running-sum image (lane order), the iterations done,
the seed and a fingerprint of the settings that shape the estimate, so a
render continues exactly where it stopped: the RNG is a pure function of
(seed, iteration, pixel), and a resumed render equals an uninterrupted one.

The file is the JAX package's: one .npz with the same keys and the same
fingerprint JSON (RenderSettings.fast_rng included), so a checkpoint
written by either package loads in the other.
"""
from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np
import torch

from ..scene.types import RenderSettings
from ..utils.vec import Vec3

FORMAT_VERSION = 1
FINGERPRINT_KEYS = ("width", "height", "trace_depth", "jitter", "dof",
                    "depth_quirk", "geom_types", "any_glossy",
                    "any_refractive", "rr_start", "bvh_impl", "fast_rng")


def _fingerprint(settings: RenderSettings) -> str:
    """Settings that affect the accumulated estimate (not speed knobs)."""
    d = {k: getattr(settings, k) for k in FINGERPRINT_KEYS}
    return json.dumps(d, sort_keys=True, default=list)


def save_checkpoint(path: str, accum: Vec3, iterations_done: int,
                    settings: RenderSettings, seed: int = 0) -> str:
    """Write (accum sum, iterations done, seed) to an .npz file."""
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        accum_x=accum.x.detach().cpu().numpy(),
        accum_y=accum.y.detach().cpu().numpy(),
        accum_z=accum.z.detach().cpu().numpy(),
        iterations_done=iterations_done,
        seed=seed,
        fingerprint=_fingerprint(settings),
    )
    return path


def load_checkpoint(path: str, settings: Optional[RenderSettings] = None,
                    device="cuda") -> Tuple[Vec3, int, int]:
    """Read a checkpoint onto `device`; raises if `settings` is given and
    its fingerprint differs from the file's. Returns (accum Vec3,
    iterations_done, seed)."""
    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {z['version']}")
        if settings is not None:
            fp = str(z["fingerprint"])
            if fp != _fingerprint(settings):
                raise ValueError(
                    "checkpoint settings mismatch:\n"
                    f"  checkpoint: {fp}\n  current:    "
                    f"{_fingerprint(settings)}")
        dev = torch.device(device)
        accum = Vec3(*(torch.from_numpy(np.ascontiguousarray(
            z[f"accum_{c}"], dtype=np.float32)).to(dev) for c in "xyz"))
        return accum, int(z["iterations_done"]), int(z["seed"])
