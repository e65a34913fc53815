"""The device an entry point runs on."""
from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """The torch device `name`; raises if it is a CUDA device and torch sees
    none, so an entry point never falls back to the CPU unasked."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r}: torch sees no CUDA device; pass --device cpu "
            "to run on the CPU")
    return device
