"""The counter-based random numbers the renderer draws (a frozen copy of
the PCG-RXS-M-XS hash and of its keying): the state of a draw is keyed on
(seed, iteration, depth, pixel id), so a path draws the same numbers
wherever and in whatever order it is traced. Depth -1 keys the
anti-aliasing jitter and -2 the lens sample. Words are uint32 values held
in Python ints (the per-iteration and per-depth keys) or int64 tensors
(the per-pixel states)."""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
DEPTH_MUL = 0x85EBCA6B
PIXEL_MUL = 0xC2B2AE35


def pcg(x):
    """One round of PCG-RXS-M-XS on uint32 words (int or int64 tensor)."""
    x = (x * 747796405 + 2891336453) & M32
    x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & M32
    return (x >> 22) ^ x


def depth_key(seed: int, iteration: int, depth: int) -> int:
    """The key of one (seed, iteration, depth), a uint32 int."""
    h = pcg(((int(seed) & M32) * GOLDEN + (int(iteration) & M32)) & M32)
    return pcg(h ^ (((int(depth) & M32) * DEPTH_MUL) & M32))


def key_table(seed: int, iterations, depth: int, device) -> torch.Tensor:
    """[len(iterations), depth + 2] int64 keys: column c is depth c - 2."""
    rows = [[depth_key(seed, it, d) for d in range(-2, depth)]
            for it in iterations]
    return torch.tensor(rows, dtype=torch.int64, device=device)


def pixel_state(key: torch.Tensor, pixel: torch.Tensor) -> torch.Tensor:
    """Per-path states from per-path keys and pixel ids (ids below 2**31,
    so the product stays inside int64)."""
    return pcg(key ^ ((pixel.to(torch.int64) * PIXEL_MUL) & M32))


def uniforms(state: torch.Tensor, m: int, dtype) -> list:
    """m uniforms in [0, 1) a path: the top 24 bits of pcg(state + j *
    GOLDEN), scaled; converted to `dtype`."""
    out = []
    for j in range(m):
        bits = pcg((state + ((j * GOLDEN) & M32)) & M32)
        u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
        out.append(u.to(dtype))
    return out


def normals(state: torch.Tensor, dtype) -> tuple:
    """Two standard normals a path by Box-Muller on two uniforms."""
    u1, u2 = uniforms(state, 2, dtype)
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))
    theta = (2.0 * math.pi) * u2
    return r * torch.cos(theta), r * torch.sin(theta)
