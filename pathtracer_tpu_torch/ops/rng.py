"""Stateless counter-based RNG: the port of the fast path of
pathtracer_tpu/ops/rng.py (the PCG hash keyed on seed, sample, depth and
pixel). The threefry path (`fast_rng=False`) is not part of this slice.

Torch's uint32 supports few ops, so every word is an int64 tensor holding a
value in [0, 2**32), masked back after each multiply and add. The largest
product, a 32-bit word times a 32-bit constant, stays below 2**63 except for
the pixel key, whose factor 0xC2B2AE35 times any pixel id below 2**31 does too.
The bits are therefore identical to the JAX package's uint32 arithmetic, and
so are the uniforms built from them.
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def _u32(x):
    """A host int or an integer tensor wrapped as uint32 (an int64 tensor
    for a tensor; depths -1/-2 -> 0xFFFFFFFF/...FE)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return int(x) & M32


def _pcg(x):
    """One round of PCG-RXS-M-XS on uint32 words held in int64 (or on a
    Python int, for the scalar keys)."""
    x = (x * 747796405 + 2891336453) & M32
    x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & M32
    return (x >> 22) ^ x


def _to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> f32 in [0, 1): top 24 bits scaled."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _mul32(x, c: int):
    """(x * c) mod 2**32 for uint32 words x (int64 tensor or Python int)
    and a 32-bit constant c, by 16-bit halves of c so that no product
    reaches 2**63."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def decision_state(seed: int, sample, depth,
                   pixel: torch.Tensor) -> torch.Tensor:
    """[n] uint32 stream states (as int64) keyed on (seed, sample, depth,
    pixel), bit-identical to pathtracer_tpu/ops/rng.py:80. `seed` is a host
    int; `sample` and `depth` are host ints (the wavefront engine: the
    whole pool at one iteration and bounce) or [n] integer tensors (the
    persistent engine's per-lane schedule), negatives wrapped to uint32
    either way. Raygen uses depth -1 (AA) and -2 (DoF)."""
    h = _pcg((_u32(seed) * GOLDEN + _u32(sample)) & M32)
    h = _pcg(h ^ _mul32(_u32(depth), 0x85EBCA6B))
    p = pixel.to(torch.int64) & M32
    return _pcg(h ^ ((p * 0xC2B2AE35) & M32))


def fast_uniforms_perlane(state: torch.Tensor, m: int):
    """m separate [n] uniform tensors from per-lane states [n]."""
    return tuple(_to_unit(_pcg((state + ((j * GOLDEN) & M32)) & M32))
                 for j in range(m))


def fast_normals_perlane(state: torch.Tensor, m: int):
    """m separate [n] standard-normal tensors (Box-Muller)."""
    u = fast_uniforms_perlane(state, 2 * ((m + 1) // 2))
    out = []
    for k in range(0, len(u), 2):
        u1 = torch.clamp(u[k], min=1e-12)
        r = torch.sqrt(-2.0 * torch.log(u1))
        theta = (2.0 * math.pi) * u[k + 1]
        out.extend([r * torch.cos(theta), r * torch.sin(theta)])
    return tuple(out[:m])


class IterationRng:
    """Per-iteration RNG facade: draws come from decision_state(seed,
    iteration, depth, PIXEL) with PIXEL = pixel_map(lane + pixel_offset),
    so they are independent of lane order and of how the pool is sharded
    (`pixel_offset` is the global lane of a shard's first lane,
    pathtracer_tpu/ops/rng.py:175-198). The JAX package's facade also takes
    a `key_salt` (the shard index), which only its threefry path reads; the
    fast path ignores it there too, and the port has no threefry path."""

    __slots__ = ("seed", "iteration", "pixel_map", "offset")

    def __init__(self, seed: int, iteration: int, pixel_map=None,
                 pixel_offset: int = 0):
        self.seed = int(seed)
        self.iteration = int(iteration)
        self.pixel_map = pixel_map if pixel_map is not None else (
            lambda lane: lane)
        self.offset = int(pixel_offset)

    def _state(self, depth: int, lane: torch.Tensor) -> torch.Tensor:
        if self.offset:
            lane = lane + self.offset
        return decision_state(self.seed, self.iteration, depth,
                              self.pixel_map(lane))

    def uniforms(self, depth: int, lane: torch.Tensor, m: int):
        """m separate [n] uniform tensors for the pixels of `lane`."""
        return fast_uniforms_perlane(self._state(depth, lane), m)

    def normals(self, depth: int, lane: torch.Tensor, m: int):
        return fast_normals_perlane(self._state(depth, lane), m)
