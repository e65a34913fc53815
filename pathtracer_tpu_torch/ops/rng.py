"""Stateless counter-based RNG: the port of pathtracer_tpu/ops/rng.py.

Two paths, chosen by RenderSettings.fast_rng, as in the JAX package:
  fast (default)  the PCG hash keyed on (seed, sample, depth, pixel), so a
                  path draws the same numbers in every engine mode and
                  sharding;
  threefry        the threefry2x32 streams of jax.random (jax 0.9.0 with
                  jax_threefry_partitionable on), ported by hand: one key a
                  (seed, iteration[, key_salt]), folded per depth (and per
                  tile in the tiled mode), drawn as an [n, m] block by lane
                  row. Uniforms are jax.random.uniform's bit for bit;
                  normals go through XLA's float32 erf_inv polynomial and a
                  log1p, whose last bits may differ between libms
                  (tests/test_torch_threefry.py states the bound).

Torch's uint32 supports few ops, so every word is an int64 tensor (or a
Python int) holding a value in [0, 2**32), masked back after each multiply,
add and shift. The largest product, a 32-bit word times a 32-bit constant,
stays below 2**63 except for the pixel key, whose factor 0xC2B2AE35 times
any pixel id below 2**31 does too. The bits are therefore identical to the
JAX package's uint32 arithmetic, and so are the uniforms built from them.
Threefry as eager int64 ops is some 170 small kernels a draw on a device
(the JAX package has no kernel for it either).

`Stream` is the JAX package's per-iteration stream API (fast_state /
fast_fold / fast_uniforms / fast_normals on the hash, iteration_key /
bounce_key on threefry), which no render path reaches; it draws [n, m]
blocks by lane row on the device it was made for.
"""
from __future__ import annotations

import math

import torch

from ..scene.types import PixelMap

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
KEYED_DEPTHS = 64   # depth keys a tensor iteration makes at once (-2 on)


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


def fast_state(seed: int, iteration, device) -> torch.Tensor:
    """The uint32 stream state of one iteration: a 0-d int64 tensor on
    `device` (pathtracer_tpu/ops/rng.py:47)."""
    s = (_u32(seed) * GOLDEN + _u32(iteration)) & M32
    return _pcg(torch.as_tensor(s, dtype=torch.int64, device=device))


def fast_fold(state: torch.Tensor, salt) -> torch.Tensor:
    """A sub-stream of `state` (per bounce or shard); a negative salt wraps
    to uint32, as the JAX package's astype does."""
    return _pcg(state ^ _mul32(_u32(salt), GOLDEN))


def fast_uniforms(state: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """[n, m] float32 uniforms in [0, 1) from the hash stream `state`, on
    its device."""
    dev = state.device
    lane = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    draw = torch.arange(m, dtype=torch.int64, device=dev)[None, :]
    return _to_unit(_pcg(lane ^ _pcg((_mul32(draw, GOLDEN) + state) & M32)))


def _box_muller(u: torch.Tensor, m: int) -> torch.Tensor:
    """[n, 2k] uniforms -> [n, m] standard normals."""
    u1 = torch.clamp(u[:, 0::2], min=1e-12)
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = (2.0 * math.pi) * u[:, 1::2]
    return torch.cat([r * torch.cos(theta), r * torch.sin(theta)],
                     dim=1)[:, :m]


def fast_normals(state: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """[n, m] standard normals by Box-Muller on hash uniforms."""
    return _box_muller(fast_uniforms(state, n, 2 * ((m + 1) // 2)), m)


def decision_state(seed: int, sample, depth,
                   pixel: torch.Tensor) -> torch.Tensor:
    """[n] uint32 stream states (as int64) keyed on (seed, sample, depth,
    pixel), bit-identical to pathtracer_tpu/ops/rng.py:80. `seed` is a host
    int; `sample` and `depth` are host ints (the wavefront engine: the
    whole pool at one iteration and bounce) or [n] integer tensors (the
    persistent engine's per-lane schedule), negatives wrapped to uint32
    either way. Raygen uses depth -1 (AA) and -2 (DoF). A 0-d tensor
    `sample` (the compiled frame's iteration, engine/wavefront.py) gives the
    host int's bits."""
    return _pixel_mix(_depth_mix(_sample_key(seed, sample), depth), pixel)


def _sample_key(seed: int, sample):
    """decision_state's key of (seed, sample)."""
    return _pcg((((_u32(seed) * GOLDEN) & M32) + _u32(sample)) & M32)


def _depth_mix(h, depth):
    """The key `h` mixed with a depth (an int or a tensor of depths)."""
    return _pcg(h ^ _mul32(_u32(depth), 0x85EBCA6B))


def _pixel_mix(h, pixel: torch.Tensor) -> torch.Tensor:
    """The per-pixel states of the depth key `h`."""
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


# ---------------------------------------------------------------------------
# threefry2x32, as jax.random draws it
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher with 20 rounds
    (jax/_src/prng.py _threefry2x32_lowering): key words k1, k2 and counter
    words x1, x2, each a uint32 value held in a Python int or an int64
    tensor. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & M32, (x2 + ks[1]) & M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & M32
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & M32
    return x[0], x[1]


def key(seed: int) -> tuple:
    """jax.random.key(seed)'s data: the seed's high and low 32 bits."""
    return (int(seed) >> 32) & M32, int(seed) & M32


def fold_in(k: tuple, data) -> tuple:
    """jax.random.fold_in(k, data) for a uint32 `data` (a negative int
    wraps, as the JAX package's _u32_salt makes raygen's depths -1 and -2):
    the cipher of the counter (0, data)."""
    return threefry2x32(k[0], k[1], 0, _u32(data))


def iteration_key(seed, iteration) -> tuple:
    """The key of one progressive-render iteration: `seed` is a host int or
    a key tuple (pathtracer_tpu/ops/rng.py:131)."""
    base = key(seed) if isinstance(seed, int) else seed
    return fold_in(base, iteration)


def bounce_key(iter_key: tuple, depth) -> tuple:
    """The key of one bounce within an iteration."""
    return fold_in(iter_key, depth)


def random_bits(k: tuple, n: int, m: int, device) -> torch.Tensor:
    """[n, m] uint32 words (int64) of jax.random.bits(k, (n, m)): the cipher
    of each element's 64-bit row-major index, high word ^ low word."""
    idx = torch.arange(n * m, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k[0], k[1], idx >> 32, idx & M32)
    return (b1 ^ b2).reshape(n, m)


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in [0, 1): 23 random mantissa bits under the
    exponent of 1.0, minus 1 (jax/_src/random.py _uniform)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def uniforms(k: tuple, n: int, m: int, device) -> torch.Tensor:
    """jax.random.uniform(k, (n, m), float32), bit for bit."""
    return _unit(random_bits(k, n, m, device))


# XLA's float32 erf_inv (Giles' approximation; the CHLO decomposition that
# jax.lax.erf_inv lowers to): a degree-8 polynomial in w = -log1p(-x^2)
# below 5, in sqrt(w) above
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """Inverse error function of float32 x in (-1, 1), XLA's polynomial
    evaluated with float32 rounding at every step; +-inf at +-1."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    f32 = lambda c: torch.tensor(c, dtype=torch.float32, device=x.device)
    p = torch.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, f32(a), f32(b)) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


# the normals' uniform range: (nextafter(-1, 0), 1), scaled in float32 by
# hi - lo, which rounds to 2
_NORMAL_LO = -0.99999994
_SQRT2 = 1.4142135


def normals(k: tuple, n: int, m: int, device) -> torch.Tensor:
    """jax.random.normal(k, (n, m), float32): sqrt(2) * erf_inv(u), u
    uniform in (nextafter(-1, 0), 1) (jax/_src/random.py _normal_real)."""
    u = torch.clamp(_unit(random_bits(k, n, m, device)) * 2.0 + _NORMAL_LO,
                    min=_NORMAL_LO)
    return _SQRT2 * erf_inv(u)


class IterationRng:
    """Per-iteration RNG facade of the engines (pathtracer_tpu/ops/rng.py
    IterationRng). fast (default): draws come from decision_state(seed,
    iteration, depth, PIXEL) with PIXEL = pixel_map(lane + pixel_offset),
    so they are independent of lane order and of how the pool is sharded;
    `key_salt` and `salt` are ignored. threefry (fast=False): one key
    fold_in(key(seed), iteration), then fold_in(., key_salt) where given
    (the shard index); a draw at `depth` folds in the depth and then the
    draw's `salt` where given (the tiled mode's tile index), and the lanes
    take the rows of one [n, m] block in lane order.

    On the fast path `iteration` may be a 0-d integer tensor on the draws'
    device: the draws then read it on the device, so a captured CUDA graph
    that advances it draws each replay's own numbers (the compiled frame,
    engine/wavefront.py), bit for bit the int's. The keys of depths -2 ..
    KEYED_DEPTHS - 3 are then made at once, in a few 0-d and [KEYED_DEPTHS]
    ops, and each draw takes its depth's. Threefry folds the iteration into
    its key on the host and takes an int only."""

    __slots__ = ("fast", "seed", "iteration", "pixel_map", "offset", "key",
                 "keyed")

    def __init__(self, seed: int, iteration, pixel_map=None,
                 pixel_offset: int = 0, fast: bool = True, key_salt=None):
        self.fast = bool(fast)
        self.seed = int(seed)
        if isinstance(iteration, torch.Tensor):
            if not self.fast or iteration.dim() != 0:
                raise ValueError("a tensor iteration must be 0-d, on the "
                                 "fast path: threefry folds an int")
            self.iteration = iteration
            self.keyed = _depth_mix(
                _sample_key(self.seed, iteration),
                torch.arange(-2, KEYED_DEPTHS - 2, device=iteration.device))
        else:
            self.iteration = int(iteration)
            self.keyed = None
        self.pixel_map = pixel_map if pixel_map is not None else PixelMap()
        self.offset = int(pixel_offset)
        self.key = None
        if not self.fast:
            self.key = fold_in(key(self.seed), self.iteration)
            if key_salt is not None:
                self.key = fold_in(self.key, int(key_salt))

    def depth_key(self, depth: int):
        """The fast path's key of `depth`, which each lane's state mixes
        with its pixel id (`_pixel_mix`): a host int for an int iteration,
        else a 0-d int64 tensor on the iteration's device (a view of the
        keys made at once where the depth has one)."""
        if self.keyed is not None and -2 <= depth < KEYED_DEPTHS - 2:
            return self.keyed[depth + 2]
        return _depth_mix(_sample_key(self.seed, self.iteration), depth)

    def pixels(self, lane: torch.Tensor) -> torch.Tensor:
        """The fast path's pixel ids of the lanes `lane`:
        pixel_map(lane + pixel_offset) (the lanes themselves where both are
        the identity)."""
        if self.offset:
            lane = lane + self.offset
        return self.pixel_map(lane)

    def _state(self, depth: int, lane: torch.Tensor) -> torch.Tensor:
        return _pixel_mix(self.depth_key(depth), self.pixels(lane))

    def _key(self, depth: int, salt) -> tuple:
        k = fold_in(self.key, depth)
        return k if salt is None else fold_in(k, int(salt))

    def uniforms(self, depth: int, lane: torch.Tensor, m: int, salt=None):
        """m separate [n] uniform tensors for the lanes `lane` (their
        pixels on the fast path, their rows on the threefry path)."""
        if self.fast:
            return fast_uniforms_perlane(self._state(depth, lane), m)
        return uniforms(self._key(depth, salt), lane.shape[0], m,
                        lane.device).unbind(1)

    def normals(self, depth: int, lane: torch.Tensor, m: int):
        if self.fast:
            return fast_normals_perlane(self._state(depth, lane), m)
        return normals(self._key(depth, None), lane.shape[0], m,
                       lane.device).unbind(1)


class Stream:
    """One iteration's RNG stream (pathtracer_tpu/ops/rng.py:217): the hash
    state (fast) or a threefry key (fast=False), and the device its draws
    land on."""

    __slots__ = ("fast", "state", "device")

    def __init__(self, fast: bool, state, device):
        self.fast = bool(fast)
        self.state = state
        self.device = torch.device(device)

    @classmethod
    def for_iteration(cls, fast: bool, seed: int, iteration, salt=None,
                      device="cuda") -> "Stream":
        if fast:
            st = fast_state(seed, iteration, device)
            if salt is not None:
                st = fast_fold(st, salt)
        else:
            st = iteration_key(seed, iteration)
            if salt is not None:
                st = fold_in(st, salt)
        return cls(fast, st, device)

    def fold(self, salt) -> "Stream":
        if self.fast:
            return Stream(True, fast_fold(self.state, salt), self.device)
        return Stream(False, fold_in(self.state, salt), self.device)

    def uniforms(self, n: int, m: int) -> torch.Tensor:
        if self.fast:
            return fast_uniforms(self.state, n, m)
        return uniforms(self.state, n, m, self.device)

    def normals(self, n: int, m: int) -> torch.Tensor:
        if self.fast:
            return fast_normals(self.state, n, m)
        return normals(self.state, n, m, self.device)
