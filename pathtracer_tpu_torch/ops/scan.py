"""Parallel primitives: exclusive scan, stream compaction, sorts by key.

The port of pathtracer_tpu/ops/scan.py (the stand-in for the reference's
stream_compaction/ library), every public function with its signature and
semantics, less `use_pallas`: as in every wrapper of the port, a CUDA tensor
goes through the kernel (csrc/scan.cu) and a CPU tensor through its plain
PyTorch version.

  - `exclusive_scan`: csrc/scan.cu, one launch a call: a single pass over
    4,096- or 8,192-element tiles whose look-back sums the predecessor
    tiles' aggregates in a fixed order, so float32 results repeat (see the
    note there). Its scratch (flags and tile counter) is kept per (device,
    stream) and is not allocated per call. The plain version is
    cumsum(x) - x, the JAX package's own jnp path. int32 sums wrap modulo
    2^32 on both paths.
  - `compaction_indices` / `compact` / `partition_stable`: map to int ->
    exclusive scan -> scatter of a gather permutation; live elements first,
    dead ones kept at the back, both in order.
  - `sort_by_key`: the stable LSD radix sort, one bit a pass, its zeros
    ranked by `exclusive_scan` (one kernel launch a pass on the card).
  - `partition_multisort`, `sort_by_key_multisort`,
    `sort_by_key_segmented`: XLA sorts in the JAX package, here a stable
    `torch.sort` of the key and a gather of every leaf (a stable sort by key
    is the same permutation as JAX's (key, iota) two-key sort).

A "tree" is a tensor or a tuple, NamedTuple (Vec3, PathState), list or
dict of trees, with [N] tensors at the leaves; each function returns the
same structure.
"""
from __future__ import annotations

import torch

from . import kernels

SEG = 128  # column count of the segmented sort (the TPU's lane width)
SCAN_TILE = 4096  # csrc/scan.cu's smallest tile (its large inputs take 8,192)
EPOCH_MAX = 2 ** 32 - 1  # epochs run 1 .. EPOCH_MAX (0 marks "never written")


def tree_map(fn, tree, *rest):
    """fn applied to every tensor leaf of `tree` (and the matching leaves of
    the trees in `rest`, of the same structure); same structure back."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v, *(r[k] for r in rest)))
                          for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


# ---------------------------------------------------------------------------
# Exclusive scan
# ---------------------------------------------------------------------------

def exclusive_scan_plain(x: torch.Tensor) -> torch.Tensor:
    """cumsum(x) - x in x's dtype (torch.cumsum of int32 would give int64
    without dtype=; the int32 sums wrap, as JAX's do)."""
    return torch.cumsum(x, 0, dtype=x.dtype) - x


class _Scratch:
    """One (device, stream)'s scan scratch: int64 word 0 holds the tile
    counter, words 1.. one flag a tile; `epoch` is the last call's."""

    def __init__(self, tiles: int, device):
        # a normal tensor even when first made under inference mode, so a
        # later call outside it may still zero it in place
        with torch.inference_mode(False):
            self.words = torch.zeros(tiles + 1, dtype=torch.int64,
                                     device=device)
        self.epoch = 0

    def next_epoch(self) -> int:
        """A new epoch, never 0. When the count wraps, the flags are zeroed
        again (on the current stream, before the launch), so a flag left
        by an earlier call with the same epoch cannot match."""
        if self.epoch == EPOCH_MAX:
            self.words.zero_()
            self.epoch = 0
        self.epoch += 1
        return self.epoch


_SCRATCH: dict = {}  # (device index, stream handle) -> _Scratch


def scan_scratch(device: torch.device, stream: int, tiles: int) -> _Scratch:
    """The scratch of `stream` on `device`, made (zeroed) on first use and
    remade, twice as large, when `tiles` outgrow it. Two streams never
    share one: calls on one stream run in order, so the tile counter that a
    launch resets is zero when the next one starts."""
    key = (device.index, stream)
    s = _SCRATCH.get(key)
    if s is None or s.words.numel() - 1 < tiles:
        old = 0 if s is None else s.words.numel() - 1
        s = _SCRATCH[key] = _Scratch(max(tiles, 2 * old), device)
    return s


def scan_tiles(n: int) -> int:
    """Flags the scratch holds for n elements: one a SCAN_TILE, so as many
    as the tiles of any shape csrc/scan.cu cuts n into."""
    return -(-n // SCAN_TILE)


def scan_kernel(x: torch.Tensor) -> torch.Tensor:
    """Launch csrc/scan.cu (one launch) on a contiguous 1-D int32 / float32
    CUDA tensor of fewer than 2**31 elements; raises on anything else."""
    if x.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"scan: {x.dtype}, expected int32 or float32")
    if x.device.type != "cuda":
        raise ValueError(f"scan: tensor on {x.device}, expected CUDA")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"scan: shape {tuple(x.shape)} with strides "
                         f"{x.stride()}, expected a contiguous 1-D tensor")
    n = x.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"scan: {n} elements, at most 2**31 - 1")
    out = torch.empty_like(x)
    if n:
        dev = x.device
        stream = kernels.current_stream(dev)
        s = scan_scratch(dev, stream, scan_tiles(n))
        epoch = s.next_epoch()
        kernels.launch("scan", dev, x.data_ptr(), out.data_ptr(),
                       s.words.data_ptr(), s.words.numel() - 1, n,
                       int(x.dtype == torch.float32), epoch, stream=stream)
    return out


def exclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of a 1-D int32 or float32 tensor (any length):
    csrc/scan.cu on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        if x.dtype not in (torch.int32, torch.float32):
            raise TypeError(f"scan: {x.dtype}, expected int32 or float32")
        return exclusive_scan_plain(x)
    return scan_kernel(x)


# ---------------------------------------------------------------------------
# Compaction / partition
# ---------------------------------------------------------------------------

def _scatter_perm(dst: torch.Tensor, n: int) -> torch.Tensor:
    """gather_idx[j] = i where dst[i] == j (dst a permutation of 0..n-1)."""
    iota = torch.arange(n, dtype=torch.int32, device=dst.device)
    return torch.zeros(n, dtype=torch.int32, device=dst.device).scatter_(
        0, dst.long(), iota)


def partition_multisort(tree, mask: torch.Tensor):
    """Stable liveness partition by one sort: (packed_tree, live_count),
    live lanes first, dead lanes after, each in order."""
    key = torch.where(mask, 0, 1).to(torch.int32)
    perm = torch.sort(key, stable=True).indices
    return gather_tree(tree, perm), mask.sum(dtype=torch.int32)


def sort_by_key_multisort(keys: torch.Tensor, tree):
    """Stable sort of a tree by integer keys: (sorted_keys int32,
    sorted_tree)."""
    sorted_keys, perm = torch.sort(keys.to(torch.int32), stable=True)
    return sorted_keys, gather_tree(tree, perm)


def sort_by_key_segmented(keys: torch.Tensor, tree, seg: int = SEG):
    """Stable sort of a tree by integer keys WITHIN each column of the
    (N / seg, seg) view: along dim 0, as the JAX package's lax.sort. A lane
    never leaves its column, which makes the sorted mode's pixel unsort an
    exact inverse. Needs N % seg == 0."""
    n = keys.shape[0]
    assert n % seg == 0, f"pool {n} not divisible by segment {seg}"
    sorted_keys, perm = torch.sort(keys.to(torch.int32).reshape(-1, seg),
                                   dim=0, stable=True)
    out = tree_map(lambda a: a.reshape(-1, seg).gather(0, perm).reshape(-1),
                   tree)
    return sorted_keys.reshape(-1), out


def compaction_indices(mask: torch.Tensor):
    """Stable-partition permutation from a liveness mask: (gather_idx [N]
    int32, live_count 0-d int32); gather_idx[:live_count] index the live
    elements in order, the rest the dead ones in order."""
    n = mask.shape[0]
    b = mask.to(torch.int32)
    live_pos = exclusive_scan(b)                         # rank among live
    live_count = live_pos[-1] + b[-1]
    iota = torch.arange(n, dtype=torch.int32, device=mask.device)
    dead_pos = iota - live_pos                           # rank among dead
    dst = torch.where(mask, live_pos, live_count + dead_pos)
    return _scatter_perm(dst, n), live_count


def gather_tree(tree, idx: torch.Tensor):
    """Apply a gather permutation to every [N] leaf of a tree."""
    idx = idx.long()
    return tree_map(lambda a: a[idx], tree)


def compact(tree, mask: torch.Tensor):
    """Stream compaction of a tree of [N] tensors by a boolean mask:
    (packed_tree, live_count), live elements first in order, the dead ones
    after them in order."""
    idx, count = compaction_indices(mask)
    return gather_tree(tree, idx), count


def partition_stable(tree, mask: torch.Tensor):
    """Alias of `compact`: the dead elements are kept."""
    return compact(tree, mask)


# ---------------------------------------------------------------------------
# Radix sort
# ---------------------------------------------------------------------------

def sort_by_key(keys: torch.Tensor, tree, n_bits: int = 6):
    """Stable LSD radix sort of a tree by non-negative integer keys, one bit
    a pass for `n_bits` passes (pathtracer_tpu/ops/scan.py:255-268): the
    zeros ranked by `exclusive_scan`, the ones by a plain cumsum, as in the
    JAX package. Only the low `n_bits` bits order the keys. Returns
    (sorted_keys int32, sorted_tree)."""
    n = keys.shape[0]
    keys = keys.to(torch.int32)
    idx = torch.arange(n, dtype=torch.int32, device=keys.device)
    for p in range(n_bits):
        bit = (keys >> p) & 1
        zeros = 1 - bit
        zeros_excl = exclusive_scan(zeros)               # radix_to_bools
        total_zeros = zeros_excl[-1] + zeros[-1]
        ones_excl = torch.cumsum(bit, 0, dtype=torch.int32) - bit
        dst = torch.where(bit == 0, zeros_excl, total_zeros + ones_excl)
        g = _scatter_perm(dst, n).long()
        keys, idx = keys[g], idx[g]
    return keys, gather_tree(tree, idx)
