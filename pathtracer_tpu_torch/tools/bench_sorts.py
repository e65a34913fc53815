"""Material-key sort shootout, for the port (the counterpart of the repo's
tools/bench_sorts.py): the LSD radix sort of ops/scan.py `sort_by_key`
(one bit a pass, each pass one launch of the scan kernel csrc/scan.cu)
against `sort_by_key_multisort` (torch.sort, stable, and a gather a
payload), on the JAX tool's case: 640,000 int32 material keys in [0, 8)
carrying 13 float32 payloads.

    python -m pathtracer_tpu_torch.tools.bench_sorts [--m 8] [--n 640000] \
        [--reps 3] [--device cuda]

Each timed call is `m` dependent sorts: a sort's keys come from the last
one's output (sorted keys + 1, mod 8, so they stay 3-bit keys) and its
payloads are the last one's sorted payloads. ms a sort = the call's median
ms over `--reps` calls (tools/sweep_mesh.py time_ms: CUDA events on the
card) / m. Before timing, the radix sort's keys and payloads must equal
torch.sort's (`check`).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.scan import sort_by_key, sort_by_key_multisort
from ..utils.device import resolve_device
from .sweep_mesh import time_ms

N, PAYLOADS, KEY_RANGE, N_BITS = 640_000, 13, 8, 3


def inputs(device, n: int = N, seed: int = 0):
    """(keys int32 [n] in [0, KEY_RANGE), PAYLOADS float32 [n] payloads),
    from numpy's generator with `seed`, as the JAX tool makes them."""
    rng = np.random.default_rng(seed)
    keys = torch.as_tensor(rng.integers(0, KEY_RANGE, n), dtype=torch.int32,
                           device=device)
    payload = tuple(torch.as_tensor(rng.normal(size=n), dtype=torch.float32,
                                    device=device) for _ in range(PAYLOADS))
    return keys, payload


def radix(keys, payload):
    return sort_by_key(keys, payload, n_bits=N_BITS)


def multisort(keys, payload):
    return sort_by_key_multisort(keys, payload)


def chain(sort_fn, keys, payload, m: int):
    """m dependent sorts; returns the last one's (keys, payloads)."""
    for _ in range(m):
        ks, payload = sort_fn(keys, payload)
        keys = (ks + 1) % KEY_RANGE
    return ks, payload


def check(keys, payload, m: int = 2) -> None:
    """Raises unless m chained radix sorts give torch.sort's keys and
    payloads, bit for bit."""
    got = chain(radix, keys, payload, m)
    ref = chain(multisort, keys, payload, m)
    if not torch.equal(got[0], ref[0]) or not all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(got[1], ref[1])):
        raise AssertionError("bench_sorts: the radix sort differs from "
                             "torch.sort")


def bench(device, m: int = 8, n: int = N, reps: int = 3,
          out=print) -> dict:
    """ms a sort of both sorts on `device` (module docstring)."""
    device = torch.device(device)
    keys, payload = inputs(device, n)
    with torch.inference_mode():
        check(keys, payload)
        res = {}
        for name, fn in (("multisort", multisort), ("radix", radix)):
            res[name] = time_ms(lambda fn=fn: chain(fn, keys, payload, m),
                                device, reps) / m
        out(f"torch.sort multisort ({PAYLOADS} payloads, {n}): "
            f"{res['multisort']:8.3f} ms/sort")
        out(f"scan-kernel LSD radix ({N_BITS} bits, {n}):     "
            f"{res['radix']:8.3f} ms/sort")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.tools.bench_sorts")
    ap.add_argument("--m", type=int, default=8,
                    help="dependent sorts a timed call")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    return bench(resolve_device(args.device), args.m, args.n, args.reps,
                 out=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
