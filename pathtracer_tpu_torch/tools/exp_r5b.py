"""Engine-level flag A/B of the binned intersector, for the port (the
counterpart of the repo's tools/exp_r5b.py): every arm renders the same
iterations, and the arms are timed interleaved, A B C A B C ..., so that a
drift of the host or the card over the run hits every arm alike.

    python -m pathtracer_tpu_torch.tools.exp_r5b [scene.json] [arm ...] \
        [--res N] [--depth N] [--rounds 4] [--chunk 4] [--device cuda]

Arms (default: base p2 p4 gate contig), each a set of ops/binned.py flags,
which are read at call time, so an arm sets them and restores them around
each of its chunks; the `tre*` arms load the scene again with that
rows-per-treelet bound:
  base    the defaults          p2, p4   PASSES = 2, 4
  gate    CHUNK_GATE            contig   BIN_CONTIGUOUS
  oct     CAND_KEY "octcell"    p2oct    both
  tre24, tre32, tre96, p2tre24  scene.tre_rows 24, 32, 96 (and PASSES 2)
A round renders `--chunk` iterations of every arm (render_chunk, from each
arm's next iteration; on the card the compiled frame, a graph an arm, since
the flags are part of engine/wavefront.py frame_key) and prints each arm's
ms/frame: the wall time of the chunk up to a synchronize, over the chunk.
Round 0 is the warm-up (and the captures).
After the rounds every arm has rendered the same iterations, so its image
must equal base's bit for bit, except a `tre*` arm below the scene's own
treelet rows, which then skips rows. Left out, with no counterpart in the
port's kernels: the JAX tool's sr8, sr32 and sr32p2 arms (STREAM_ROWS) and
fbrows16 / fbrows64 (FB_ROWS).
"""
from __future__ import annotations

import argparse
import time

import torch

from ..engine.wavefront import render_chunk, zero_accum
from ..utils.device import resolve_device
from ..utils.profiling import _sync
from .sweep_mesh import flags

ARMS = {
    "base": {},
    "p2": {"PASSES": 2},
    "p4": {"PASSES": 4},
    "gate": {"CHUNK_GATE": True},
    "contig": {"BIN_CONTIGUOUS": True},
    "oct": {"CAND_KEY": "octcell"},
    "p2oct": {"PASSES": 2, "CAND_KEY": "octcell"},
    "tre24": {"tre_rows": 24},
    "tre32": {"tre_rows": 32},
    "tre96": {"tre_rows": 96},
    "p2tre24": {"PASSES": 2, "tre_rows": 24},
}
DEFAULT_ARMS = ("base", "p2", "p4", "gate", "contig")


def run_arms(path: str, arm_names, device, overrides=None, rounds: int = 4,
             chunk: int = 4, out=print) -> dict:
    """Times the arms interleaved (module docstring). Returns {"ms": {arm:
    [ms/frame a round]}, "accum": {arm: its image sum}, "equal": {arm:
    image bit-equal to base's, where base is an arm}}."""
    from ..scene.loader import load_scene
    device = torch.device(device)
    scene, settings = load_scene(path, device, overrides=overrides)
    out(f"{path} {settings.width}x{settings.height} d{settings.trace_depth}"
        f" arms={list(arm_names)}")
    arms = {}
    for name in arm_names:
        fl = dict(ARMS[name])
        tre = fl.pop("tre_rows", None)
        sc = scene if tre is None else load_scene(
            path, device, overrides=overrides, tre_rows=tre)[0]
        arms[name] = (sc, fl)
    state = {n: [zero_accum(settings, device), 1] for n in arm_names}
    ms = {n: [] for n in arm_names}
    for rnd in range(rounds):
        tag = "warm" if rnd == 0 else "meas"
        for name in arm_names:
            sc, fl = arms[name]
            acc, it = state[name]
            _sync(device)
            t0 = time.perf_counter()
            with flags(**fl):
                render_chunk(sc, settings, acc, it, chunk, 0, True)
            _sync(device)
            ms[name].append(1e3 * (time.perf_counter() - t0) / chunk)
            state[name][1] = it + chunk
            out(f"{name:>9} ms/frame [{tag}]: {ms[name][-1]:8.2f}")
    accum = {n: s[0] for n, s in state.items()}
    equal = {}
    if "base" in accum:
        ref = accum["base"]
        for n, acc in accum.items():
            equal[n] = all(torch.equal(a.view(torch.int32),
                                       b.view(torch.int32))
                           for a, b in zip(acc, ref))
        out("image bit-equal to base: " + ", ".join(
            f"{n} {e}" for n, e in equal.items()))
    return {"ms": ms, "accum": accum, "equal": equal}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.tools.exp_r5b")
    ap.add_argument("args", nargs="*",
                    help="[scene.json] [arm ...] (default: animal.json, "
                         + " ".join(DEFAULT_ARMS) + ")")
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    from ..scene.fixtures import scene_path
    rest = list(args.args)
    path = (rest.pop(0) if rest and rest[0].endswith(".json")
            else scene_path("animal"))
    unknown = [a for a in rest if a not in ARMS]
    if unknown:
        ap.error(f"unknown arms {unknown}: expected some of {list(ARMS)}")
    overrides = {}
    if args.res:
        overrides["RES"] = [args.res, args.res]
    if args.depth:
        overrides["DEPTH"] = args.depth
    return run_arms(path, rest or DEFAULT_ARMS, resolve_device(args.device),
                    overrides or None, args.rounds, args.chunk,
                    out=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
