"""The port's benchmark matrix (the counterpart of the repo's
tools/bench_suite.py): the reference's measurement matrix (BASELINE.md),
17 rows, on the CUDA device.

    python -m pathtracer_tpu_torch.tools.bench_suite [--quick] \
        [--out BENCH_torch.md] [--device cuda]
    python -m pathtracer_tpu_torch.tools.bench_suite --merge A.json B.json \
        [--headline LINE.json ...] [--out BENCH_torch.md]

Each row loads its scene outside the timed window, renders one warm-up
chunk and REPS timed chunks (`bench_wavefront`, `bench_persistent`),
then, also outside the timed window, one `utils/profiling.device_profile`
pass of PROFILE_ITERS frames: device ms, device kernels and busy share a
frame. `ops.kernels.LAUNCHES` is reset just before the row and read just
after it. The statistic of the JAX tool is the best rep's ms per frame; the
median, the max and every rep stand beside it. A row that raises, a profile
that is not whole (busy share above 1 or no device time, taken up to
PROFILE_ATTEMPTS times), or a mesh row that launched no kernel on the card,
is written with its error and makes the run exit 1.

Writes `--out` (markdown) and the same path with .json. `--merge` writes one
table from the JSON files of several runs (one run a process) and the
headline lines of `python -m pathtracer_tpu_torch.tools.bench` (files whose
last line is that JSON line, `--headline`). `--quick` drops the mesh rows,
as the JAX tool's does; `--res` / `--depth` cut every row's size (for a
short run on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
import traceback

import torch

# The reference's published ms/frame (BASELINE.md), as the JAX tool keeps
# them. The reference's BVH table (its README.md:314-321) was measured at
# the teapot and alien scenes' checked-in configs (800x800 d4); cow has no
# checked-in reference scene, so its 19 ms is the closest published number.
BASELINES_MS = {
    "cornell defaults": 35.18,
    "cornell + material sort": 42.95,
    "teapot d4": 17.0,
    "cow d4": 19.0,
    "alien d4": 22.0,
}
REFERENCE_CARD = "RTX 3060 Laptop (BASELINE.md)"
MESH_SCENES = ("teapot", "cow", "animal")
REPS = 3                # timed chunks a row, as in the JAX tool
PROFILE_ITERS = 3       # frames of a row's device_profile pass
PROFILE_ATTEMPTS = 2    # profiles a row takes before its gaps fail it
OPEN_800_D8 = {"RES": [800, 800], "DEPTH": 8}


@dataclasses.dataclass(frozen=True)
class Row:
    """One row of the matrix: the JAX tool's run(name, path, fn, overrides,
    chunk, **settings replacements)."""

    name: str
    scene: str                  # a scene of scenes/ (scene_path's name)
    engine: str = "wavefront"   # or "persistent"
    chunk: int = 30
    overrides: dict | None = None
    replace: dict = dataclasses.field(default_factory=dict)

    @property
    def wide_tables(self) -> bool:
        return self.replace.get("bvh_impl") in ("wide", "wide_nosort")

    @property
    def mesh(self) -> bool:
        return self.scene in MESH_SCENES


ROWS = (
    Row("cornell defaults", "cornell"),
    Row("cornell persistent engine", "cornell", engine="persistent"),
    Row("cornell no AA", "cornell", replace={"jitter": False}),
    Row("cornell no DoF", "cornell", replace={"dof": False}),
    Row("cornell + material sort", "cornell", chunk=10,
        replace={"sort_materials": True}),
    Row("cornell threefry RNG", "cornell", replace={"fast_rng": False}),
    Row("cornell depth quirk", "cornell", replace={"depth_quirk": True}),
    Row("open scene", "open_test_scene", overrides=OPEN_800_D8),
    Row("open scene persistent engine", "open_test_scene",
        engine="persistent", overrides=OPEN_800_D8),
    Row("teapot d4", "teapot", chunk=3),
    Row("cow d4", "cow", chunk=3),
    Row("alien d4", "animal", chunk=3),
    Row("alien d4 persistent engine", "animal", engine="persistent",
        chunk=32),
    Row("teapot d4 wide", "teapot", chunk=3, replace={"bvh_impl": "wide"}),
    Row("alien d4 wide", "animal", chunk=3, replace={"bvh_impl": "wide"}),
    Row("teapot d4 binned", "teapot", chunk=3,
        replace={"bvh_impl": "binned"}),
    Row("alien d4 binned", "animal", chunk=3,
        replace={"bvh_impl": "binned"}),
)


def rows(quick: bool = False) -> list[Row]:
    """The matrix; `quick` drops the mesh rows."""
    return [r for r in ROWS if not (quick and r.mesh)]


def row_named(name: str) -> Row:
    return next(r for r in ROWS if r.name == name)


@dataclasses.dataclass
class Timing:
    """Milliseconds per frame of each timed chunk."""

    reps_ms: list

    @property
    def best(self) -> float:
        return min(self.reps_ms)

    @property
    def median(self) -> float:
        return statistics.median(self.reps_ms)

    @property
    def max(self) -> float:
        return max(self.reps_ms)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_wavefront(scene, settings, chunk: int = 30, reps: int = REPS,
                    seed: int = 0, warmup: int = 1):
    """`warmup` chunks of `render_chunk(..., early_exit=True)` from
    iteration 1, then `reps` timed chunks, each ending in a synchronize.
    Returns (Timing, the accumulator)."""
    from ..engine.wavefront import render_chunk, zero_accum

    dev = scene.device
    times = []
    with torch.inference_mode():
        accum = zero_accum(settings, dev)
        it = 1
        for k in range(warmup + reps):
            t0 = time.perf_counter()
            render_chunk(scene, settings, accum, it, chunk, seed, True)
            _sync(dev)
            if k >= warmup:
                times.append(1e3 * (time.perf_counter() - t0) / chunk)
            it += chunk
    return Timing(times), accum


def bench_persistent(scene, settings, chunk: int = 30, reps: int = REPS,
                     seed: int = 0):
    """Fresh lanes, one warm-up chunk to `chunk` samples, then `reps` timed
    chunks to 2 chunk, 3 chunk, ... samples, each ending in a synchronize.
    Returns (Timing, the lane state)."""
    from ..engine.persistent import (fresh_lanes, pixel_stride,
                                     render_persistent_chunk)

    dev = scene.device
    times = []
    with torch.inference_mode():
        state = fresh_lanes(settings, dev)
        stride = pixel_stride(settings.pixel_count)
        for k in range(1 + reps):
            t0 = time.perf_counter()
            state = render_persistent_chunk(scene, settings, state,
                                            (k + 1) * chunk, seed, stride)
            _sync(dev)
            if k:
                times.append(1e3 * (time.perf_counter() - t0) / chunk)
    return Timing(times), state


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu" off
    the card)."""
    if device.type != "cuda":
        return "cpu"
    from ..utils.kernel_bench import card_line
    return card_line()


def _profile(scene, settings, mode: str) -> tuple[dict, int, str | None]:
    """device_profile of PROFILE_ITERS frames, taken again while it is not
    whole: (profile, frames rendered, the error of the last one or None)."""
    from ..utils.profiling import device_profile

    frames, err = 0, None
    for _ in range(PROFILE_ATTEMPTS):
        prof = device_profile(scene, settings, iters=PROFILE_ITERS,
                              mode=mode)
        frames += 1 + PROFILE_ITERS
        if scene.device.type != "cuda":
            return prof, frames, None
        err = None
        if not prof["device_ms"] > 0:
            err = f"profile: device ms {prof['device_ms']}"
        elif prof["busy_share"] > 1:
            err = f"profile: busy share {prof['busy_share']}"
        if err is None:
            break
    return prof, frames, err


def run_row(row: Row, device, reps: int = REPS,
            size: dict | None = None) -> dict:
    """One row on `device` (`size`: overrides that cut it). Raises if the
    render does; a profile or launch-count failure is the record's
    "error"."""
    from ..ops import kernels
    from ..scene.fixtures import scene_path
    from ..scene.loader import load_scene

    device = torch.device(device)
    t0 = time.perf_counter()
    overrides = {**(row.overrides or {}), **(size or {})} or None
    scene, settings = load_scene(scene_path(row.scene), device,
                                 overrides=overrides,
                                 wide_tables=row.wide_tables)
    if row.replace:
        settings = dataclasses.replace(settings, **row.replace)
    load_s = time.perf_counter() - t0
    persistent = row.engine == "persistent"
    kernels.reset_counts()
    fn = bench_persistent if persistent else bench_wavefront
    timing, _ = fn(scene, settings, chunk=row.chunk, reps=reps)
    with torch.inference_mode():
        prof, prof_frames, err = _profile(
            scene, settings, "persistent" if persistent else "masked")
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    frames = row.chunk * (1 + reps) + prof_frames
    if err is None and device.type == "cuda" and row.mesh and not launches:
        err = "launched no kernel"
    base = BASELINES_MS.get(row.name)
    return {
        "config": row.name, "scene": row.scene, "engine": row.engine,
        "bvh": settings.bvh_impl if row.mesh else None,
        "chunk": row.chunk, "reps": reps,
        "res": [settings.width, settings.height],
        "depth": settings.trace_depth, "load_s": load_s,
        "ms_per_frame": timing.best, "median_ms": timing.median,
        "max_ms": timing.max, "reps_ms": timing.reps_ms,
        "primary_mrays_per_s": settings.pixel_count / timing.best / 1e3,
        "reference_ms": base,
        "speedup_vs_reference": base / timing.best if base else None,
        "traced_wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
        "device_kernels": prof["launches"], "busy_share": prof["busy_share"],
        "frames": frames, "kernel_launches": launches,
        "kernel_launches_a_frame": {k: v / frames
                                    for k, v in launches.items()},
        "error": err,
    }


def run_matrix(device, quick: bool = False,
               size: dict | None = None) -> dict:
    """Every row of the matrix in this process; a row that raises is kept
    with its error."""
    device = torch.device(device)
    t0 = time.perf_counter()
    if device.type == "cuda":
        from ..ops import kernels
        kernels.library()      # the build stays out of every row
    out = []
    for row in rows(quick):
        try:
            rec = run_row(row, device, size=size)
        except Exception as e:   # the row fails; the run goes on and fails
            traceback.print_exc()
            rec = {"config": row.name, "scene": row.scene,
                   "engine": row.engine, "chunk": row.chunk,
                   "reference_ms": BASELINES_MS.get(row.name),
                   "error": f"{type(e).__name__}: {e}"}
        out.append(rec)
        print(row_line(rec), flush=True)
    return {"card": card(device), "device": str(device),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "quick": quick, "reps": REPS, "size": size, "rows": out,
            "seconds": time.perf_counter() - t0}


def row_line(rec: dict) -> str:
    if rec.get("ms_per_frame") is None:
        return f"{rec['config']}: FAILED {rec['error']}"
    line = (f"{rec['config']}: {rec['ms_per_frame']:.3f} ms best, "
            f"{rec['median_ms']:.3f} median, "
            f"{rec['primary_mrays_per_s']:.1f} Mrays/s")
    if rec["device_ms"] is not None:
        line += (f"; {rec['device_ms']:.2f} device ms, "
                 f"{rec['device_kernels']:.0f} device kernels, busy "
                 f"{100 * rec['busy_share']:.1f}%")
    line += f"; launches {rec['kernel_launches']}"
    if rec["error"]:
        line += f"; FAILED {rec['error']}"
    return line


def _spread(vals) -> str:
    vals = [v for v in vals if v is not None]
    if len(vals) < 2:
        return "—"
    return f"{max(vals) / min(vals):.3f}×"


def render_markdown(runs: list, headlines: list) -> str:
    """The table of one or more runs (one a process), each number as
    "run 1 / run 2 / ..."."""
    def ok(run, name):
        rec = next((r for r in run["rows"] if r["config"] == name), None)
        return rec if rec and rec.get("ms_per_frame") is not None else None

    cards = sorted({run["card"] for run in runs})
    lines = [
        "# BENCH_torch — the port's benchmark matrix on "
        + "; ".join(cards), "",
        "Written by `python -m pathtracer_tpu_torch.tools.bench_suite` "
        f"from {len(runs)} process(es); each cell reads "
        + " / ".join(f"process {i + 1}" for i in range(len(runs)))
        + ". Card (nvidia-smi name, power limit): "
        + "; ".join(f"process {i + 1}: {run['card']}, torch "
                    f"{run['torch']}, CUDA {run['cuda']}, "
                    f"{run['seconds']:.1f} s"
                    for i, run in enumerate(runs)) + ".", "",
        "ms/frame: one progressive iteration at the scene's configured "
        "resolution and depth, wall time of chunks ending in a synchronize "
        "(best and median of the timed chunks). Device ms, device kernels "
        "and busy share: torch.profiler over "
        f"{PROFILE_ITERS} more frames; busy is device ms over that traced "
        "wall time, which the profiler lengthens. Kernel launches: the "
        "port's kernel "
        "wrappers over every frame of the row. Spread: the larger process's "
        "median over the smaller's. The reference column is the "
        f"reference CUDA tracer's published number on an {REFERENCE_CARD}, "
        "another card and program.", "",
        "| Config | engine, chunk | ms/frame best | ms/frame median "
        "| spread | device ms | device kernels | busy | kernel launches a "
        f"frame | primary Mrays/s | {REFERENCE_CARD} ms |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    failed = []
    for row in [r["config"] for r in runs[0]["rows"]]:
        recs = [ok(run, row) for run in runs]
        first = next((r for r in recs if r), None)
        engine = (f"{first['engine']}"
                  + (f" {first['bvh']}" if first and first["bvh"] else "")
                  + f", {first['chunk']}") if first else "—"
        ref = BASELINES_MS.get(row)

        def cell(fmt):
            return " / ".join("—" if r is None else fmt(r) for r in recs)

        launches = {", ".join(f"{k} {v:.2f}" for k, v in
                              r["kernel_launches_a_frame"].items()) or "none"
                    for r in recs if r}
        lines.append(" | ".join([
            f"| {row}", engine,
            cell(lambda r: _num(r["ms_per_frame"], 3)),
            cell(lambda r: _num(r["median_ms"], 3)),
            _spread([r["median_ms"] if r else None for r in recs]),
            cell(lambda r: _num(r["device_ms"], 2)),
            cell(lambda r: _num(r["device_kernels"], 0)),
            cell(lambda r: _pct(r["busy_share"])),
            " / ".join(sorted(launches)) or "—",
            cell(lambda r: _num(r["primary_mrays_per_s"], 1)),
            f"{ref if ref else '—'} |"]))
        for i, run in enumerate(runs):
            rec = next((r for r in run["rows"] if r["config"] == row), None)
            if rec is None or rec.get("error"):
                failed.append(f"- {row}, process {i + 1}: "
                              + (rec["error"] if rec else "not run"))
    lines += ["", "## Failed rows", ""] + (failed or ["None."])
    if headlines:
        lines += ["", "## Headline (`python -m "
                  "pathtracer_tpu_torch.tools.bench`)", "", "```"]
        lines += [json.dumps(h) for h in headlines] + ["```"]
    return "\n".join(lines) + "\n"


def _num(v, digits: int) -> str:
    return "—" if v is None else f"{v:.{digits}f}"


def _pct(v) -> str:
    return "—" if v is None else f"{100 * v:.1f}%"


def write_outputs(runs: list, headlines: list, out: str) -> str:
    """Write `out` (markdown) and its .json; returns the JSON's path."""
    path = out[:-3] + ".json" if out.endswith(".md") else out + ".json"
    with open(path, "w") as f:
        json.dump({"cards": sorted({run["card"] for run in runs}),
                   "reference_card": REFERENCE_CARD, "runs": runs,
                   "headline": headlines}, f, indent=1)
    with open(out, "w") as f:
        f.write(render_markdown(runs, headlines))
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.tools.bench_suite")
    ap.add_argument("--quick", action="store_true",
                    help="skip the mesh rows")
    ap.add_argument("--out", default="BENCH_torch.md",
                    help="markdown path; the JSON goes beside it")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    ap.add_argument("--res", type=int, default=None,
                    help="cut every row to N x N")
    ap.add_argument("--depth", type=int, default=None,
                    help="cut every row to this trace depth")
    ap.add_argument("--merge", nargs="+", default=None, metavar="JSON",
                    help="write one table from these runs' JSON files")
    ap.add_argument("--headline", nargs="+", default=[], metavar="FILE",
                    help="with --merge: files ending in a bench JSON line")
    args = ap.parse_args(argv)

    if args.merge:
        runs = []
        for path in args.merge:
            with open(path) as f:
                runs += json.load(f)["runs"]
        headlines = []
        for path in args.headline:
            with open(path) as f:
                headlines.append(json.loads(f.read().strip().splitlines()[-1]))
    else:
        from ..utils.device import resolve_device
        device = resolve_device(args.device)
        size = {}
        if args.res:
            size["RES"] = [args.res, args.res]
        if args.depth:
            size["DEPTH"] = args.depth
        runs = [run_matrix(device, args.quick, size or None)]
        headlines = []
    path = write_outputs(runs, headlines, args.out)
    print(f"wrote {args.out} and {path}")
    return 1 if any(rec.get("error") for run in runs
                    for rec in run["rows"]) else 0


if __name__ == "__main__":
    sys.exit(main())
