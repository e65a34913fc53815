"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's traffic mode (benchmark/traffic/<mode>.py, named by
workloads/<cell>.json) loads the configuration, warms up every shape the
cell uses (set-up), drives the program for `--seconds` (the window), and
hands back what the window produced; the harness then reads the metrics,
frees the program's state and compares what it produced with the plain
reference (`correct`). With --trace 0 the line holds the cell's end-to-end
metrics, with --trace 1 its per-layer metrics, read from a profiled
sub-window of the same run. Exits non-zero, printing no result, where the
card or the cell's files are missing, or where JAX or the JAX package was
loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import ctypes.util  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import spec  # noqa: E402
from benchmark.outcome import Outcome, Run  # noqa: E402

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "pathtracer_tpu"))
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3     # glibc's mallopt


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def keep_freed_memory() -> None:
    """Have glibc's malloc keep what is freed for the next allocation
    (buffers up to 32 MiB from the heap, which is never trimmed), the same
    in every run. Otherwise each frame's host buffers (an 800x800 image is
    7.7 MB as float32) are unmapped when freed and faulted in anew when
    allocated again, a cost that swings with the load on the host."""
    name = ctypes.util.find_library("c")
    if name:
        libc = ctypes.CDLL(name)
        libc.mallopt(M_MMAP_THRESHOLD, 32 << 20)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)


def _args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _metrics(cell: spec.Cell, out: Outcome, traced: bool) -> dict:
    if not traced:
        res = {}
        for m in cell.end_to_end:
            if m["name"] not in out.end_to_end:
                raise RuntimeError(f"{cell.name}: no {m['name']} measured")
            res[m["name"]] = {"value": out.end_to_end[m["name"]],
                              "unit": m["unit"]}
        return res
    res = {}
    for m in cell.per_layer:
        value = spec.reader(cell, m["name"])(out, cell)
        if value is not None:
            res[m["name"]] = {"value": value, "unit": m["unit"]}
    return res


def main(argv=None, root: str = spec.ROOT, device: str = "cuda") -> int:
    """One run; returns the exit code. `device` "cpu" skips the look for a
    card (the tests)."""
    keep_freed_memory()
    args = _args(argv)
    try:
        cell = spec.load_cell(args.workload, root)
    except (KeyError, OSError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    mode = importlib.import_module(
        f"benchmark.traffic.{cell.workload['mode']}")
    run = Run(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    out = mode.run(run)
    metrics = _metrics(cell, out, run.trace)
    t_check = time.perf_counter()
    checks = mode.check(run, out)
    print(f"benchmark: {cell.name} seed {run.seed}: {out.attempted} "
          f"attempted, the check took {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    correct = all(v <= lim for v, lim in checks.values())
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": out.kind, "count": cell.chips,
           "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": bool(correct), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": dev}
    if run.trace:
        dev["busy_s"], dev["window_s"] = out.busy_s, out.window_s
        if out.trace is not None:
            line["breakdown"] = out.trace["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} = {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(line, allow_nan=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
