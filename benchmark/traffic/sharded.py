"""Sharded rendering: one rank a card, NCCL, each rank rendering its
interleaved share of the image's lanes through the compiled frame, in
chunks of `chunk` iterations; after each chunk `fetch_image` all-gathers
the whole image to every rank (a progressive preview).

The run's process starts `ranks` processes of this module (rank r on
cuda:r; a free localhost port; each with a time limit, so a hung rank
fails the run), reads each rank's JSON line, and checks rank 0's last
gathered image once every rank has exited. Each rank loads the scene,
warms up on a scratch accumulator (one chunk of 2 iterations and a
gather: the eager warm-up iteration and the capture of its graph), meets
the others at a barrier (the window opens), and runs chunks until rank 0
has seen the window's seconds pass and says stop (a broadcast after each
gather). sharded_frame_ms is rank 0's wall time from the barrier to its
last gathered image over the iterations; setup_s runs from the start of
the run's process to the barrier. Per chunk each rank times its render up
to a synchronize (rank_render_s, summed) and its fetch_image (gather_s).
With --trace 1 each rank profiles chunk `trace.skip_chunks`.

    python3 -m benchmark.traffic.sharded --rank R ...    (one rank)
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .. import spec
from .. import trace as tr
from ..outcome import Outcome
from . import rel_l1, sample, sync

RANK_MODULE = "benchmark.traffic.sharded"     # what each rank runs


def _free_port() -> int:
    """A localhost port below Linux's ephemeral range (32768 on), so that
    no outgoing connection is handed it between this probe and rank 0's
    listen: the first that binds now, in an order of this process's own
    (two runs on one host try different ports)."""
    for port in np.random.default_rng([os.getpid(), 4]).permutation(
            np.arange(20000, 32768)):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", int(port)))
            except OSError:
                continue
            return int(port)
    raise RuntimeError("no free localhost port in 20000-32767")


def _wait(procs: list, deadline: float) -> str | None:
    """Wait for every rank; as soon as one fails, or the deadline passes,
    kill them all. Returns why the ranks were stopped, or None."""
    why = None
    while any(p.poll() is None for p in procs):
        bad = [r for r, p in enumerate(procs)
               if p.poll() is not None and p.returncode != 0]
        if bad:
            why = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
        elif time.time() > deadline:
            why = "a rank ran over its time limit"
        if why:
            for p in procs:
                p.kill()
            break
        time.sleep(0.05)
    for p in procs:
        p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    return why or (f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                   if bad else None)


def run(run) -> Outcome:
    wl = run.cell.workload
    n = int(wl["ranks"])
    init = f"tcp://127.0.0.1:{_free_port()}"
    t0_wall = time.time() - (time.perf_counter() - run.t0)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in (spec.ROOT, env.get("PYTHONPATH")) if p])
    if run.device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    else:
        # the kernel library, built once here rather than by every rank
        from pathtracer_tpu_torch.ops import kernels
        kernels.build()
    procs, logs = [], []
    for r in range(n):
        dev = f"cuda:{r}" if run.device == "cuda" else run.device
        logs.append((tempfile.TemporaryFile("w+"),
                     tempfile.TemporaryFile("w+")))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", RANK_MODULE, "--rank", str(r), "--world",
             str(n), "--init", init, "--root", run.cell.root, "--cell",
             run.cell.name, "--seed", str(run.seed), "--seconds",
             str(run.seconds), "--trace", str(int(run.trace)), "--device",
             dev, "--backend", wl["backend"]],
            cwd=spec.ROOT, env=env, stdout=logs[-1][0], stderr=logs[-1][1],
            text=True))
    why = _wait(procs, time.time() + float(wl["rank_timeout_s"]))
    outs = []
    for so, se in logs:
        so.seek(0)
        se.seek(0)
        outs.append((so.read(), se.read()))
        so.close()
        se.close()
    if why:
        for r, (_, se) in enumerate(outs):
            sys.stderr.write(f"--- rank {r}\n{se[-3000:]}")
        raise RuntimeError(why)
    reps = [json.loads(so.strip().splitlines()[-1]) for so, _ in outs]
    r0 = reps[0]
    totals = [sum(rep["render_s"]) for rep in reps]
    slowest = reps[int(np.argmax(totals))]
    traced = [rep["trace"] for rep in reps if rep["trace"]]
    return Outcome(
        end_to_end={"sharded_frame_ms": 1000.0 * r0["window_s"]
                    / r0["iterations"],
                    "setup_s": max(rep["open_wall"] for rep in reps)
                    - t0_wall},
        attempted=r0["iterations"], failed=0,
        memory_peak_bytes=max(rep["peak"] for rep in reps),
        kind=r0["kind"],
        answers={"iterations": r0["iterations"],
                 "pixels": np.asarray(r0["pixels"], np.int64),
                 "values": np.asarray(r0["values"], np.float32)},
        spans={"gather_s": r0["gather_s"], "rank_render_s": totals},
        trace=slowest["trace"],
        busy_s=(sum(t["busy_s"] for t in traced) / len(traced)
                if traced else None),
        window_s=(sum(t["window_s"] for t in traced) / len(traced)
                  if traced else None))


def check(run, out: Outcome) -> dict:
    from ..reference import tracer
    from . import reference_average
    dev = torch.device(run.device)
    scene = spec.load_reference_scene(run.cell)
    tb = tracer.Tables(scene, dev)
    cams = {k: v[None] for k, v in scene.startup_camera().items()}
    ans = out.answers
    ref = reference_average(tb, cams, 0, ans["pixels"], ans["iterations"],
                            run.seed)
    limit = run.cell.workload["check"]["limit"]["rel_l1"]
    return {"rel_l1": (rel_l1(ans["values"], ref.float().cpu().numpy()),
                       limit)}


def rank_main(argv=None) -> int:
    """One rank: prints one JSON line of its readings."""
    import torch.distributed as dist
    from pathtracer_tpu_torch.parallel.distributed import (global_ray_mesh,
                                                           init_distributed,
                                                           make_global_accum)
    from pathtracer_tpu_torch.parallel.sharding import (fetch_image,
                                                        render_chunk_sharded)
    ap = argparse.ArgumentParser()
    for k in ("--rank", "--world", "--trace"):
        ap.add_argument(k, type=int, required=True)
    for k in ("--init", "--root", "--cell", "--device", "--backend"):
        ap.add_argument(k, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    cell = spec.load_cell(a.cell, a.root)
    wl = cell.workload
    dev = torch.device(a.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(a.backend, init_method=a.init, world_size=a.world,
                     rank=a.rank)
    mesh = global_ray_mesh(dev)
    scene, settings = spec.load_program_scene(cell, dev)
    chunk, skip = int(wl["chunk"]), int(wl["trace"]["skip_chunks"])
    with torch.inference_mode():
        warm = make_global_accum(settings, mesh)
        render_chunk_sharded(scene, settings, mesh, warm, 1, 2, a.seed)
        fetch_image(warm, settings, 2, mesh)
        del warm
        accum = make_global_accum(settings, mesh)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        sync(dev)
        dist.barrier()
        open_wall = time.time()
        t_open = time.perf_counter()
        done = chunks = 0
        render_s, gather_s = [], []
        prof = summary = img = None
        while True:
            tracing = bool(a.trace) and chunks == skip
            if tracing:
                prof = tr.profiler(dev)
                prof.__enter__()
            with tr.span(tracing, tr.WINDOW):
                t0 = time.perf_counter()
                render_chunk_sharded(scene, settings, mesh, accum, done + 1,
                                     chunk, a.seed)
                sync(dev)
                t1 = time.perf_counter()
                img = fetch_image(accum, settings, done + chunk, mesh)
                t2 = time.perf_counter()
            if tracing:
                prof.__exit__(None, None, None)
            render_s.append(t1 - t0)
            gather_s.append(t2 - t1)
            done += chunk
            chunks += 1
            if a.rank == 0:
                flag.fill_(int(t2 - t_open >= a.seconds
                               and not (a.trace and chunks <= skip)))
            dist.broadcast(flag, src=0)
            if int(flag.item()):
                break
        window_s = t2 - t_open
        peak = (int(torch.cuda.max_memory_allocated(dev))
                if dev.type == "cuda" else 0)
        if prof is not None:
            summary = tr.read(prof, chunk)
    dist.destroy_process_group()
    from ..run import forbidden_modules
    bad = forbidden_modules()
    if bad:
        print(f"rank {a.rank}: loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    pixels = sample(a.seed, 1, settings.pixel_count,
                    int(wl["check"]["pixels"]))
    rep = {"rank": a.rank, "iterations": done, "window_s": window_s,
           "open_wall": open_wall, "render_s": render_s,
           "gather_s": gather_s, "peak": peak, "trace": summary,
           "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu")}
    if a.rank == 0:
        rep["pixels"] = pixels.tolist()
        rep["values"] = img.reshape(-1, 3)[pixels].tolist()
    print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
