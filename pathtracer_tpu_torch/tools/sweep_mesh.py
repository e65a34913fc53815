"""Mesh-traversal sweep of the port (the counterpart of the repo's
tools/sweep_mesh.py): times ONE mesh intersection of a realistic bounce-ray
pool per configuration, the primary hit points of one iteration with
cosine-hemisphere directions, bounded by the analytic geoms' closest hit.

    python -m pathtracer_tpu_torch.tools.sweep_mesh [scene.json] [mode] \
        [--res N] [--reps N] [--device cuda]

Modes (default `all`), each row the median ms of `--reps` calls after two
warm-up calls:
  all          the 8-wide walks (sorted, unsorted, unsorted with the push
               cull, the mask stack, a max_leaf=8 wide tree), the binned
               intersector with each exact finish, and the sorted packet
               walk;
  passes       binned at passes 2, 3, 4, 6, 8, then passes 2, 4, 8 with
               FALLBACK=False (wrong results: the finish's cost);
  prod         the default binned intersector alone;
  expand       the default, then expand=2, 3, 4, 6, twice;
  expand_nofb  the same with FALLBACK=False, K = 2, 4, 6;
  slots        the default, then slots=3, 4, 6, twice;
  tune         the default, FB_COMPACT=False, passes 3, CAND_SORT=False,
               twice;
  support      MIN_SUPPORT = 1, 16, 64, 256, twice;
  gate         CHUNK_GATE on and off, twice;
  uv           STREAM_UV on and off, twice;
  layout       column sorts, then BIN_CONTIGUOUS;
  leaf         the treelet size: max_leaf / rows-per-treelet 96/16 (the
               default), 132/22, 192/32, 288/48, then 96/16 again;
  csplit       the contiguous layout's split: sorts and cull (FALLBACK off,
               STREAM_OFF), + stream, + fallback, and the column layout;
  split        the default's split: sorts only (FALLBACK off, CULL_CHEAP,
               STREAM_OFF), + cull, + stream, + fallback.
The ablation flags give wrong results on purpose (ops/binned.py); each arm
sets its flags and restores them after.

Timing: on the card, CUDA events around each call (utils/kernel_bench.py
cuda_ms); on the CPU, the wall clock between synchronizations. The JAX
tool chains its calls through a data dependency because the TPU transport
cached results and resolved waits early; a CUDA stream does neither, so
every call here takes the same inputs.

Arms of the JAX tool left out, with no counterpart in the port's kernels:
`rows` and `tune`'s sr32 arm (STREAM_ROWS, STREAM_ROW_CHUNK), `fbrows`
(FB_ROWS), `layout`'s row-chunk arm (STREAM_ROW_CHUNK), `defer`
(DEFER_NORMAL), the wide rows' `packet_rows` sweep and the sorted packet
walk's `block_rows` (the port's walks take no block shape: one unsorted
wide row, one sorted row at sort_chunk 65,536).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import torch

from ..ops import binned
from ..utils.device import resolve_device
from ..utils.vec import Vec3

FLT_MAX = 3.402823466e38
REPS = 8
MODES = ("all", "passes", "prod", "expand", "expand_nofb", "slots", "tune",
         "support", "gate", "uv", "layout", "leaf", "csplit", "split")


def make_bounce_rays(scene, settings, seed: int = 0):
    """Primary rays -> first hit -> cosine bounce rays (sweep_mesh.py:23):
    (origin Vec3, direction Vec3, hit [N] bool). A lane whose primary ray
    missed keeps its primary ray."""
    from ..engine.wavefront import generate_paths
    from ..ops import rng
    from ..ops.bsdf import cosine_hemisphere
    from ..ops.intersect import intersect_scene

    irng = rng.IterationRng(seed, 1, pixel_map=settings.pixel_map())
    state = generate_paths(scene, settings, irng)
    t, normal, _ = intersect_scene(scene, settings.geom_types, state.origin,
                                   state.direction, bvh_impl="pallas")
    hit = t > 0.0
    p = state.origin + state.direction * t
    o = p + normal * 1e-3
    u1, u2 = irng.uniforms(0, state.pixel, 2)
    d = cosine_hemisphere(normal, u1, u2)
    return (Vec3.where(hit, o, state.origin),
            Vec3.where(hit, d, state.direction), hit)


def analytic_bound(scene, settings, o: Vec3, d: Vec3) -> torch.Tensor:
    """Per lane, the closest positive hit of the analytic geoms (boxes and
    spheres), FLT_MAX where none (sweep_mesh.py:48)."""
    from ..ops.intersect import box_intersect, sphere_intersect
    from ..scene.types import MESH, SPHERE

    g = scene.geoms
    tb = torch.full((o.x.shape[0],), FLT_MAX, device=o.x.device)
    for i, gt in enumerate(settings.geom_types):
        if gt == MESH:
            continue
        fn = sphere_intersect if gt == SPHERE else box_intersect
        t, _ = fn(g.transform[i], g.inverse_transform[i], g.inv_transpose[i],
                  o, d)
        tb = torch.where((t > 0.0) & (t < tb), t, tb)
    return tb


@dataclasses.dataclass
class Pool:
    """A scene's bounce-ray pool: the inputs of every sweep row."""
    path: str
    scene: object
    settings: object
    o: Vec3
    d: Vec3
    hit: torch.Tensor
    tb: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.o.x.device

    @property
    def roots(self) -> tuple:
        return self.scene.mesh_roots


def make_pool(path: str, device, overrides=None, **load_kw) -> Pool:
    """Loads `path` on `device` and makes its bounce-ray pool."""
    from ..scene.loader import load_scene
    scene, settings = load_scene(path, device, overrides=overrides,
                                 **load_kw)
    with torch.inference_mode():
        o, d, hit = make_bounce_rays(scene, settings)
        tb = analytic_bound(scene, settings, o, d)
    return Pool(path, scene, settings, o, d, hit, tb)


@contextlib.contextmanager
def flags(**values):
    """Sets module flags of ops/binned.py for the block, then restores
    them."""
    saved = {k: getattr(binned, k) for k in values}
    for k, v in values.items():
        setattr(binned, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(binned, k, v)


def time_ms(fn, device: torch.device, reps: int = REPS) -> float:
    """Median ms of fn() over `reps` calls after two warm-up calls: CUDA
    events on the card (utils/kernel_bench.py cuda_ms), the wall clock
    between synchronizations elsewhere."""
    if device.type == "cuda":
        from ..utils.kernel_bench import cuda_ms
        return cuda_ms(fn, reps)
    fn()
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def _timed(pool: Pool, call, reps: int) -> float:
    with torch.inference_mode():
        return time_ms(call, pool.device, reps)


def run_binned(pool: Pool, reps: int = REPS, scene=None, **kw) -> float:
    """The binned intersector on the pool (`kw`: its arguments)."""
    sc = scene or pool.scene
    return _timed(pool, lambda: binned.mesh_intersect_binned(
        sc, sc.mesh_roots, pool.o, pool.d, active=pool.hit,
        t_bound=pool.tb, **kw), reps)


def run_binned_fb(pool: Pool, fb: str, reps: int = REPS) -> float:
    return run_binned(pool, reps, fallback_impl=fb)


def run_expand(pool: Pool, k: int, reps: int = REPS) -> float:
    return run_binned(pool, reps, expand=k)


def run_slots(pool: Pool, k: int, reps: int = REPS) -> float:
    return run_binned(pool, reps, slots=k)


def run_plain(pool: Pool, reps: int = REPS) -> float:
    """The packet walk of the first mesh over the pool ("pallas")."""
    from ..ops.bvh_packet import mesh_intersect_packet
    return _timed(pool, lambda: mesh_intersect_packet(
        pool.scene, pool.roots[0], pool.o, pool.d, active=pool.hit,
        t_bound=pool.tb), reps)


def run_sorted(pool: Pool, chunk: int = 65536, reps: int = REPS) -> float:
    """The coherence-sorted packet walk ("sorted")."""
    from ..ops.bvh_packet import mesh_intersect_packet_sorted
    return _timed(pool, lambda: mesh_intersect_packet_sorted(
        pool.scene, pool.roots[0], pool.o, pool.d, active=pool.hit,
        t_bound=pool.tb, sort_chunk=chunk), reps)


def run_wide(pool: Pool, sort: bool, cull: bool = False,
             variant: str = "push", reps: int = REPS, scene=None) -> float:
    """The 8-wide walk, coherence-sorted ("wide") or not."""
    from ..ops.wide import mesh_intersect_wide, mesh_intersect_wide_sorted
    sc = scene or pool.scene
    if sort:
        return _timed(pool, lambda: mesh_intersect_wide_sorted(
            sc, sc.mesh_roots, pool.o, pool.d, active=pool.hit,
            t_bound=pool.tb, variant=variant), reps)
    return _timed(pool, lambda: mesh_intersect_wide(
        sc, pool.o, pool.d, active=pool.hit, t_bound=pool.tb, cull=cull,
        variant=variant), reps)


def run_leaf(pool: Pool, max_leaf: int, rows: int,
             reps: int = REPS) -> float:
    """The binned intersector on the scene rebuilt with `max_leaf`-triangle
    treelets of at most `rows` rows (the same rays)."""
    from ..scene.loader import load_scene
    sc, _ = load_scene(pool.path, pool.device, max_leaf=max_leaf,
                       tre_rows=rows)
    return run_binned(pool, reps, scene=sc)


def run_wide_leaf8(pool: Pool, reps: int = REPS) -> float:
    """The unsorted 8-wide walk on the scene's wide tree rebuilt with
    max_leaf=8."""
    from ..scene import loader
    orig = loader.build_wide_bvh
    loader.build_wide_bvh = lambda tris: orig(tris, max_leaf=8)
    try:
        sc, _ = loader.load_scene(pool.path, pool.device, wide_tables=True)
    finally:
        loader.build_wide_bvh = orig
    return run_wide(pool, False, reps=reps, scene=sc)


def sweep(pool: Pool, mode: str = "all", reps: int = REPS,
          out=print) -> list:
    """Runs `mode`'s rows; prints each as it comes and returns [(label,
    ms)]."""
    rows = []

    def row(label, ms):
        rows.append((label, ms))
        out(f"{label:26s}{ms:10.3f} ms")

    prod = lambda: run_binned(pool, reps)
    if mode == "passes":
        for p in (2, 3, 4, 6, 8):
            row(f"binned passes={p}", run_binned(pool, reps, passes=p))
        with flags(FALLBACK=False):
            for p in (2, 4, 8):
                row(f"binned p={p} NOfb", run_binned(pool, reps, passes=p))
    elif mode == "prod":
        row("binned production", prod())
    elif mode in ("expand", "expand_nofb"):
        nofb = mode == "expand_nofb"
        with flags(**({"FALLBACK": False} if nofb else {})):
            for rep in range(2):
                tag = " NOfb" if nofb else ""
                row(f"sequential prod{tag} rep{rep}", prod())
                for k in ((2, 4, 6) if nofb else (2, 3, 4, 6)):
                    row(f"expand K={k}{tag} rep{rep}",
                        run_expand(pool, k, reps))
    elif mode == "slots":
        prod()        # warm-up: the first configuration of a process
        for rep in range(2):
            row(f"sequential prod rep{rep}", prod())
            for k in (3, 4, 6):
                row(f"slots K={k} rep{rep}", run_slots(pool, k, reps))
    elif mode == "tune":
        prod()
        for rep in range(2):
            row(f"prod rep{rep}", prod())
            with flags(FB_COMPACT=False):
                row(f"no fb-compact rep{rep}", prod())
            row(f"p3 rep{rep}", run_binned(pool, reps, passes=3))
            with flags(CAND_SORT=False):
                row(f"no cand-sort rep{rep}", prod())
    elif mode == "support":
        prod()
        for rep in range(2):
            for m in (1, 16, 64, 256):
                with flags(MIN_SUPPORT=m):
                    row(f"min_support={m} rep{rep}", prod())
    elif mode in ("gate", "uv"):
        flag = "CHUNK_GATE" if mode == "gate" else "STREAM_UV"
        for rep in range(2):
            for on in (True, False):
                with flags(**{flag: on}):
                    row(f"{mode}={on} rep{rep}", prod())
    elif mode == "layout":
        row("column sorts (prod)", prod())
        with flags(BIN_CONTIGUOUS=True):
            row("contiguous bins", prod())
    elif mode == "leaf":
        row("leaf96 rows16 (prod)", run_leaf(pool, 96, 16, reps))
        for ml, r in ((132, 22), (192, 32), (288, 48)):
            row(f"leaf{ml} rows{r}", run_leaf(pool, ml, r, reps))
        row("leaf96 rows16 (prod)", run_leaf(pool, 96, 16, reps))
    elif mode == "csplit":
        with flags(BIN_CONTIGUOUS=True, FALLBACK=False, STREAM_OFF=True):
            row("contig sorts+cull", prod())
        with flags(BIN_CONTIGUOUS=True, FALLBACK=False):
            row("contig + stream", prod())
        with flags(BIN_CONTIGUOUS=True):
            row("contig full", prod())
        row("columns full (ref)", prod())
    elif mode == "split":
        prod()
        row("full (warmup ref)", prod())
        with flags(FALLBACK=False, CULL_CHEAP=True, STREAM_OFF=True):
            row("sorts only", prod())
        with flags(FALLBACK=False, STREAM_OFF=True):
            row("+ cull", prod())
        with flags(FALLBACK=False):
            row("+ stream", prod())
        row("+ fallback (full)", prod())
    elif mode == "all":
        row("wide sorted", run_wide(pool, True, reps=reps))
        row("wide unsorted", run_wide(pool, False, reps=reps))
        row("wide unsorted +cull", run_wide(pool, False, cull=True,
                                            reps=reps))
        row("wide mask-stack", run_wide(pool, False, variant="mask",
                                        reps=reps))
        row("wide leaf8", run_wide_leaf8(pool, reps))
        for fb in ("packet", "wide"):
            row(f"binned fb={fb}", run_binned_fb(pool, fb, reps))
        row("sorted ch=65536", run_sorted(pool, 65536, reps))
    else:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.tools.sweep_mesh")
    ap.add_argument("scene", nargs="?", default=None,
                    help="scene JSON (default: the teapot)")
    ap.add_argument("mode", nargs="?", default="all", choices=MODES)
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    from ..scene.fixtures import scene_path
    device = resolve_device(args.device)
    path = args.scene or scene_path("teapot")
    overrides = {"RES": [args.res, args.res]} if args.res else None
    pool = make_pool(path, device, overrides,
                     wide_tables=args.mode in ("all",))
    print(f"{path}: {pool.o.x.shape[0]} bounce rays, "
          f"{float(pool.hit.float().mean()):.2f} live frac", flush=True)
    return sweep(pool, args.mode, args.reps,
                 out=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
