"""Build, load and launch the hand-written CUDA kernels of csrc/.

The mesh-intersection kernels (csrc/cull.cu, stream.cu, packet.cu, wide.cu,
brute.cu), the analytic closest hit (csrc/analytic.cu, launched here by
`analytic`), shade (csrc/shade.cu, launched by `shade`) and the exclusive
scan (csrc/scan.cu) are compiled by nvcc, one
process a source, all started together, and linked into one shared library
with a plain C interface, loaded with ctypes. The library is built on first
use, from the package's sources only, into build/torch_kernels/ at the repo
root; its file name carries a hash of the sources and flags, so a changed
source is rebuilt and a stale library is never loaded.

`LAUNCHES` counts the calls of each kernel: a wrapper adds one where it
launches its kernel, and nowhere else, so a run can show which kernels its
main path went through. A call counts once whatever the number of device
kernels it launches: "packet", "wide_push" and "wide_mask" are each a
compaction kernel and a walk over the compacted lanes (csrc/packet.cu,
wide.cu), and the deferring stream is a support count and the stream.
The cull and the stream have several forms each, under one key each:
"cull" counts every K of the K-want cull and "stream" every form of the
stream. `FORMS` logs the form of each of their launches beside it:
"cull_k1" ... "cull_k8", and "stream_default" or "stream" followed by
"_uv", "_defer" and "_gate" for the flags a launch has on (e.g.
"stream_defer_gate"). `reset_counts()` zeroes both. A launch recorded into
a CUDA graph counts when the graph is replayed, not while it is captured:
the compiled frame (engine/wavefront.py) takes the counts its capture added
(`counts`, `counts_since`), puts the counts back as they were
(`restore_counts`), and adds them again on every replay (`add_counts`), so
the counts say what ran.

`KERNELS` is the one table of the port's launches: SOURCES, the entry
points' argument types, LAUNCHES, and the names and kinds that
utils/profiling.py reads the device kernels by are built from it. A new
kernel is its source, one entry there and its wrapper.

No kernel has a backward of its own. `with_twin` gives a launch the
gradients of its plain twin: the kernel runs forward, the backward runs
the twin again on the saved inputs (ops/bsdf.py `shade_lanes` and
ops/intersect.py `analytic_hit`). The others need none: as the Pallas
kernels have no AD rule in the JAX package, the mesh intersectors that
launch them return their hits as constants (ops/intersect.py
`_constant`), and the scan only reorders lanes on the forward-only engine
modes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(CSRC))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")
HEADERS = ("common.cuh",)
# -fmad=false and no fast math: each kernel matches its plain PyTorch version
# bit for bit (see csrc/common.cuh)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int


class Kernel(NamedTuple):
    """One launch of the port: its LAUNCHES key `name` (the C entry point
    pt_<name>), its source in csrc/, the entry's ctypes arguments, the
    device kernel it runs once a launch (by the name the profiler shows)
    and that kernel's kind (utils/profiling.py KINDS)."""

    name: str
    source: str
    argtypes: list
    device_kernel: str
    kind: str


KERNELS = (
    # device, tables, table rows, 10 ray planes, 2 outputs of k planes, n,
    # k, stream
    Kernel("cull", "cull.cu",
           [_I, _P, _P, _I] + [_P] * 10 + [_P, _P, _I, _I, _P],
           "cull_kernel", "cull kernel"),
    # device, treelet_i, n_treelets, tris, tri rows, max_rows, chunk table
    # (or null), uv, min_support, 8 ray planes, 5 outputs, inc (or null), n,
    # stream
    Kernel("stream", "stream.cu",
           [_I, _P, _I, _P, _I, _I, _P, _I, _I] + [_P] * 8 + [_P] * 5
           + [_P, _I, _P], "stream_kernel", "stream kernel"),
    # device, nodes_f, nodes_i, n_nodes, tris, root, 8 ray planes,
    # 5 outputs, scratch, smem_nodes, n, stream
    Kernel("packet", "packet.cu",
           [_I, _P, _P, _I, _P, _I] + [_P] * 8 + [_P] * 5 + [_P, _I, _I, _P],
           "packet_kernel_walk", "packet kernel"),
    # device, nodes8_c, n_wide, tris8, n_groups, root, 8 ray planes, cull,
    # 5 outputs, scratch, n, stream
    Kernel("wide_push", "wide.cu",
           [_I, _P, _I, _P, _I, _P] + [_P] * 8 + [_I] + [_P] * 5
           + [_P, _I, _P], "wide_push_kernel", "wide push kernel"),
    # the same without cull
    Kernel("wide_mask", "wide.cu",
           [_I, _P, _I, _P, _I, _P] + [_P] * 8 + [_P] * 5 + [_P, _I, _P],
           "wide_mask_kernel", "wide mask kernel"),
    # device, compact table, attrs, n_tris, 6 ray planes, 5 outputs, n,
    # stream
    Kernel("brute", "brute.cu",
           [_I, _P, _P, _I] + [_P] * 6 + [_P] * 5 + [_I, _P],
           "brute_kernel", "brute kernel"),
    # device, x, out, scratch, capacity, n, is_float, epoch, stream
    Kernel("scan", "scan.cu",
           [_I, _P, _P, _P, ctypes.c_longlong, _I, _I, ctypes.c_uint, _P],
           "scan_kernel", "scan kernel"),
    # device, gtype, material_id, inverse_transform, inv_transpose, n_geoms,
    # 6 ray planes, 6 outputs, n, stream
    Kernel("analytic", "analytic.cu",
           [_I, _P, _P, _P, _P, _I] + [_P] * 6 + [_P] * 6 + [_I, _P],
           "pt_analytic_hit", "analytic hit kernel"),
    # device, flags, 6 material tables, n_mats, 9 ray planes, rb, t,
    # 3 normal planes, mat, key (device, or null) and key (host), pixel,
    # 5 uniform planes, rr_on, 10 outputs, n, stream
    Kernel("shade", "shade.cu",
           [_I, _I] + [_P] * 6 + [_I] + [_P] * 9 + [_P] * 6
           + [_P, ctypes.c_uint, _P] + [_P] * 5 + [_I] + [_P] * 10 + [_I, _P],
           "pt_shade_lanes", "shade kernel"),
)
SOURCES = tuple(dict.fromkeys(k.source for k in KERNELS))
LAUNCHES = dict.fromkeys((k.name for k in KERNELS), 0)
FORMS: dict = {}
_ARGTYPES = {**{"pt_" + k.name: k.argtypes for k in KERNELS},
             # mask, cull: a walk block's dynamic shared memory in bytes
             "pt_wide_smem": [_I, _I]}

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libpt_kernels_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, float, str]:
    """Compile the library if it is missing: one nvcc a source, all at once,
    then one link. Returns (path, seconds, the compilers' output, which
    lists each kernel's registers, shared memory and spills)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [f"{tmp}.{s}.o" for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                               os.path.join(CSRC, s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [(s, p.returncode, out) for s, p, out in zip(SOURCES, procs, logs)
              if p.returncode != 0]
    if not failed:
        res = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                              f"{tmp}.so", *objs], capture_output=True,
                             text=True)
        logs.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(("link", res.returncode, res.stderr))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{s} ({rc}):\n{out}" for s, rc, out in failed))
    os.replace(f"{tmp}.so", path)
    return path, time.perf_counter() - t0, "".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(path)
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(name: str, n: int, cols: int = 128, **tensors) -> torch.device:
    """Raise unless every tensor is a contiguous tensor on one CUDA device,
    of the dtype its name ends in (_f32 / _i32), and of shape [n] for a ray
    plane (name starting with ray_), [1] for a single value (name starting
    with one_) or [rows, cols] with rows > 0 for a table. Returns the
    device."""
    device = None
    for key, t in tensors.items():
        if device is None:
            device = t.device
        if t.device != device or device.type != "cuda":
            devices = sorted({str(u.device) for u in tensors.values()})
            raise ValueError(f"{name}: tensors on {devices}, expected one "
                             "CUDA device")
        want = torch.float32 if key.endswith("f32") else torch.int32
        if t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
        shape = t.shape
        if key.startswith("ray_"):
            ok = shape == (n,)
        elif key.startswith("one_"):
            ok = shape == (1,)
        else:
            ok = len(shape) == 2 and shape[1] == cols and shape[0] > 0
        if not ok:
            raise ValueError(f"{name}: {key} has shape {tuple(shape)}")
    return device


def current_stream(device: torch.device) -> int:
    """The handle of `device`'s current CUDA stream."""
    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, device: torch.device, *args,
           stream: int | None = None, form: str | None = None) -> None:
    """Call pt_<name> on `stream` (default: `device`'s current stream) and
    count the launch, and its `form` in FORMS where given; raise on a CUDA
    error reported right after the launch."""
    fn = getattr(library(), "pt_" + name)
    if stream is None:
        stream = current_stream(device)
    err = fn(device.index, *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    if form is not None:
        FORMS[form] = FORMS.get(form, 0) + 1


def reset_counts() -> None:
    """Zero LAUNCHES and forget FORMS."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    FORMS.clear()


def counts() -> tuple[dict, dict]:
    """A copy of (LAUNCHES, FORMS)."""
    return dict(LAUNCHES), dict(FORMS)


def counts_since(before: tuple[dict, dict]) -> tuple[dict, dict]:
    """The launches and forms counted since `before` (a `counts()`), each
    that rose."""
    launches, forms = before
    return ({k: v - launches.get(k, 0) for k, v in LAUNCHES.items()
             if v != launches.get(k, 0)},
            {k: v - forms.get(k, 0) for k, v in FORMS.items()
             if v != forms.get(k, 0)})


def restore_counts(saved: tuple[dict, dict]) -> None:
    """Put LAUNCHES and FORMS back to `saved` (a `counts()`), in place."""
    launches, forms = saved
    LAUNCHES.update({k: launches.get(k, 0) for k in LAUNCHES})
    FORMS.clear()
    FORMS.update(forms)


def add_counts(launches: dict, forms: dict) -> None:
    """Count `launches` and `forms` once more (a graph replay's)."""
    for k, v in launches.items():
        LAUNCHES[k] += v
    for k, v in forms.items():
        FORMS[k] = FORMS.get(k, 0) + v


class _WithTwin(torch.autograd.Function):
    """Forward: the kernel. Backward: the plain twin run again on the saved
    inputs under autograd, and its gradients from the outputs that got one
    (an unused output's zeros would run its backward for nothing, and
    0 * inf there would give NaN)."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        want = [k for k in range(len(saved)) if ctx.needs_input_grad[k + 2]]
        xs = list(saved)
        for k in want:
            xs[k] = saved[k].detach().requires_grad_(True)
        with torch.enable_grad():
            pairs = [(y, g) for y, g in zip(ctx.plain(*xs), grads)
                     if g is not None and y.requires_grad]
            got = torch.autograd.grad(
                [y for y, _ in pairs], [xs[k] for k in want],
                [g for _, g in pairs], allow_unused=True) if pairs else ()
        result = [None] * len(saved)
        for k, g in zip(want, got):
            result[k] = g
        return (None, None, *result)


def with_twin(kernel, plain, *inputs):
    """kernel(*inputs), a tuple of tensors, with the gradients of its plain
    twin: plain(*inputs) gives the same outputs in autograd-recorded
    PyTorch, and the backward runs it again on the inputs. `inputs` are
    tensors or None; settings that are not tensors travel in the two
    callables. Integer and bool outputs carry no gradient."""
    return _WithTwin.apply(kernel, plain, *inputs)


def hit_outputs(n: int, device: torch.device):
    """Empty (t, nx, ny, nz f32, mat i32) planes of n lanes, the outputs of
    every closest-hit kernel."""
    t = torch.empty(n, dtype=torch.float32, device=device)
    return (t, *(torch.empty_like(t) for _ in range(3)),
            torch.empty(n, dtype=torch.int32, device=device))


def analytic(geoms, ox, oy, oz, dx, dy, dz):
    """csrc/analytic.cu on CUDA tensors: the closest hit over every box and
    sphere of `geoms` (GeomArrays; MESH rows skipped) for every lane, in
    one launch. Returns (t_best, FLT_MAX where no box or sphere is hit; nx,
    ny, nz, +0 there; material_id int32, 0 there; any_hit bool), the bits of
    ops/intersect.py analytic_plain."""
    n = ox.shape[0]
    dev = check("analytic", n, ray_ox_f32=ox, ray_oy_f32=oy, ray_oz_f32=oz,
                ray_dx_f32=dx, ray_dy_f32=dy, ray_dz_f32=dz)
    n_geoms = geoms.gtype.shape[0]
    mats = (geoms.inverse_transform, geoms.inv_transpose)
    if n_geoms:
        if any(tuple(m.shape) != (n_geoms, 4, 4) or not m.is_contiguous()
               for m in mats):
            raise ValueError("analytic: transforms must be contiguous "
                             "[G, 4, 4]")
        got = {check("analytic", n_geoms, cols=16,
                     inv_f32=mats[0].view(n_geoms, 16),
                     invt_f32=mats[1].view(n_geoms, 16)),
               check("analytic", n_geoms, cols=1,
                     gtype_i32=geoms.gtype.view(n_geoms, 1),
                     mat_i32=geoms.material_id.view(n_geoms, 1))}
        if got != {dev}:
            raise ValueError("analytic: geom tables and rays on different "
                             "devices")
        if any(m.data_ptr() % 16 for m in mats):
            raise ValueError("analytic: transforms must be 16-byte aligned "
                             "(the kernel reads their rows as float4)")
    t, nx, ny, nz, mat = hit_outputs(n, dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        p = ptr
        launch("analytic", dev, p(geoms.gtype), p(geoms.material_id),
               p(mats[0]), p(mats[1]), n_geoms, p(ox), p(oy), p(oz), p(dx),
               p(dy), p(dz), p(t), p(nx), p(ny), p(nz), p(mat), p(hit), n)
    return t, nx, ny, nz, mat, hit


# csrc/shade.cu stages the material table, 10 floats a material, in a block's
# shared memory, within the 48 KiB a launch may ask for without opting in
SHADE_MAX_MATERIALS = 48 * 1024 // 40
# the material tables csrc/shade.cu reads, in its entry's order
SHADE_TABLES = ("color", "specular_color", "has_reflective",
                "has_refractive", "ior", "emittance")
# csrc/shade.cu's template flags
SHADE_HASH, SHADE_GLOSSY, SHADE_REFRACTIVE, SHADE_RR, SHADE_QUIRK = (
    1, 2, 4, 8, 16)


def shade(origin, direction, color, remaining_bounces, t, normal, mat_id,
          materials, key=None, pixel=None, uniforms=None, *,
          any_glossy: bool = True, any_refractive: bool = True,
          rr: bool = False, rr_on: bool = False, depth_quirk: bool = False):
    """csrc/shade.cu on CUDA tensors: one bounce's draws, material fetch and
    scatter for every lane, in one launch; the bits of ops/bsdf.py shade
    given the same uniforms. The draws come from the fast hash, keyed by
    `key` (the depth's uint32 key: a host int, or a 0-d int64 tensor on the
    lanes' device that the kernel reads there) and `pixel` ([n] int64 pixel
    ids), or, with key None, from `uniforms` (4 [n] float32 planes, 5 with
    `rr`). `rr`: Russian roulette is on (rr_start > 0); `rr_on`: this
    bounce's depth reaches rr_start. origin, direction, color and normal
    are (x, y, z) planes. Returns the new (ox, oy, oz, dx, dy, dz, cx, cy,
    cz, remaining_bounces), each a new tensor; lanes with
    remaining_bounces <= 0 are copied through."""
    n = t.shape[0]
    planes = {f"ray_{g}{c}_f32": v for g, vec in
              (("o", origin), ("d", direction), ("c", color), ("n", normal))
              for c, v in zip("xyz", vec)}
    dev = check("shade", n, ray_rb_i32=remaining_bounces, ray_t_f32=t,
                ray_mat_i32=mat_id, **planes)
    m = materials.color.shape[0]
    if not 0 < m <= SHADE_MAX_MATERIALS:
        raise ValueError(f"shade: {m} materials, the kernel stages 1 to "
                         f"{SHADE_MAX_MATERIALS}")
    tables = tuple(getattr(materials, f) for f in SHADE_TABLES)
    got = check("shade", m, cols=3, color_f32=tables[0], spec_f32=tables[1])
    got2 = check("shade", m, cols=1,
                 **{f"{k}_f32": v.view(m, 1) for k, v in
                    zip(("refl", "refr", "ior", "emit"), tables[2:])})
    if {got, got2} != {dev}:
        raise ValueError("shade: material tables and lanes on different "
                         "devices")
    flags = ((SHADE_GLOSSY if any_glossy else 0)
             | (SHADE_REFRACTIVE if any_refractive else 0)
             | (SHADE_RR if rr else 0) | (SHADE_QUIRK if depth_quirk else 0))
    null = ctypes.c_void_p(None)
    key_dev, key_host, pix, u = null, 0, null, [null] * 5
    if key is not None:
        flags |= SHADE_HASH
        if pixel is None or pixel.dtype != torch.int64 or (
                pixel.shape != (n,)) or not pixel.is_contiguous() or (
                pixel.device != dev):
            raise ValueError("shade: pixel must be a contiguous [n] int64 "
                             "tensor on the lanes' device")
        pix = ptr(pixel)
        if isinstance(key, torch.Tensor):
            if key.dtype != torch.int64 or key.numel() != 1 or (
                    key.device != dev):
                raise ValueError("shade: a tensor key must be one int64 on "
                                 "the lanes' device")
            key_dev = ptr(key)
        else:
            key_host = int(key) & 0xFFFFFFFF
    else:
        want = 5 if rr else 4
        if uniforms is None or len(uniforms) != want:
            raise ValueError(f"shade: {want} uniform planes or a key")
        check("shade", n, **{f"ray_u{j}_f32": v
                             for j, v in enumerate(uniforms)})
        u[:want] = [ptr(v) for v in uniforms]
    outs = [torch.empty(n, dtype=torch.float32, device=dev)
            for _ in range(9)]
    outs.append(torch.empty(n, dtype=torch.int32, device=dev))
    if n:
        launch("shade", dev, flags, *(ptr(x) for x in tables), m,
               *(ptr(x) for x in (*origin, *direction, *color)),
               ptr(remaining_bounces), ptr(t), *(ptr(x) for x in normal),
               ptr(mat_id), key_dev, key_host, pix, *u, int(rr_on),
               *(ptr(x) for x in outs), n)
    return tuple(outs)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
