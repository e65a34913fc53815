"""Build, load and launch the hand-written CUDA kernels of csrc/.

The mesh-intersection kernels (csrc/cull.cu, stream.cu, packet.cu, wide.cu,
brute.cu), the analytic closest hit (csrc/analytic.cu, launched here by
`analytic`) and the exclusive scan (csrc/scan.cu) are compiled by nvcc, one
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

No kernel has a backward, and none needs an autograd.Function: as the
Pallas kernels have no AD rule in the JAX package, the mesh intersectors
that launch them return their hits as constants
(ops/intersect.py `_constant`), the analytic closest hit runs its plain
version wherever autograd records through the rays or the geom tables
(ops/intersect.py `analytic_route`), and the scan only reorders lanes on
the forward-only engine modes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(CSRC))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")
SOURCES = ("cull.cu", "stream.cu", "packet.cu", "wide.cu", "brute.cu",
           "scan.cu", "analytic.cu")
HEADERS = ("common.cuh",)
# -fmad=false and no fast math: each kernel matches its plain PyTorch version
# bit for bit (see csrc/common.cuh)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"cull": 0, "stream": 0, "packet": 0, "wide_push": 0,
            "wide_mask": 0, "brute": 0, "scan": 0, "analytic": 0}
FORMS: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # device, tables, table rows, 10 ray planes, 2 outputs of k planes, n,
    # k, stream
    "pt_cull": [_I, _P, _P, _I] + [_P] * 10 + [_P, _P, _I, _I, _P],
    # device, treelet_i, n_treelets, tris, tri rows, max_rows, chunk table
    # (or null), uv, min_support, 8 ray planes, 5 outputs, inc (or null), n,
    # stream
    "pt_stream": [_I, _P, _I, _P, _I, _I, _P, _I, _I] + [_P] * 8 + [_P] * 5
                 + [_P, _I, _P],
    # device, nodes_f, nodes_i, n_nodes, tris, root, 8 ray planes,
    # 5 outputs, scratch, smem_nodes, n, stream
    "pt_packet": [_I, _P, _P, _I, _P, _I] + [_P] * 8 + [_P] * 5
                 + [_P, _I, _I, _P],
    # device, nodes8_c, n_wide, tris8, n_groups, root, 8 ray planes, cull,
    # 5 outputs, scratch, n, stream
    "pt_wide_push": [_I, _P, _I, _P, _I, _P] + [_P] * 8 + [_I] + [_P] * 5
                    + [_P, _I, _P],
    # the same without cull
    "pt_wide_mask": [_I, _P, _I, _P, _I, _P] + [_P] * 8 + [_P] * 5
                    + [_P, _I, _P],
    # mask, cull: a walk block's dynamic shared memory in bytes
    "pt_wide_smem": [_I, _I],
    # device, compact table, attrs, n_tris, 6 ray planes, 5 outputs, n,
    # stream
    "pt_brute": [_I, _P, _P, _I] + [_P] * 6 + [_P] * 5 + [_I, _P],
    # device, x, out, scratch, capacity, n, is_float, epoch, stream
    "pt_scan": [_I, _P, _P, _P, ctypes.c_longlong, _I, _I, ctypes.c_uint,
                _P],
    # device, gtype, material_id, inverse_transform, inv_transpose, n_geoms,
    # 6 ray planes, 6 outputs, n, stream
    "pt_analytic": [_I, _P, _P, _P, _P, _I] + [_P] * 6 + [_P] * 6
                   + [_I, _P],
}

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


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
