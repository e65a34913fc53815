"""Build, load and launch the hand-written CUDA kernels of csrc/.

The mesh-intersection kernels (csrc/cull.cu, stream.cu, packet.cu, wide.cu,
brute.cu) are compiled by nvcc into one shared library with a plain C
interface, loaded with ctypes. The library is built on first use, from the package's sources only,
into build/torch_kernels/ at the repo root; its file name carries a hash of
the sources and flags, so a changed source is rebuilt and a stale library is
never loaded.

`LAUNCHES` counts the launches of each kernel: a wrapper adds one where it
launches its kernel, and nowhere else, so a run can show which kernels its
main path went through.
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
SOURCES = ("cull.cu", "stream.cu", "packet.cu", "wide.cu", "brute.cu")
HEADERS = ("common.cuh",)
# -fmad=false and no fast math: each kernel matches its plain PyTorch version
# bit for bit (see csrc/common.cuh)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

LAUNCHES = {"cull": 0, "stream": 0, "packet": 0, "wide_push": 0,
            "wide_mask": 0, "brute": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # device, tables, table rows, 10 ray planes, 2 outputs, n, stream
    "pt_cull": [_I, _P, _P, _I] + [_P] * 10 + [_P, _P, _I, _P],
    # device, treelet_i, n_treelets, tris, tri rows, max_rows, 8 ray planes,
    # 5 outputs, n, stream
    "pt_stream": [_I, _P, _I, _P, _I, _I] + [_P] * 8 + [_P] * 5 + [_I, _P],
    # device, nodes_f, nodes_i, n_nodes, tris, root, 8 ray planes,
    # 5 outputs, n, stream
    "pt_packet": [_I, _P, _P, _I, _P, _I] + [_P] * 8 + [_P] * 5 + [_I, _P],
    # device, nodes8_f, nodes8_i, n_wide, tris8, n_groups, root, 8 ray
    # planes, cull, 5 outputs, n, stream
    "pt_wide_push": [_I, _P, _P, _I, _P, _I, _P] + [_P] * 8 + [_I]
                    + [_P] * 5 + [_I, _P],
    # the same without cull
    "pt_wide_mask": [_I, _P, _P, _I, _P, _I, _P] + [_P] * 8 + [_P] * 5
                    + [_I, _P],
    # device, coeffs, attrs, n_tris, 6 ray planes, 5 outputs, n, stream
    "pt_brute": [_I, _P, _P, _I] + [_P] * 6 + [_P] * 5 + [_I, _P],
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
    """Compile the library if it is missing. Returns (path, seconds, the
    compiler's output, which lists each kernel's registers and spills)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, path)
    return path, secs, res.stdout + res.stderr


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
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}, "
                         "expected one CUDA device")
    for key, t in tensors.items():
        want = torch.float32 if key.endswith("f32") else torch.int32
        if t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
        shape = tuple(t.shape)
        if key.startswith("ray_"):
            ok = shape == (n,)
        elif key.startswith("one_"):
            ok = shape == (1,)
        else:
            ok = len(shape) == 2 and shape[1] == cols and shape[0] > 0
        if not ok:
            raise ValueError(f"{name}: {key} has shape {shape}")
    return devices.pop()


def launch(name: str, device: torch.device, *args) -> None:
    """Call pt_<name> on `device`'s current stream and count the launch;
    raise on a CUDA error reported right after the launch."""
    fn = getattr(library(), "pt_" + name)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    err = fn(device.index, *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def hit_outputs(n: int, device: torch.device):
    """Empty (t, nx, ny, nz f32, mat i32) planes of n lanes, the outputs of
    every closest-hit kernel."""
    t = torch.empty(n, dtype=torch.float32, device=device)
    return (t, *(torch.empty_like(t) for _ in range(3)),
            torch.empty(n, dtype=torch.int32, device=device))


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
