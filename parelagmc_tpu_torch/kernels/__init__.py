"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled at first use with nvcc into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds),
and loaded with ctypes. The library lands in `parelagmc_tpu_torch/_build/`
(listed in .gitignore) under a name keyed by a hash of the sources and the
compiler flags, so an edited source rebuilds and an unchanged one loads
the cached file - the same scheme as parelagmc_tpu/native/__init__.py uses
for its g++ geometry kernels.

Nothing here runs at import time: the CPU-only test host has no nvcc, and
the kernel wrappers only ask for the library when they are handed a CUDA
tensor. A failed build raises; no wrapper falls back to its plain version
for a CUDA tensor.

Launch counts: every wrapper adds one to `launch_counts[name]` right where
it launches its kernel, so a run can show that its main path went through
the kernels (chip_smoke.py resets the counts before each path it drives -
the golden MLMC run, the SPE10 anchor, the full-grid SPE10 run, the K3
entry point - and reads them after).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("thomas.cu", "threefry_normal.cu")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

launch_counts: Dict[str, int] = {"thomas": 0, "threefry_normal": 0, "threefry_uniform": 0}

_LIB: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # nvcc wall time of this process's build


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of parelagmc_tpu_torch cannot be built"
    )


def _source_tag() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_library() -> str:
    """Compile csrc/*.cu into _build/libparelagmc_kernels_<tag>.so unless
    that file exists; returns its path. Writes to a temporary name and
    renames, so a concurrent or interrupted build never leaves a partial
    library under the final name."""
    global build_seconds
    tag = _source_tag()
    so_path = os.path.join(BUILD_DIR, f"libparelagmc_kernels_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp] + [
        os.path.join(CSRC_DIR, s) for s in SOURCES
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            "nvcc failed building the parelagmc_tpu_torch kernels:\n"
            + " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        )
    os.replace(tmp, so_path)
    build_seconds = time.perf_counter() - t0
    return so_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_library())
        vp, i32, i64, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
        # int thomas_solve_{f32,f64}(dl, d, du, b, x, c, n, L, stream)
        for fn in (lib.thomas_solve_f32, lib.thomas_solve_f64):
            fn.restype = i32
            fn.argtypes = [vp, vp, vp, vp, vp, vp, i32, i64, vp]
        # int thomas_solve_bf16(dl, d, du, b, x, c, g, n, L, stream)
        lib.thomas_solve_bf16.restype = i32
        lib.thomas_solve_bf16.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32, i64, vp]
        # int threefry_{normal_f32,normal_f64,bits32,bits64}(k0, k1, out, n,
        #     lo, scale, sqrt2, stream) - lo/scale/sqrt2 ignored for bits
        lib.threefry_normal_f32.restype = i32
        lib.threefry_normal_f32.argtypes = [
            u32, u32, vp, i64, ctypes.c_float, ctypes.c_float, ctypes.c_float, vp,
        ]
        lib.threefry_normal_f64.restype = i32
        lib.threefry_normal_f64.argtypes = [
            u32, u32, vp, i64, ctypes.c_double, ctypes.c_double, ctypes.c_double, vp,
        ]
        # int threefry_{bits32,bits64,uniform_f32,uniform_f64}(k0, k1, out, n, stream)
        for fn in (lib.threefry_bits32, lib.threefry_bits64,
                   lib.threefry_uniform_f32, lib.threefry_uniform_f64):
            fn.restype = i32
            fn.argtypes = [u32, u32, vp, i64, vp]
        _LIB = lib
    return _LIB


def launch(name: str, device: torch.device, fn, *args) -> None:
    """Launch kernel `name` through the C entry point `fn(*args, stream)`
    on `device` and its current PyTorch stream, count the launch, and raise
    on the cudaError_t the entry point returns (cudaGetLastError right
    after the launch)."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    launch_counts[name] += 1
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError_t {err}")
