"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled at first use with its own nvcc process, all of them
started together, into a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds), and loaded with ctypes. The
libraries land in `parelagmc_tpu_torch/_build/` (listed in .gitignore)
under names keyed by a hash of the source and the compiler flags, so an
edited source rebuilds and an unchanged one loads the cached file - the
same scheme as parelagmc_tpu/native/__init__.py uses for its g++ geometry
kernels.

Nothing here runs at import time: the CPU-only test host has no nvcc, and
the kernel wrappers only ask for the library when they are handed a CUDA
tensor. A failed build raises; no wrapper falls back to its plain version
for a CUDA tensor.

Launch counts: every wrapper adds one to `launch_counts[name]` right where
it launches its kernel, so a run can show that its main path went through
the kernels (chip_smoke.py resets the counts before each path it drives -
the golden MLMC run, the SPE10 anchor, the full-grid SPE10 run, the K3
entry point - and reads them after). A launch recorded into a CUDA graph
runs nothing at capture: the graphed coefMG cycle
(ops/coef_multigrid_structured.GraphedVCycle) takes its capture's
additions back and adds them again at every replay, so the counts stay
the launches the device ran. The dict is the tracer's `kernel` counter
group (utils/trace.py), so a batch span records them as
`kernel.<name>`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import types
from typing import Dict, List, Optional

import torch

from parelagmc_tpu_torch.utils import trace

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("thomas.cu", "threefry_normal.cu", "coefmg_stencil.cu")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

launch_counts: Dict[str, int] = trace.counters(
    "kernel", ("thomas", "threefry_normal", "threefry_uniform", "coefmg_smooth",
               "coefmg_restrict", "coefmg_prolong"))

_LIB: Optional[types.SimpleNamespace] = None
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


def library_path(source: str) -> str:
    """_build/lib<stem>_<tag>.so for one source, tag = hash of the source
    and the flags."""
    h = hashlib.sha256()
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build_library() -> List[str]:
    """Compile every csrc/*.cu whose library is missing, one nvcc process
    per source, all started together; returns the libraries' paths. Each
    writes to a temporary name and renames, so a concurrent or interrupted
    build never leaves a partial library under the final name."""
    global build_seconds
    paths = [library_path(s) for s in SOURCES]
    todo = [(s, p) for s, p in zip(SOURCES, paths) if not os.path.exists(p)]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = []
    for src, so_path in todo:
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)]
        procs.append((cmd, tmp, so_path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for cmd, tmp, so_path, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(" ".join(cmd) + "\n" + out)
        else:
            os.replace(tmp, so_path)
    if errors:
        raise RuntimeError("nvcc failed building the parelagmc_tpu_torch kernels:\n"
                           + "\n".join(errors))
    build_seconds = time.perf_counter() - t0
    return paths


def library() -> types.SimpleNamespace:
    """The kernels' C entry points, by name (built on first call)."""
    global _LIB
    if _LIB is None:
        thomas, threefry, stencil = (ctypes.CDLL(p) for p in build_library())
        vp, i32, i64, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
        fns = {}
        # int thomas_lines_{f32,f64,bf16}(dl, d, du, b, x, n, L, J, O, sO, sB,
        #     sI, base, R, sR, sBb, stream)
        for name in ("thomas_lines_f32", "thomas_lines_f64", "thomas_lines_bf16"):
            fn = getattr(thomas, name)
            fn.restype = i32
            fn.argtypes = [vp, vp, vp, vp, vp, i32, i64, i64, i64, i64, i64, i64, i64, i32, i64,
                           i64, vp]
            fns[name] = fn
        # int threefry_normal_{f32,f64}(k0, k1, out, n, lo, scale, sqrt2, stream)
        for name, ct in (("threefry_normal_f32", ctypes.c_float),
                         ("threefry_normal_f64", ctypes.c_double)):
            fn = getattr(threefry, name)
            fn.restype = i32
            fn.argtypes = [u32, u32, vp, i64, ct, ct, ct, vp]
            fns[name] = fn
        # int threefry_{bits32,bits64,uniform_f32,uniform_f64}(k0, k1, out, n, stream)
        for name in ("threefry_bits32", "threefry_bits64",
                     "threefry_uniform_f32", "threefry_uniform_f64"):
            fn = getattr(threefry, name)
            fn.restype = i32
            fn.argtypes = [u32, u32, vp, i64, vp]
            fns[name] = fn
        # int coefmg_smooth_{f32,f64,bf16}(mode, last, ptrs, strides, dims,
        #     scal, stream); int coefmg_{restrict,prolong}_*(ptrs, strides,
        #     dims, stream): arrays of pointers, int64 and double.
        pp, p64, pd = ctypes.POINTER(vp), ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_double)
        for sfx in ("f32", "f64", "bf16"):
            for name, args in ((f"coefmg_smooth_{sfx}", [i32, i32, pp, p64, p64, pd, vp]),
                               (f"coefmg_restrict_{sfx}", [pp, p64, p64, vp]),
                               (f"coefmg_prolong_{sfx}", [pp, p64, p64, vp])):
                fn = getattr(stencil, name)
                fn.restype = i32
                fn.argtypes = args
                fns[name] = fn
        _LIB = types.SimpleNamespace(**fns)
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
