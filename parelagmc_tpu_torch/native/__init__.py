"""ctypes bindings for the native geometry kernels (geometry.cc).

Port of parelagmc_tpu/native/__init__.py with its own copy of geometry.cc.
The shared library is compiled with `g++ -O3 -march=native` on first use,
never at import, into `parelagmc_tpu_torch/_build/` (listed in .gitignore)
under a name keyed by a hash of the source and the flags, so that
`-march=native` resolves on the machine that runs it and an edited source
rebuilds. Each build writes a temporary name and renames it into place, so
concurrent builds (pytest-xdist workers) never load a partial library. A
failed build raises. This module exposes:

* mortar_p0_couple(mesh1, mesh2)                -> scipy CSR coupling matrix
* mortar_moments(mesh1, mesh2)                  -> per-pair volume and moments
* detect_intersections_bruteforce(mesh1, mesh2) -> candidate pairs (oracle)
* element_measure(mesh, e)                      -> |element| via the clipper
* mesh_arrays(StructuredMesh)                   -> (verts, conn) in the
  native layout (MFEM-convention local vertex ordering)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "geometry.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_LIB = None


def library_path() -> str:
    """_build/libgeometry_<tag>.so, tag = hash of the source and the flags."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgeometry_{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile geometry.cc with g++ unless its library exists; returns the
    library's path."""
    so_path = library_path()
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, _SRC, "-o", tmp]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError("g++ failed building the native geometry library:\n"
                           + " ".join(cmd) + "\n" + proc.stdout)
    os.replace(tmp, so_path)
    return so_path


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_library())
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.mortar_p0_couple.restype = ctypes.c_int64
        lib.mortar_p0_couple.argtypes = [
            f64p, i64p, ctypes.c_int64, f64p, i64p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
            i64p, i64p, f64p, ctypes.c_int64,
        ]
        lib.mortar_moments_couple.restype = ctypes.c_int64
        lib.mortar_moments_couple.argtypes = [
            f64p, i64p, ctypes.c_int64, f64p, i64p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
            i64p, i64p, f64p, f64p, f64p, ctypes.c_int64,
        ]
        lib.detect_intersections_bruteforce.restype = ctypes.c_int64
        lib.detect_intersections_bruteforce.argtypes = [
            f64p, i64p, ctypes.c_int64, f64p, i64p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
            i64p, i64p, ctypes.c_int64,
        ]
        lib.element_measure.restype = ctypes.c_double
        lib.element_measure.argtypes = [
            f64p, i64p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_double,
        ]
        _LIB = lib
    return _LIB


def mesh_arrays(mesh) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices, connectivity) of a StructuredMesh in the native layout:
    vertices (nv, dim) float64, connectivity (ne, 2^dim) int64 with
    MFEM-convention local ordering."""
    d = mesh.dim
    grids = np.meshgrid(*mesh.axes, indexing="ij")
    verts = np.ascontiguousarray(
        np.stack([g.ravel(order="F") for g in grids], axis=1)
    )
    nvshape = tuple(s + 1 for s in mesh.shape)

    def vid(*ijk):
        out = 0
        stride = 1
        for a, s in enumerate(nvshape):
            out = out + np.asarray(ijk[a], dtype=np.int64) * stride
            stride *= s
        return out

    idx = mesh.cell_multi_index()
    if d == 3:
        i, j, k = idx
        conn = np.stack(
            [
                vid(i, j, k), vid(i + 1, j, k), vid(i + 1, j + 1, k), vid(i, j + 1, k),
                vid(i, j, k + 1), vid(i + 1, j, k + 1), vid(i + 1, j + 1, k + 1),
                vid(i, j + 1, k + 1),
            ],
            axis=1,
        )
    elif d == 2:
        i, j = idx
        conn = np.stack(
            [vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)], axis=1
        )
    else:
        raise ValueError("1D not supported")
    return verts, np.ascontiguousarray(conn, dtype=np.int64)


def _as_arrays(mesh):
    """(verts, conn) for a StructuredMesh, GeneralMesh, or raw pair."""
    if isinstance(mesh, tuple):
        v, c = mesh
        return np.ascontiguousarray(v, dtype=np.float64), np.ascontiguousarray(
            c, dtype=np.int64
        )
    if hasattr(mesh, "elements"):  # GeneralMesh (single element type)
        conn = np.stack(mesh.elements)
        return (
            np.ascontiguousarray(mesh.vertices, dtype=np.float64),
            np.ascontiguousarray(conn, dtype=np.int64),
        )
    return mesh_arrays(mesh)


def mortar_p0_couple(mesh1, mesh2, tol: float = 1e-12):
    """Native-assembled P0 mortar coupling G[i, j] = |K_i^1 cap K_j^2| as a
    scipy CSR matrix, for any pair of convex planar-faced cell meshes
    (mixed pairs too: tets against hexes). Accepts StructuredMesh,
    mfem_io.GeneralMesh, or raw (vertices, connectivity) pairs."""
    import scipy.sparse as sp

    v1, c1 = _as_arrays(mesh1)
    v2, c2 = _as_arrays(mesh2)
    dim = v1.shape[1]
    cap = max(16 * max(c1.shape[0], c2.shape[0]), 1024)
    lib = _lib()
    while True:
        out_i = np.empty(cap, dtype=np.int64)
        out_j = np.empty(cap, dtype=np.int64)
        out_v = np.empty(cap, dtype=np.float64)
        n = lib.mortar_p0_couple(
            v1, c1, c1.shape[0], v2, c2, c2.shape[0],
            c1.shape[1], c2.shape[1], dim, tol,
            out_i, out_j, out_v, cap,
        )
        if n >= 0:
            break
        cap = -n + 16
    return sp.csr_matrix(
        (out_v[:n], (out_i[:n], out_j[:n])),
        shape=(c1.shape[0], c2.shape[0]),
    )


def mortar_moments(mesh1, mesh2, tol: float = 1e-12):
    """Per intersected pair: (i, j, volume, first moments (dim,), second
    moments (dim*(dim+1)/2,)). The moment table is enough to assemble any
    mortar integral of products of affine factors (transfer_integrators.py:
    the P1 and RT0 assemblers)."""
    v1, c1 = _as_arrays(mesh1)
    v2, c2 = _as_arrays(mesh2)
    dim = v1.shape[1]
    nm2 = 6 if dim == 3 else 3
    cap = max(16 * max(c1.shape[0], c2.shape[0]), 1024)
    lib = _lib()
    while True:
        out_i = np.empty(cap, dtype=np.int64)
        out_j = np.empty(cap, dtype=np.int64)
        out_v = np.empty(cap, dtype=np.float64)
        out_m1 = np.empty(cap * dim, dtype=np.float64)
        out_m2 = np.empty(cap * nm2, dtype=np.float64)
        n = lib.mortar_moments_couple(
            v1, c1, c1.shape[0], v2, c2, c2.shape[0],
            c1.shape[1], c2.shape[1], dim, tol,
            out_i, out_j, out_v, out_m1, out_m2, cap,
        )
        if n >= 0:
            break
        cap = -n + 16
    return (
        out_i[:n].copy(),
        out_j[:n].copy(),
        out_v[:n].copy(),
        out_m1[: n * dim].reshape(n, dim).copy(),
        out_m2[: n * nm2].reshape(n, nm2).copy(),
    )


def detect_intersections_bruteforce(mesh1, mesh2, tol: float = 1e-12):
    """All (i, j) cell pairs of two StructuredMeshes that intersect, by the
    O(n^2) broad phase (the oracle of the hash grid)."""
    v1, c1 = mesh_arrays(mesh1)
    v2, c2 = mesh_arrays(mesh2)
    dim = v1.shape[1]
    nv = c1.shape[1]
    cap = max(64 * max(c1.shape[0], c2.shape[0]), 1024)
    lib = _lib()
    while True:
        out_i = np.empty(cap, dtype=np.int64)
        out_j = np.empty(cap, dtype=np.int64)
        n = lib.detect_intersections_bruteforce(
            v1, c1, c1.shape[0], v2, c2, c2.shape[0], nv, dim, tol,
            out_i, out_j, cap,
        )
        if n >= 0:
            break
        cap = -n + 16
    return out_i[:n].copy(), out_j[:n].copy()


def element_measure(mesh, e: int, tol: float = 1e-12) -> float:
    """|element e| of a StructuredMesh through the native clipper."""
    v, c = mesh_arrays(mesh)
    return float(_lib().element_measure(v, c, c.shape[1], v.shape[1], e, tol))
