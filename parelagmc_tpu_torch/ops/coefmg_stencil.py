"""Launchers of the fused coefMG stencil kernels (csrc/coefmg_stencil.cu).

The structured coefMG cycle (ops/coef_multigrid_structured.py) runs its
grid passes through five functions - a Chebyshev sweep's first step and
its later steps, a damped Jacobi sweep, the residual with its restriction,
and the prolongation with its add. For CUDA tensors they land here: one
kernel launch each, on the current stream, into outputs allocated here
(so a capture into a CUDA graph records them as they run eagerly). CPU
tensors take the plain twins beside those functions.

Arguments are cell grids (batch..., z, y, x) - mesh axis a at array dim
ndim - 1 - a - and the face grids of the level (`dinv_axes`, n_a + 1
entries along axis a), all of one dtype (float32, float64 or bfloat16) on
one card. The batch may have up to two dims with any strides and
broadcasts (the stacked solve's state carries a singleton right-hand-side
axis against r's two vectors), so no state tensor is copied; the state's
grid dims must be contiguous, and a vector whose are not (the line
smoother's iterate, laid out as K1 returned it) is copied first. Anything
else raises.

Every launch adds one to `kernels.launch_counts` under `coefmg_smooth`,
`coefmg_restrict` or `coefmg_prolong`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from parelagmc_tpu_torch import kernels

# Smoothing modes of csrc/coefmg_stencil.cu.
FIRST, STEP, JACOBI = 0, 1, 2
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}


def _grid3(grid: Sequence[int]) -> Tuple[int, int, int]:
    """(nx, ny, nz) of an array-order grid (z, y, x), 1 for missing axes."""
    if not 1 <= len(grid) <= 3:
        raise ValueError(f"coefmg stencil: a {len(grid)}-D grid (1 to 3 axes)")
    g = (1,) * (3 - len(grid)) + tuple(int(n) for n in grid)
    return g[2], g[1], g[0]


def _dims(grid: Tuple[int, ...], batch: Tuple[int, ...],
          coarse: Tuple[int, ...] = ()) -> Tuple[int, ...]:
    """A C entry point's dims: nx, ny, nz, the inner batch count, the
    coarse grid's nx, ny, nz (transfers), the batch members."""
    b2 = (1,) * (2 - len(batch)) + batch
    return _grid3(grid) + (b2[1],) + (_grid3(coarse) if coarse else ()) + (b2[0] * b2[1],)


def _face_grid(grid: Tuple[int, ...], a: int) -> Tuple[int, ...]:
    f = list(grid)
    f[len(grid) - 1 - a] += 1
    return tuple(f)


def _batch(tensors, d: int) -> Tuple[int, ...]:
    """The broadcast batch of every tensor given (all but their last d
    dims). Worked out here: torch.broadcast_shapes imports
    torch.fx.experimental.symbolic_shapes at its first call, seconds of a
    solver's set-up."""
    shapes = [tuple(t.shape[:t.dim() - d]) for t in tensors if t is not None]
    n = max(len(s) for s in shapes)
    if n > 2:
        raise ValueError(f"coefmg stencil: a batch of {n} dims (at most two)")
    out = [1] * n
    for s in shapes:
        for i, m in enumerate(s, n - len(s)):
            if m != 1 and out[i] not in (1, m):
                raise ValueError(f"coefmg stencil: batches {shapes} do not broadcast")
            if m != 1:
                out[i] = m
    return tuple(out)


def _check(tensors, name: str) -> Tuple[torch.dtype, torch.device]:
    ts = [t for t in tensors if t is not None]
    dtype, device = ts[0].dtype, ts[0].device
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: unsupported dtype {dtype}")
    if device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs CUDA tensors, got {device}")
    for t in ts:
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"{name}: mixed tensors ({t.dtype} on {t.device}, "
                             f"{dtype} on {device})")
    return dtype, device


def _slot(t: Optional[torch.Tensor], inner: Tuple[int, ...], name: str) -> Tuple[int, int, int]:
    """(pointer, s0, s1) of t: its grid dims `inner` contiguous, the
    strides of its batch (right-aligned in two dims; 0 where it has size 1,
    so it broadcasts against the launch's batch)."""
    if t is None:
        return 0, 0, 0
    nb = t.dim() - len(inner)
    if tuple(t.shape[nb:]) != inner:
        raise ValueError(f"{name}: grid {tuple(t.shape[nb:])}, expected {inner}")
    stride = t.stride()
    want = 1
    for n, s in zip(reversed(inner), reversed(stride[nb:])):
        if n > 1 and s != want:
            raise ValueError(f"{name}: grid dims of strides {stride} are not contiguous")
        want *= n
    st = [0, 0]
    for i in range(nb):
        if t.shape[i] != 1:
            st[2 - nb + i] = stride[i]
    return t.data_ptr(), st[0], st[1]


def _launch(kernel: str, device, slots, dims, entry: str, *head, tail=()) -> None:
    """C entry point `entry`(*head, pointers, strides, dims, *tail, stream)
    on the current stream, counted under `kernel`."""
    ptrs = (ctypes.c_void_p * len(slots))(*(p or None for p, _, _ in slots))
    strides = (ctypes.c_int64 * (2 * len(slots)))(*(s for _, s0, s1 in slots for s in (s0, s1)))
    dims = (ctypes.c_int64 * len(dims))(*dims)
    fn = getattr(kernels.library(), entry)
    kernels.launch(kernel, device, fn, *head, ptrs, strides, dims, *tail)


def smooth(mode: int, dinv_axes, idiag: torch.Tensor, b: torch.Tensor,
           x: Optional[torch.Tensor] = None, dvec: Optional[torch.Tensor] = None,
           a: float = 0.0, c: float = 0.0, w: float = 0.0, last: bool = False):
    """One smoothing step on the kernel. FIRST: (r, dvec) with r = b - S x
    (b itself where x is None) and dvec = w idiag r. STEP (b is the
    sweep's r): (x + dvec, r - S dvec, a dvec + c idiag r'), or with `last`
    that x plus that dvec alone. JACOBI: x + w idiag (b - S x), or w idiag b
    where x is None."""
    d = len(dinv_axes)
    name = "coefmg_smooth"
    x, b, dvec = (None if t is None else t.contiguous() for t in (x, b, dvec))
    tensors = (x, b, dvec, idiag, *dinv_axes)
    dtype, device = _check(tensors, name)
    grid = tuple(b.shape[b.dim() - d:])
    batch = _batch(tensors, d)
    out = lambda: torch.empty(batch + grid, dtype=dtype, device=device)
    xo = out() if mode != FIRST else None
    ro = out() if (mode == FIRST and x is not None) or (mode == STEP and not last) else None
    do = out() if mode == FIRST or (mode == STEP and not last) else None
    faces = [_slot(f, _face_grid(grid, a_), name) for a_, f in enumerate(dinv_axes)]
    faces += [(0, 0, 0)] * (3 - d)
    slots = [_slot(t, grid, name) for t in (x, b, dvec, idiag)] + faces + [
        _slot(t, grid, name) for t in (xo, ro, do)]
    if (do if mode == FIRST else xo).numel() > 0:
        scal = (ctypes.c_double * 3)(a, c, w)
        _launch(name, device, slots, _dims(grid, batch), f"coefmg_smooth_{_SUFFIX[dtype]}",
                int(mode), int(last), tail=(scal,))
    if mode == FIRST:
        return (b if x is None else ro), do
    if mode == STEP and not last:
        return xo, ro, do
    return xo


def residual_restrict(dinv_axes, b: torch.Tensor, x: torch.Tensor, fine: Sequence[int],
                      coarse: Sequence[int]) -> torch.Tensor:
    """The group sums of b - S x over each cell of the coarse grid (mesh
    shapes `fine` -> `coarse`, x first; equal shapes: the residual)."""
    d = len(dinv_axes)
    name = "coefmg_restrict"
    x, b = x.contiguous(), b.contiguous()
    tensors = (x, b, *dinv_axes)
    dtype, device = _check(tensors, name)
    grid, cgrid = tuple(int(n) for n in fine[::-1]), tuple(int(n) for n in coarse[::-1])
    batch = _batch(tensors, d)
    rc = torch.empty(batch + cgrid, dtype=dtype, device=device)
    slots = [_slot(t, grid, name) for t in (x, b)]
    slots += [_slot(f, _face_grid(grid, a_), name) for a_, f in enumerate(dinv_axes)]
    slots += [(0, 0, 0)] * (3 - d) + [_slot(rc, cgrid, name)]
    if rc.numel() > 0:
        _launch(name, device, slots, _dims(grid, batch, cgrid), f"coefmg_restrict_{_SUFFIX[dtype]}")
    return rc


def prolong_add(x: torch.Tensor, xc: torch.Tensor, fine: Sequence[int],
                coarse: Sequence[int]) -> torch.Tensor:
    """x plus each fine cell's coarse value of xc (mesh shapes `fine`,
    `coarse`, x first)."""
    name = "coefmg_prolong"
    x, xc = x.contiguous(), xc.contiguous()
    dtype, device = _check((x, xc), name)
    grid, cgrid = tuple(int(n) for n in fine[::-1]), tuple(int(n) for n in coarse[::-1])
    d = len(grid)
    batch = _batch((x, xc), d)
    xo = torch.empty(batch + grid, dtype=dtype, device=device)
    slots = [_slot(x, grid, name), _slot(xc, cgrid, name), _slot(xo, grid, name)]
    if xo.numel() > 0:
        _launch(name, device, slots, _dims(grid, batch, cgrid), f"coefmg_prolong_{_SUFFIX[dtype]}")
    return xo
