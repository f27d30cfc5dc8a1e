"""Geometric multigrid V-cycle preconditioner on static ELL operators.

Port of parelagmc_tpu/ops/multigrid.py (see its docstring): per-level
operators A_l, damped-Jacobi or tridiagonal line smoothing (symmetric: the
same sweeps before and after, the line directions reversed after, so the
V-cycle is an SPD operator and a valid CG preconditioner), and a dense
coarsest-level inverse applied as a matmul, or Jacobi sweeps there. The
Darcy solver builds it on the static Schur complement S_bar of a kinv_ref
("cg-schur" with a kinv_ref, physics/darcy._build_schur_mg).

The host build functions are numpy/scipy copies of the reference's, down
to the seeded power iterations, so every damping factor equals the
reference's.
The device side differs in one place: the reference's line update runs its
Thomas scan on (nlines, m) tables; here the tables are held solved axis
first, (m, nlines), the layout kernel K1 reads coalesced, and one launch
solves the whole batch against the one static table set
(ops/tridiag_pallas.thomas with R = batch right-hand sides; thomas_plain
on the CPU). `perm` gathers a cell vector into that (m, nlines) order.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from parelagmc_tpu_torch.device import resolve_device
from parelagmc_tpu_torch.ops.ell import ELL, ell_apply, pack_csr_to_ell
from parelagmc_tpu_torch.ops.tridiag_pallas import thomas


class LineSmoother(nn.Module):
    """Tridiagonal block-Jacobi ("line relaxation") data along one grid
    axis: the m-row systems of all nlines lines, solved axis first."""

    def __init__(self, dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                 perm: torch.Tensor, iperm: torch.Tensor, omega: float):
        super().__init__()
        self.register_buffer("dl", dl)  # (m, nlines) sub-diagonal, first row 0
        self.register_buffer("d", d)  # (m, nlines) line diagonal
        self.register_buffer("du", du)  # (m, nlines) super-diagonal, last row 0
        self.register_buffer("perm", perm)  # (n,) int64: row-major (m, nlines) gather order
        self.register_buffer("iperm", iperm)  # (n,) int64: inverse permutation
        self.omega = float(omega)  # damping of the block-Jacobi update


class MGLevel(nn.Module):
    """Operator of one level plus the transfers to the next coarser one."""

    def __init__(self, A: ELL, inv_diag: torch.Tensor, P: ELL, Pt: ELL,
                 line: Optional[Sequence[LineSmoother]] = None):
        super().__init__()
        self.A = A
        self.register_buffer("inv_diag", inv_diag)  # (n,)
        self.P = P  # prolongation from the next level
        self.Pt = Pt  # restriction to it
        self.line = nn.ModuleList(line) if line else None  # line smoothers, ADI order


class MGHierarchy(nn.Module):
    def __init__(self, levels: Sequence[MGLevel], coarse_A: ELL, coarse_inv: torch.Tensor,
                 omega: float, coarse_inv_diag: torch.Tensor, coarse_sweeps: int):
        super().__init__()
        self.levels = nn.ModuleList(levels)
        self.coarse_A = coarse_A
        self.register_buffer("coarse_inv", coarse_inv)  # (nc, nc) dense inverse ((0, 0) if unused)
        self.omega = float(omega)
        self.register_buffer("coarse_inv_diag", coarse_inv_diag)  # (nc,) Jacobi at the coarsest
        self.coarse_sweeps = int(coarse_sweeps)  # 0: dense solve; else Jacobi sweeps


# -- host construction --------------------------------------------------------


def _spectral_omega(A, dinv: np.ndarray, iters: int = 30) -> float:
    """1 / lambda_max(D^{-1} A) by host power iteration: the damped-Jacobi
    smoother is then a contraction, hence the V-cycle SPD."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.shape[0])
    lam = 1.0
    for _ in range(iters):
        y = dinv * (A @ x)
        lam = float(np.linalg.norm(y))
        if lam <= 0:
            return 1.0
        x = y / lam
    return 1.0 / (1.05 * lam)  # small safety margin


def _host_thomas(dl, d, du, b):
    """Vectorized host Thomas solve over (nlines, m) systems (no pivoting;
    SPD diagonally dominant lines)."""
    m = d.shape[1]
    c = np.zeros_like(d)
    g = np.zeros_like(b)
    c[:, 0] = du[:, 0] / d[:, 0]
    g[:, 0] = b[:, 0] / d[:, 0]
    for i in range(1, m):
        den = d[:, i] - dl[:, i] * c[:, i - 1]
        c[:, i] = du[:, i] / den
        g[:, i] = (b[:, i] - dl[:, i] * g[:, i - 1]) / den
    x = np.zeros_like(b)
    x[:, -1] = g[:, -1]
    for i in range(m - 2, -1, -1):
        x[:, i] = g[:, i] - c[:, i] * x[:, i + 1]
    return x


def _line_data_for_axis(A, dims, strides, axis, dtype, device):
    """Tridiagonal line systems along one grid axis (x-fastest layout). The
    damping comes from the reference's power iteration on its (nlines, m)
    tables; the device tables are their transposes."""
    n = A.shape[0]
    m = dims[axis]
    s = strides[axis]
    idx = np.arange(n).reshape(tuple(dims[::-1]))  # (z, y, x), x fastest
    nd = len(dims)
    ax_rev = nd - 1 - axis  # position of `axis` in the reversed layout
    order = [i for i in range(nd) if i != ax_rev] + [ax_rev]
    perm = idx.transpose(order).reshape(-1, m)
    d_flat = np.asarray(A.diagonal())
    du_full = np.zeros(n)
    du_full[: n - s] = A.diagonal(s)
    dl_full = np.zeros(n)
    dl_full[s:] = A.diagonal(-s)
    d = np.where(d_flat == 0.0, 1.0, d_flat)[perm]
    du = du_full[perm]
    dl = dl_full[perm]
    du[:, -1] = 0.0
    dl[:, 0] = 0.0
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm.reshape(-1)] = np.arange(n)
    # Damping: 1/lambda_max(T^{-1} A) by host power iteration.
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n)
    lam = 1.0
    for _ in range(30):
        y = A @ x
        y = _host_thomas(dl, d, du, y.reshape(-1)[perm.reshape(-1)].reshape(perm.shape))
        y = y.reshape(-1)[iperm]
        lam = float(np.linalg.norm(y))
        if lam <= 0:
            return None
        x = y / lam
    omega = 1.0 / (1.05 * max(lam, 1.0))
    return line_smoother_from_host(dl, d, du, perm, omega, dtype, device)


def line_smoother_from_host(dl, d, du, perm, omega: float, dtype, device) -> LineSmoother:
    """The device LineSmoother of host (nlines, m) tables and their
    line-major gather order `perm` ((nlines, m) or flat): everything
    transposed to the solved-axis-first (m, nlines) layout."""
    nlines, m = d.shape
    perm_t = np.ascontiguousarray(np.asarray(perm).reshape(nlines, m).T).reshape(-1)
    iperm_t = np.empty(perm_t.size, dtype=np.int64)
    iperm_t[perm_t] = np.arange(perm_t.size)
    tab = lambda t: torch.as_tensor(np.ascontiguousarray(np.asarray(t).T), dtype=dtype,
                                    device=device)
    idx = lambda t: torch.as_tensor(t.astype(np.int64), device=device)
    return LineSmoother(tab(dl), tab(d), tab(du), idx(perm_t), idx(iperm_t), omega)


def _build_line_smoother(A, shape, dtype, device):
    """Tridiagonal line relaxation along every STRONGLY coupled grid axis
    of a structured-grid operator (x-fastest flattening, shape = (nx, ny,
    nz)): an axis engages when its mean |off-diagonal| is >= 3x the weakest
    axis's. Returns a list of LineSmoother, or None (isotropic grids keep
    point Jacobi)."""
    A = A.tocsr()
    dims = [s for s in shape]
    strides = [1]
    for s in dims[:-1]:
        strides.append(strides[-1] * s)
    band_mag = []
    for a in range(len(dims)):
        if dims[a] < 2:
            band_mag.append(0.0)
            continue
        band = A.diagonal(strides[a])
        band_mag.append(float(np.mean(np.abs(band))) if band.size else 0.0)
    lo = min(b for b in band_mag if b > 0) if any(b > 0 for b in band_mag) else 0.0
    if lo <= 0:
        return None
    axes = [a for a in range(len(dims)) if band_mag[a] >= 3.0 * lo]
    if not axes:
        return None
    lines = [ln for ln in (_line_data_for_axis(A, dims, strides, a, dtype, device)
                           for a in axes) if ln is not None]
    return lines or None


def build_mg_hierarchy(
    mats,  # list of scipy sparse per level, [0] = finest
    prolongators,  # list of scipy sparse, P[l]: level l+1 -> level l
    dtype: torch.dtype = torch.float32,
    omega=0.7,  # float, or "spectral" for per-level 1/lambda_max damping
    coarse_sweeps: int = 0,  # 0: dense coarsest inverse; >0: Jacobi sweeps
    line_shapes=None,  # per-level (nx, ny, ...) shapes: line smoothing along
    # the strongly coupled axes of anisotropic structured grids
    device=None,
) -> MGHierarchy:
    """The device hierarchy on `device` (None: cuda:0)."""
    device = resolve_device(device)
    spectral = omega == "spectral"
    vec = lambda v: torch.as_tensor(np.ascontiguousarray(v), dtype=dtype, device=device)
    levels = []
    for l in range(len(mats) - 1):
        A = mats[l].tocsr()
        d = np.asarray(A.diagonal())
        d = np.where(d == 0.0, 1.0, d)
        dinv = 1.0 / d
        if spectral:
            # Fold the per-level damping into inv_diag (global omega = 1).
            dinv = dinv * _spectral_omega(A, dinv)
        line = None
        if line_shapes is not None:
            line = _build_line_smoother(A, line_shapes[l], dtype, device)
        P = prolongators[l].tocsr()
        levels.append(MGLevel(
            A=pack_csr_to_ell(A, dtype, device=device),
            inv_diag=vec(dinv),
            P=pack_csr_to_ell(P, dtype, device=device),
            Pt=pack_csr_to_ell(P.T.tocsr(), dtype, device=device),
            line=line,
        ))
    Ac = mats[-1].tocsr()
    coarse_inv = np.zeros((0, 0)) if coarse_sweeps > 0 else np.linalg.inv(Ac.toarray())
    dc = np.asarray(Ac.diagonal())
    dc = np.where(dc == 0.0, 1.0, dc)
    dcinv = 1.0 / dc
    if spectral and coarse_sweeps > 0:
        dcinv = dcinv * _spectral_omega(Ac, dcinv)
    return MGHierarchy(
        levels=levels,
        coarse_A=pack_csr_to_ell(Ac, dtype, device=device),
        coarse_inv=vec(coarse_inv),
        omega=1.0 if spectral else omega,
        coarse_inv_diag=vec(dcinv),
        coarse_sweeps=int(coarse_sweeps),
    )


# -- device apply -------------------------------------------------------------


def _line_update(ln: LineSmoother, x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """x + omega T^{-1} r: every vector of the batch is one right-hand side
    of the static (m, nlines) tables - one K1 launch for CUDA tensors."""
    rl = torch.index_select(r, -1, ln.perm).reshape((-1,) + tuple(ln.d.shape))
    z = thomas(ln.dl, ln.d, ln.du, rl).reshape(r.shape)
    return x + ln.omega * torch.index_select(z, -1, ln.iperm)


def _smooth(level: MGLevel, x: torch.Tensor, b: torch.Tensor, sweeps: int, omega: float,
            reverse: bool = False) -> torch.Tensor:
    lines = level.line
    if lines is not None and reverse:
        # Post-smoothing applies the line directions in reverse order so
        # the whole V-cycle is a symmetric (SPD) operator.
        lines = list(reversed(lines))
    for _ in range(sweeps):
        if lines is not None:
            # Damped tridiagonal block-Jacobi along each strong axis
            # (alternating direction).
            for ln in lines:
                r = b - ell_apply(level.A, x)
                x = _line_update(ln, x, r)
        else:
            r = b - ell_apply(level.A, x)
            x = x + omega * level.inv_diag * r
    return x


def v_cycle(mg: MGHierarchy, b: torch.Tensor, sweeps: int = 2, level: int = 0) -> torch.Tensor:
    """One V(sweeps, sweeps) cycle applied to b (zero initial guess)."""
    if level == len(mg.levels):
        if mg.coarse_sweeps > 0:
            x = mg.omega * mg.coarse_inv_diag * b
            for _ in range(mg.coarse_sweeps - 1):
                x = x + mg.omega * mg.coarse_inv_diag * (b - ell_apply(mg.coarse_A, x))
            return x
        # Coarsest: dense solve as a matmul.
        return b @ mg.coarse_inv.T
    lvl = mg.levels[level]
    x = _smooth(lvl, torch.zeros_like(b), b, sweeps, mg.omega)
    r = b - ell_apply(lvl.A, x)
    rc = ell_apply(lvl.Pt, r)
    xc = v_cycle(mg, rc, sweeps, level + 1)
    x = x + ell_apply(lvl.P, xc)
    return _smooth(lvl, x, b, sweeps, mg.omega, reverse=True)


def make_preconditioner(mg: MGHierarchy, sweeps: int = 2) -> Callable:
    def prec(r: torch.Tensor) -> torch.Tensor:
        return v_cycle(mg, r, sweeps=sweeps)

    return prec
