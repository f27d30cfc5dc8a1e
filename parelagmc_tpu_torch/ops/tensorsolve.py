"""Tensor-product fast direct solver for the mixed RT0/P0 Schur complement.

Port of parelagmc_tpu/ops/tensorsolve.py (see its docstring for the
mathematics). On an axis-aligned tensor mesh

    S^{-1} = W^{-1/2} (x)V_a  diag(alpha + sum L_a)^{-1}  (x)V_a^T  W^{-1/2},

so applying S^{-1} is per-axis dense matmuls plus one diagonal scale. The
spectral factors are built on the host in numpy (the 1D eigenproblems are
tiny) and held as the buffers of a `TensorEig` module; the per-axis
products are plain `torch.matmul` (cuBLAS on the card). float32 products
must run in full float32: callers on the card keep
`torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default), since a
truncated product gave a false Krylov floor on the TPU.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from parelagmc_tpu_torch.device import resolve_device
from parelagmc_tpu_torch.mesh.structured import StructuredMesh, _mfem_bdr_attr


class TensorEig(nn.Module):
    """Spectral factors of the cell-space Schur complement: per-axis
    eigenvectors V_a (n_a, n_a), the modal eigenvalue grid `lam` stored
    (n_d, ..., n_1) with x last, and sqrt cell volumes `w_sqrt` (n_s,)."""

    def __init__(self, V: Sequence[torch.Tensor], lam: torch.Tensor,
                 w_sqrt: torch.Tensor, shape: Tuple[int, ...]):
        super().__init__()
        self.shape = tuple(int(s) for s in shape)
        for a, v in enumerate(V):
            self.register_buffer(f"V{a}", v)
        self.register_buffer("lam", lam)
        self.register_buffer("w_sqrt", w_sqrt)

    @property
    def V(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"V{a}") for a in range(len(self.shape)))


def axis_schur_1d(h: np.ndarray, keep_lo: bool, keep_hi: bool) -> np.ndarray:
    """Dense 1D cell-space Schur stiffness K = d t^{-1} d^T for one axis
    (h: cell widths; keep_lo/keep_hi: whether the end faces carry a dof,
    False = essential u.n = 0, eliminated)."""
    n = h.size
    faces = []  # kept 1D faces 0..n (face i sits left of cell i)
    if keep_lo:
        faces.append(0)
    faces.extend(range(1, n))
    if keep_hi:
        faces.append(n)
    nf = len(faces)
    if nf == 0:
        return np.zeros((n, n))
    # 1D RT0 face mass: t[f,f] = sum of h/3 over adjacent cells, h/6 for
    # the two faces of one cell; d is the signed cell-face difference.
    t = np.zeros((nf, nf))
    d = np.zeros((n, nf))
    pos = {f: k for k, f in enumerate(faces)}
    for i in range(n):
        lo, hi = i, i + 1
        if lo in pos:
            t[pos[lo], pos[lo]] += h[i] / 3.0
            d[i, pos[lo]] = -1.0
        if hi in pos:
            t[pos[hi], pos[hi]] += h[i] / 3.0
            d[i, pos[hi]] = +1.0
        if lo in pos and hi in pos:
            t[pos[lo], pos[hi]] += h[i] / 6.0
            t[pos[hi], pos[lo]] += h[i] / 6.0
    return d @ np.linalg.solve(t, d.T)


def _eig_factors(K: np.ndarray, h: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(eigvals, eigvecs) of H = h^{-1/2} K h^{-1/2}."""
    hs = 1.0 / np.sqrt(h)
    H = hs[:, None] * K * hs[None, :]
    H = 0.5 * (H + H.T)
    lam, V = np.linalg.eigh(H)
    return np.maximum(lam, 0.0), V


def build_tensor_solver(
    mesh: StructuredMesh,
    alpha: float,
    ess_attr: Optional[Sequence[int]] = None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> TensorEig:
    """Spectral factors of S = B M^{-1} B^T + alpha W on `mesh`. ess_attr
    follows the MFEM per-boundary-attribute 0/1 convention; None makes
    every boundary velocity dof essential (the SPDE sampler's setup).
    `device` None means cuda:0."""
    device = resolve_device(device)
    d = mesh.dim

    def side_is_ess(axis: int, side: int) -> bool:
        if ess_attr is None:
            return True
        return bool(ess_attr[_mfem_bdr_attr(d, axis, side) - 1] == 1)

    lams: List[np.ndarray] = []
    Vs: List[np.ndarray] = []
    for a in range(d):
        h = np.diff(mesh.axes[a])
        K = axis_schur_1d(h, keep_lo=not side_is_ess(a, 0),
                          keep_hi=not side_is_ess(a, 1))
        lam, V = _eig_factors(K, h)
        lams.append(lam)
        Vs.append(V)
    shape = mesh.shape
    lam_full = np.zeros(shape[::-1], dtype=np.float64) + float(alpha)
    for a in range(d):
        bshape = [1] * d
        bshape[d - 1 - a] = shape[a]
        lam_full = lam_full + lams[a].reshape(bshape)
    as_t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                                     device=device)
    return TensorEig(
        V=[as_t(V) for V in Vs],
        lam=as_t(lam_full),
        w_sqrt=as_t(np.sqrt(mesh.cell_volumes())),
        shape=shape,
    )


def tensor_marginal_std(eig: TensorEig, g: float) -> np.ndarray:
    """Exact per-cell marginal std of the SPDE field s = S^{-1}(g W^{1/2}
    xi), on the host from the spectral factors (see the reference's
    tensor_marginal_std)."""
    d = len(eig.shape)
    lam = eig.lam.detach().cpu().double().numpy()
    z = 1.0 / lam ** 2
    for a in range(d):
        dim = z.ndim - 1 - a
        V2 = eig.V[a].detach().cpu().double().numpy() ** 2
        z = np.moveaxis(np.moveaxis(z, dim, -1) @ V2.T, -1, dim)
    w = eig.w_sqrt.detach().cpu().double().numpy() ** 2
    return g * np.sqrt(np.maximum(z.reshape(-1), 0.0) / w)


def _transform(x: torch.Tensor, mats: Sequence[torch.Tensor], shape,
               transpose: bool) -> torch.Tensor:
    """Apply the per-axis transforms to (..., n_s) x-fastest cell vectors
    (reshaped to (..., n_d, ..., n_1) so mesh axis 0 is the last dim)."""
    d = len(shape)
    batch = x.shape[:-1]
    z = x.reshape(batch + tuple(shape[::-1]))
    for a in range(d):
        dim = z.ndim - 1 - a
        M = mats[a].T if transpose else mats[a]
        z = torch.matmul(z.movedim(dim, -1), M).movedim(-1, dim)
    return z.reshape(batch + (int(np.prod(shape)),))


def tensor_solve(eig: TensorEig, b: torch.Tensor) -> torch.Tensor:
    """s = S^{-1} b for (..., n_s) right-hand sides."""
    V = eig.V
    z = b / eig.w_sqrt
    z = _transform(z, V, eig.shape, transpose=False)  # V^T along each axis
    z = z / eig.lam.reshape(-1)
    z = _transform(z, V, eig.shape, transpose=True)  # V along each axis
    return z / eig.w_sqrt


def tensor_sample(eig: TensorEig, xi: torch.Tensor, scale: float) -> torch.Tensor:
    """s = scale * W^{-1/2} V diag(1/lam) V^T xi: the SPDE sampler's field
    for white noise xi, the closed form of S^{-1}(scale * W^{1/2} xi)."""
    V = eig.V
    z = _transform(xi, V, eig.shape, transpose=False)
    z = z / eig.lam.reshape(-1)
    z = _transform(z, V, eig.shape, transpose=True)
    return scale * z / eig.w_sqrt
