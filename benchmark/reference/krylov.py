"""The reference's iterative Darcy solve for levels too large for a sparse
LU: plain PyTorch in float64, a block of samples at a time.

CG on the pressure Schur complement S(w) = B M(w)^{-1} B^T, with M(w)^{-1}
exact: M(w) is block diagonal by axis and tridiagonal along each grid
line, so every line's matrix is formed densely and inverted once per
solve. The preconditioner is one V-cycle of a plain aggregation multigrid
on the lumped Schur complement S_L = B D(w)^{-1} B^T (D the row sums of
M(w)), which bounds S spectrally within a factor 3 on every block: cell
aggregates of 2 x 2 x 2 (a trailing odd cell joins the last aggregate),
Galerkin coarse operators, Chebyshev-Jacobi smoothing of degree 3, a
dense inverse (by Cholesky) on the coarsest aggregate grid. CG stops once every
sample's relative residual is under `rtol`; Q is then the flux
functional of u = M(w)^{-1} (f - B^T p).

Each sample of a block has its own M(w), S_L and multigrid levels; their
sparsity patterns depend on the grid alone, so they are formed once per
level, and the values of a block's samples are index sums on the device.
With `storage="bfloat16"` every stored operator value and every vector
the iteration updates is rounded to bfloat16 (the arithmetic stays
wide): the solve in the precision below float32 that reaches it, for
the control.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import scipy.sparse as sp
import torch

from .mixed import DarcyLevel, Level, coarsen_lines, parent_1d

# Device memory a block's line inverses may take.
BLOCK_BYTES = 16 * 2 ** 30


def _rounder(storage: str):
    if storage == "float64":
        return lambda x: x
    if storage == "bfloat16":
        return lambda x: x.to(torch.bfloat16).to(torch.float64)
    raise ValueError(f"storage {storage!r}")


class Pattern:
    """A sparsity pattern (row-major), its values per sample (k, nnz)."""

    def __init__(self, rows: np.ndarray, cols: np.ndarray, n: int, device):
        self.n = n
        self.rows_np, self.cols_np = rows, cols
        self.rows = torch.as_tensor(rows, device=device)
        self.cols = torch.as_tensor(cols, device=device)
        self.diag = torch.as_tensor(np.nonzero(rows == cols)[0], device=device)

    def matvec(self, data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(x).index_add_(1, self.rows, data * x[:, self.cols])


def _unique_pairs(rows: np.ndarray, cols: np.ndarray, n: int):
    """(rows, cols) of the distinct pairs, row-major, and each input pair's
    position among them."""
    uniq, inv = np.unique(rows.astype(np.int64) * n + cols, return_inverse=True)
    return uniq // n, uniq % n, inv.reshape(-1)


class LevelStructure:
    """What a level's solve takes from the grid alone: B, the pattern of
    S_L with the face products that form its values, and the aggregation
    multigrid's parents and coarse patterns."""

    def __init__(self, dl: DarcyLevel, device, coarse_max: int = 3000):
        lvl = dl.lvl
        self.device = device
        self.active = np.zeros(lvl.n_u, dtype=bool)
        self.active[dl.active] = True
        Bfull = (lvl.b_matrix() @ sp.diags(self.active.astype(np.float64))).tocsr()
        Bfull.eliminate_zeros()
        self.B = _csr(Bfull, device)
        self.Bt = _csr(Bfull.T.tocsr(), device)
        # S_L[r, c] = sum over faces f of B[r, f] B[c, f] / D_f.
        Bf = Bfull.T.tocsr()  # faces x cells
        counts = np.diff(Bf.indptr)
        face = np.repeat(np.arange(lvl.n_u), counts)
        rep = counts[face]
        first = np.repeat(np.cumsum(rep) - rep, rep)
        i = np.repeat(np.arange(face.size), rep)
        j = Bf.indptr[face[i]] + (np.arange(i.size) - first)
        r, c, pos = _unique_pairs(Bf.indices[i], Bf.indices[j], lvl.n_s)
        self.sl = Pattern(r, c, lvl.n_s, device)
        self.sl_pos = torch.as_tensor(pos, device=device)
        self.sl_face = torch.as_tensor(face[i], device=device)
        self.sl_val = torch.as_tensor(Bf.data[i] * Bf.data[j], device=device)
        # Aggregation levels: parent of each cell, coarse pattern, and where
        # each fine value sums to.
        self.patterns: List[Pattern] = [self.sl]
        self.parents: List[torch.Tensor] = []
        self.to_coarse: List[torch.Tensor] = []
        pat, axes = self.sl, lvl.axes
        while pat.n > coarse_max and not all(a.size <= 2 for a in axes):
            caxes = [coarsen_lines(a) for a in axes]
            par = np.zeros([a.size - 1 for a in axes][::-1], dtype=np.int64)
            stride = 1
            for k, (fa, ca) in enumerate(zip(axes, caxes)):
                shape = [1] * len(axes)
                shape[len(axes) - 1 - k] = -1
                par = par + parent_1d(fa, ca).reshape(shape) * stride
                stride *= ca.size - 1
            par = par.reshape(-1)
            r, c, pos = _unique_pairs(par[pat.rows_np], par[pat.cols_np], stride)
            self.parents.append(torch.as_tensor(par, device=device))
            self.to_coarse.append(torch.as_tensor(pos, device=device))
            pat = Pattern(r, c, stride, device)
            self.patterns.append(pat)
            axes = caxes


class LineMass:
    """M(w)^{-1} of a block of samples on the full face vector, inactive
    faces held at zero."""

    def __init__(self, lvl: Level, blocks, w: np.ndarray, active: np.ndarray, device, rnd):
        bll, blr, brr = blocks
        d = lvl.d
        cells = np.arange(lvl.n_s).reshape(lvl.shape[::-1])
        t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=device)
        W = t(w)  # (k, n_s)
        self.rnd = rnd
        self.axes = []
        for a in range(d):
            dim = d - 1 - a
            fid = lvl.face_off[a] + np.arange(int(np.prod(lvl.face_shape[a]))).reshape(
                lvl.face_shape[a])
            faces = np.moveaxis(fid, dim, -1).reshape(-1, lvl.shape[a] + 1)  # (L, n_f)
            cl = np.moveaxis(cells, dim, -1).reshape(-1, lvl.shape[a])  # (L, n_c)
            act = t(active[faces].astype(np.float64))
            n_f = lvl.shape[a] + 1
            Tinv = torch.empty((W.shape[0],) + faces.shape + (n_f,), dtype=torch.float64,
                               device=device)
            rowsum = torch.empty((W.shape[0],) + faces.shape, dtype=torch.float64,
                                 device=device)
            cl_t = torch.as_tensor(cl, device=device)
            base = [t(blk[cl, a]) for blk in (bll, blr, brr)]
            for s in range(W.shape[0]):
                wl = W[s][cl_t]
                dll, dlr, drr = (b * wl for b in base)
                diag = torch.zeros(cl.shape[0], n_f, dtype=torch.float64, device=device)
                diag[:, :-1] += dll
                diag[:, 1:] += drr
                # Inactive faces: identity rows, decoupled.
                diag = diag * act + (1.0 - act)
                off = dlr * act[:, :-1] * act[:, 1:]
                T = torch.diag_embed(diag) + torch.diag_embed(off, 1) + torch.diag_embed(off, -1)
                rowsum[s] = T.sum(dim=-1) * act + (1.0 - act)
                Tinv[s] = rnd(torch.linalg.inv(T))
                del T
            self.axes.append((torch.as_tensor(faces, device=device), Tinv, act, rowsum))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """(k, n_u) -> (k, n_u)."""
        out = torch.zeros_like(x)
        for faces, Tinv, act, _ in self.axes:
            v = x[:, faces] * act
            out[:, faces] = torch.matmul(Tinv, v.unsqueeze(-1)).squeeze(-1) * act
        return self.rnd(out)

    def lumped(self, n_u: int) -> torch.Tensor:
        """Row sums of M(w) on the active faces (1 elsewhere), (k, n_u)."""
        k = self.axes[0][1].shape[0]
        out = torch.ones(k, n_u, dtype=torch.float64, device=self.axes[0][1].device)
        for faces, _, _, rowsum in self.axes:
            out[:, faces] = rowsum
        return out


def _csr(m: sp.spmatrix, device) -> torch.Tensor:
    m = m.tocsr()
    return torch.sparse_csr_tensor(torch.as_tensor(m.indptr, dtype=torch.int64),
                                   torch.as_tensor(m.indices, dtype=torch.int64),
                                   torch.as_tensor(m.data, dtype=torch.float64),
                                   size=m.shape).to(device)


class AggregationMG:
    """V-cycle of the aggregation multigrid of a block's S_L values."""

    def __init__(self, st: LevelStructure, data: torch.Tensor, rnd, degree: int = 3):
        self.st, self.degree, self.rnd = st, degree, rnd
        self.data, self.dinv, self.lmax = [], [], []
        k = data.shape[0]
        for lev, pat in enumerate(st.patterns):
            self.data.append(rnd(data))
            dinv = 1.0 / data[:, pat.diag]
            self.dinv.append(dinv)
            self.lmax.append(self._lmax(pat, self.data[-1], dinv))
            if lev < len(st.parents):
                nxt = st.patterns[lev + 1]
                data = torch.zeros(k, nxt.rows.numel(), dtype=torch.float64,
                                   device=data.device).index_add_(1, st.to_coarse[lev], data)
        pat = st.patterns[-1]
        A = torch.zeros(k, pat.n, pat.n, dtype=torch.float64, device=data.device)
        A[:, pat.rows, pat.cols] = data
        self.coarse_inv = rnd(torch.cholesky_inverse(torch.linalg.cholesky(A)))

    @staticmethod
    def _lmax(pat: Pattern, data, dinv, iters: int = 15) -> torch.Tensor:
        dev = data.device
        x = torch.rand(pat.n, dtype=torch.float64, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
        x = x.expand(data.shape[0], -1).contiguous()
        lam = torch.ones(data.shape[0], 1, dtype=torch.float64, device=dev)
        for _ in range(iters):
            y = dinv * pat.matvec(data, x)
            lam = torch.linalg.vector_norm(y, dim=1, keepdim=True) / torch.linalg.vector_norm(
                x, dim=1, keepdim=True)
            x = y / torch.linalg.vector_norm(y, dim=1, keepdim=True)
        return 1.1 * lam

    def _smooth(self, lev: int, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Chebyshev iteration of `degree` steps on D^{-1} A over
        [lmax / 10, lmax], per sample."""
        pat, A, dinv, lmax = self.st.patterns[lev], self.data[lev], self.dinv[lev], self.lmax[lev]
        lo, hi = lmax / 10.0, lmax
        theta, delta = 0.5 * (hi + lo), 0.5 * (hi - lo)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = dinv * (b - pat.matvec(A, x))
        dvec = r / theta
        for _ in range(self.degree):
            x = self.rnd(x + dvec)
            r = r - dinv * pat.matvec(A, dvec)
            rho_new = 1.0 / (2.0 * sigma - rho)
            dvec = rho_new * rho * dvec + 2.0 * rho_new / delta * r
            rho = rho_new
        return x

    def cycle(self, b: torch.Tensor, lev: int = 0) -> torch.Tensor:
        st = self.st
        if lev == len(st.parents):
            return self.rnd(torch.matmul(self.coarse_inv, b.unsqueeze(-1)).squeeze(-1))
        x = self._smooth(lev, torch.zeros_like(b), b)
        r = b - st.patterns[lev].matvec(self.data[lev], x)
        par = st.parents[lev]
        rc = torch.zeros(b.shape[0], st.patterns[lev + 1].n, dtype=b.dtype,
                         device=b.device).index_add_(1, par, r)
        x = x + self.cycle(rc, lev + 1)[:, par]
        return self._smooth(lev, x, b)


def structure(dl: DarcyLevel, device) -> LevelStructure:
    """The level's structure on `device`, formed at its first solve."""
    cache: Dict[str, LevelStructure] = dl.__dict__.setdefault("_krylov", {})
    if str(device) not in cache:
        cache[str(device)] = LevelStructure(dl, device)
    return cache[str(device)]


def block_rows(lvl: Level) -> int:
    """Samples a block takes: as many as their line inverses fit into
    BLOCK_BYTES."""
    per = sum(8 * int(np.prod(fs)) // (lvl.shape[a] + 1) * (lvl.shape[a] + 1) ** 2
              for a, fs in enumerate(lvl.face_shape))
    return max(1, BLOCK_BYTES // per)


def solve(dl: DarcyLevel, w: np.ndarray, device, rtol: float = 1e-10,
          max_iters: int = 2000, storage: str = "float64") -> np.ndarray:
    """Q of each row of w (k, n_s) on a level, by MG-preconditioned CG, a
    block of rows at a time."""
    w = np.atleast_2d(np.asarray(w, dtype=np.float64))
    step = block_rows(dl.lvl)
    return np.concatenate([_solve_block(dl, w[i:i + step], device, rtol, max_iters, storage)
                           for i in range(0, w.shape[0], step)])


def _solve_block(dl, w, device, rtol, max_iters, storage) -> np.ndarray:
    lvl = dl.lvl
    rnd = _rounder(storage)
    st = structure(dl, device)
    mass = LineMass(lvl, dl.blocks, w, st.active, device, rnd)
    k = w.shape[0]
    inv_d = torch.where(torch.as_tensor(st.active, device=device),
                        1.0 / mass.lumped(lvl.n_u), torch.zeros((), dtype=torch.float64,
                                                                device=device))
    sl = torch.zeros(k, st.sl.rows.numel(), dtype=torch.float64, device=device).index_add_(
        1, st.sl_pos, st.sl_val * inv_d[:, st.sl_face])
    mg = AggregationMG(st, sl, rnd)
    act = torch.as_tensor(dl.active, device=device)
    f = torch.zeros(lvl.n_u, dtype=torch.float64, device=device)
    f[act] = torch.as_tensor(dl.f, device=device)
    c = torch.zeros_like(f)
    c[act] = torch.as_tensor(dl.c, device=device)
    f = f.expand(k, -1)
    Bm = lambda u: rnd((st.B @ u.T).T)  # (k, n_u) -> (k, n_s)
    Btm = lambda p: (st.Bt @ p.T).T  # (k, n_s) -> (k, n_u)
    S = lambda p: Bm(mass.apply(Btm(p)))
    dot = lambda a, b: (a * b).sum(dim=1, keepdim=True)
    b = Bm(mass.apply(f))
    p = torch.zeros_like(b)
    r = b.clone()
    z = mg.cycle(r)
    d = z.clone()
    rz = dot(r, z)
    bnorm = torch.linalg.vector_norm(b, dim=1, keepdim=True)
    done = torch.zeros(k, 1, dtype=torch.bool, device=device)
    for _ in range(max_iters):
        Sd = S(d)
        alpha = torch.where(done, 0.0, rz / dot(d, Sd))
        p = rnd(p + alpha * d)
        r = rnd(r - alpha * Sd)
        done = done | (torch.linalg.vector_norm(r, dim=1, keepdim=True) / bnorm < rtol)
        if bool(done.all()):
            break
        z = mg.cycle(r)
        rz_new = dot(r, z)
        d = torch.where(done, 0.0, rnd(z + (rz_new / rz) * d))
        rz = torch.where(done, rz, rz_new)
    u = mass.apply(f - Btm(p))
    return (u @ c).cpu().numpy()
