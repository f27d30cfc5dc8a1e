"""Plain reference of the Bayesian likelihood of pressure observations at
wells: observation functionals, the observation data y, and per sample the
log-likelihood and the QoI.

Written from the mathematics of the configuration's `bayes` block alone:

* Functionals: g_i on the finest level's cells is the cell volume where the
  cell centre lies within `eps` (max-norm) of well i, zero elsewhere; the
  wells' coordinates are given on the original axes and relabelled with the
  grid (`axis_order`). A coarser level's g_i sums the finer level's into
  each coarse cell (the transpose of the piecewise-constant prolongation).
  Each is normalised to sum 1, so G_i = <g_i, p> is the mean pressure
  around well i.
* Pressure: the physical pressure p of the Darcy solve, minus the cell
  unknown of reference/mixed.py's saddle system, by a sparse LU on small
  levels and by reference/krylov.py's float64 CG (rtol 1e-10) above.
* Data: y = G(u_ref) + sqrt(noise) eta, u_ref the level-0 field of row 0
  of a one-sample draw keyed PRNGKey(data_key), eta the three float64
  normals keyed fold_in(that key, 1) (reference/threefry.py).
* Likelihood: log Pi = -|G - y|^2 / (2 noise).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import krylov, threefry
from .mixed import DarcyLevel, Precision, restrict_sum
from .problem import ReferenceProblem

# Levels of up to this many unknowns are solved by a sparse LU.
DIRECT_MAX = 50_000


class ReferenceBayes:
    """The reference problem of a configuration and its observations."""

    def __init__(self, spec: dict, kinv: Optional[np.ndarray] = None):
        self.problem = ReferenceProblem(spec, kinv=kinv)
        b = spec["bayes"]
        self.noise = float(b["noise"])
        self.data_key = threefry.prng_key(int(b["data_key"]))
        order = self.problem.order
        wells = np.asarray(b["wells_ft"], dtype=np.float64).reshape(-1, len(order))
        wells = wells[:, order]
        levels = self.problem.levels
        fine = levels[0]
        centres = np.meshgrid(*[0.5 * (a[1:] + a[:-1]) for a in fine.axes[::-1]],
                              indexing="ij")[::-1]
        centres = np.stack([c.reshape(-1) for c in centres], axis=1)  # x fastest
        g = np.zeros((wells.shape[0], fine.n_s))
        for i, xw in enumerate(wells):
            near = np.abs(centres - xw[None, :]).max(axis=1) <= float(b["eps_ft"])
            if not near.any():
                raise ValueError(f"no cell within eps of well {i}")
            g[i] = np.where(near, fine.vol, 0.0)
        self.g = [g]
        for l in range(len(levels) - 1):
            self.g.append(restrict_sum(self.g[-1], levels[l], levels[l + 1]))
        self.g = [gl / gl.sum(axis=1, keepdims=True) for gl in self.g]

    def observations(self, solve: Callable, prec: Precision) -> np.ndarray:
        """y = G(u_ref) + sqrt(noise) eta; solve(darcy_level, w) -> (Q, p)
        of each row."""
        w = self.problem.coefficients(self.data_key, 1, [0], 0, 0, prec)
        _, p = solve(self.problem.darcy[0], w)
        eta = threefry.normals_rows(threefry.fold_in(self.data_key, 1), self.g[0].shape[0],
                                    [0], "float64").numpy()[0]
        return p[0] @ self.g[0].T + np.sqrt(self.noise) * eta

    def evaluate(self, level: int, w: np.ndarray, solve: Callable, y: np.ndarray):
        """(Q, log Pi) of each row of the fields w on `level`."""
        q, p = solve(self.problem.darcy[level], w)
        G = p @ self.g[level].T
        return q, -np.sum((G - y[None, :]) ** 2, axis=1) / (2.0 * self.noise)


def solver_for(device, storage: str = "float64", rtol: float = 1e-10,
               max_iters: int = 2000) -> Callable:
    """solve(darcy_level, w) -> (Q, p) of each row of w, p the physical
    pressure: a sparse LU up to DIRECT_MAX unknowns in float64; above, or
    with another `storage` (the control, in bfloat16), the CG of
    reference/krylov.py."""

    def solve(dl: DarcyLevel, w):
        w = np.atleast_2d(np.asarray(w, dtype=np.float64))
        if storage == "float64" and dl.active.size + dl.lvl.n_s <= DIRECT_MAX:
            out = [dl.solve(wi) for wi in w]
            return np.array([q for q, _ in out]), -np.array([p for _, p in out])
        step = krylov.block_rows(dl.lvl)
        parts = [_cg_block(dl, w[i:i + step], device, rtol, max_iters, storage)
                 for i in range(0, w.shape[0], step)]
        return (np.concatenate([q for q, _ in parts]),
                -np.concatenate([p for _, p in parts]))

    return solve


def _cg_block(dl: DarcyLevel, w: np.ndarray, device, rtol: float, max_iters: int,
              storage: str):
    """krylov._solve_block's iteration, keeping the cell unknown p beside Q:
    (Q, p) of each row."""
    lvl = dl.lvl
    rnd = krylov._rounder(storage)
    st = krylov.structure(dl, device)
    mass = krylov.LineMass(lvl, dl.blocks, w, st.active, device, rnd)
    k = w.shape[0]
    f64 = dict(dtype=torch.float64, device=device)
    inv_d = torch.where(torch.as_tensor(st.active, device=device),
                        1.0 / mass.lumped(lvl.n_u), torch.zeros((), **f64))
    sl = torch.zeros(k, st.sl.rows.numel(), **f64).index_add_(
        1, st.sl_pos, st.sl_val * inv_d[:, st.sl_face])
    mg = krylov.AggregationMG(st, sl, rnd)
    act = torch.as_tensor(dl.active, device=device)
    f = torch.zeros(lvl.n_u, **f64)
    f[act] = torch.as_tensor(dl.f, device=device)
    c = torch.zeros_like(f)
    c[act] = torch.as_tensor(dl.c, device=device)
    f = f.expand(k, -1)
    Bm = lambda u: rnd((st.B @ u.T).T)
    Btm = lambda p: (st.Bt @ p.T).T
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
    return (u @ c).cpu().numpy(), p.cpu().numpy()


def split_key(key: Sequence[int], i: int):
    """Key i of jax.random.split(key) (threefry partitionable): both words
    of threefry2x32(key, (0, i))."""
    return threefry.threefry2x32(key[0], key[1], 0, i)
