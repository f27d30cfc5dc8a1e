"""Hybridized mixed Darcy solves on simplicial and agglomerated meshes: the
SPD fast path of the unstructured stack ("hybrid-cg").

Port of parelagmc_tpu/physics/hybrid.py (see its docstring for the
derivation). The saddle system is condensed element by element onto face
Lagrange multipliers. With one pressure and one coefficient w_e per element
the element blocks scale exactly,

    A_e(w) = (1/w_e) A_e^unit,   A^unit = M^-1 - M^-1 b (b^T M^-1 b)^-1 b^T M^-1,

so the multiplier operator H(w) = sum_e C_e (1/w_e) A_e^unit C_e^T is a
gather, a batched (ne, nloc, nloc) block product and a two-slot gather-sum.
PCG runs on H(w) with a Jacobi diagonal, a rank-one deflation of the
constant mode and, when given, an auxiliary-space cell V-cycle; u, p~ and
the QoI are recovered element-locally.

The tables are built on the host in numpy (float64) and moved to `device`
once; the solve is plain PyTorch (index_select gathers, elementwise work,
torch.einsum for the block product), on the tensors' device. The block
product runs with TF32 off (`full_precision_matmul`): a truncated float32
product gives a false Krylov floor near 1e-4 at rtol 1e-5 (measured on the
TPU's bfloat16 passes by the reference, the reason for its
precision="highest").

Conventions match physics/darcy.py: p~ = -p, system signs [[M, B^T], [B, 0]],
essential faces carry u.n = 0 (slots masked out), natural pressure data
arrives pre-assembled in the velocity rhs (nonzero only on boundary faces).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from parelagmc_tpu_torch.device import resolve_device
from parelagmc_tpu_torch.fem.agglomeration import _level_mass_triplets
from parelagmc_tpu_torch.fem.simplicial import _simplex_quadrature
from parelagmc_tpu_torch.ops.solvers import pcg


def element_outward_mass(gm) -> np.ndarray:
    """(ne, d+1, d+1) RT0 element mass matrices in the element-OUTWARD flux
    basis (phi_i = (x - p_i) / (d |K|): unit outward flux through face i,
    sign-free - the owner-orientation signs of the assembled basis cancel
    in this basis)."""
    conn = np.stack(gm.elements)
    d = gm.dim
    nloc = d + 1
    p = gm.vertices[conn]  # (ne, nloc, d)
    mats = p[:, 1:, :] - p[:, :1, :]
    vol = np.abs(np.linalg.det(mats)) / math.factorial(d)
    bary, wq = _simplex_quadrature(d)
    xq = np.einsum("qi,eid->eqd", bary, p)
    Mt = np.zeros((conn.shape[0], nloc, nloc))
    inv_dv = 1.0 / (d * vol)
    phis = [
        inv_dv[:, None, None] * (xq - p[:, i, None, :]) for i in range(nloc)
    ]
    for i in range(nloc):
        for j in range(i, nloc):
            val = vol * np.einsum("q,eqd,eqd->e", wq, phis[i], phis[j])
            Mt[:, i, j] = val
            Mt[:, j, i] = val
    return Mt


class HybridLevel(NamedTuple):
    n_lam: int
    n_s: int
    nloc: int
    A_unit: torch.Tensor  # (ne, nloc, nloc) unit flux-flux inverse block
    r_til: torch.Tensor  # (ne, nloc) pressure-recovery row M^-1 b / (b^T M^-1 b)
    s_den: torch.Tensor  # (ne,) b^T M^-1 b
    c_idx: torch.Tensor  # (ne, nloc) int64 multiplier id per slot (0 pad)
    c_mask: torch.Tensor  # (ne, nloc) multiplier weight per slot (0 where none)
    f_loc: torch.Tensor  # (ne, nloc) element-local velocity rhs
    g_loc: torch.Tensor  # (ne,) element pressure rhs
    lam_src: torch.Tensor  # (n_lam, 2) int64 flattened (e * nloc + slot) pairs
    lam_mask: torch.Tensor  # (n_lam, 2)
    own_src: torch.Tensor  # (n_u,) int64 owner (e * nloc + slot) per global face
    obs_u: torch.Tensor  # (n_u,)
    obs_p: torch.Tensor  # (n_s,)


def _hybrid_level(n_lam, n_s, nloc, A_unit, r_til, s_den, c_idx, c_mask, f_loc, g_loc,
                  lam_src, lam_mask, own_src, obs, n_u, dtype, device) -> HybridLevel:
    """HybridLevel of host arrays, moved to `device` (None: cuda:0)."""
    dev = resolve_device(device)
    f = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)
    i = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int64, device=dev)
    obs = np.asarray(obs)
    return HybridLevel(
        n_lam=n_lam, n_s=n_s, nloc=nloc, A_unit=f(A_unit), r_til=f(r_til), s_den=f(s_den),
        c_idx=i(c_idx), c_mask=f(c_mask), f_loc=f(f_loc), g_loc=f(g_loc), lam_src=i(lam_src),
        lam_mask=f(lam_mask), own_src=i(own_src), obs_u=f(obs[:n_u]), obs_p=f(obs[n_u:]))


def build_hybrid_level(lvl, ess: np.ndarray, rhs: np.ndarray, obs: np.ndarray,
                       dtype: torch.dtype = torch.float32, device=None) -> Optional[HybridLevel]:
    """Static hybridization tensors for one SimplicialLevel (None when the
    level carries no simplicial element geometry, e.g. agglomerated coarse
    levels, or when interior velocity loads exist)."""
    gm = getattr(lvl, "mesh", None)  # agglomerated levels carry no mesh
    if gm is None or not hasattr(gm, "elements"):
        return None
    try:
        Mt = element_outward_mass(gm)
    except (ValueError, AttributeError):
        return None
    ne, nloc, _ = Mt.shape
    n_u, n_s = lvl.n_u, lvl.n_s
    keep = ~ess[lvl.cell_faces]  # (ne, nloc) true dofs
    km = keep.astype(np.float64)
    Mm = Mt * km[:, :, None] * km[:, None, :]
    # Identity rows for the masked (essential) slots keep Mm invertible;
    # their A_unit rows/cols are zeroed below so u_ess = 0 exactly.
    idx = np.arange(nloc)
    Mm[:, idx, idx] += (1.0 - km)
    Minv = np.linalg.inv(Mm)
    b = km  # divergence row in the outward basis: 1 on true dofs
    Mb = np.einsum("eij,ej->ei", Minv, b)
    s_den = np.einsum("ei,ei->e", b, Mb)
    A_unit = Minv - Mb[:, :, None] * Mb[:, None, :] / s_den[:, None, None]
    A_unit = A_unit * km[:, :, None] * km[:, None, :]
    r_til = Mb / s_den[:, None]

    # Multiplier numbering: interior faces only (two adjacent elements).
    interior = lvl.face_signs[:, 1] != 0.0
    lam_of_face = np.full(n_u, -1, dtype=np.int64)
    lam_of_face[interior] = np.arange(int(interior.sum()))
    n_lam = int(interior.sum())
    c_idx = lam_of_face[lvl.cell_faces]
    c_mask = (c_idx >= 0).astype(np.float64)
    c_idx = np.maximum(c_idx, 0)

    # face -> (element, slot) pairs for the scatter-free gather-sum, from
    # the level's face_cells incidence (owner first); slot = position of
    # the face in the adjacent cell's cell_faces row.
    faces = np.arange(n_u)
    e0 = lvl.face_cells[:, 0]
    slot0 = np.argmax(lvl.cell_faces[e0] == faces[:, None], axis=1)
    own_src = e0 * nloc + slot0
    fi = np.nonzero(interior)[0]
    e1 = lvl.face_cells[fi, 1]  # interior faces carry both neighbors
    slot1 = np.argmax(lvl.cell_faces[e1] == fi[:, None], axis=1)
    lam_src = np.stack([own_src[fi], e1 * nloc + slot1], axis=1)
    lam_mask = np.ones((n_lam, 2))

    # Element-local rhs: f_e = sign * rhs_u[face] (rhs_u supported on
    # boundary faces), masked at essential slots.
    rhs_u = np.asarray(rhs[:n_u], dtype=np.float64)
    if np.any(rhs_u[interior] != 0.0):
        return None  # interior velocity loads would double-count; fall back
    f_loc = lvl.cell_signs * rhs_u[lvl.cell_faces] * km
    g_loc = np.asarray(rhs[n_u:], dtype=np.float64)
    return _hybrid_level(n_lam, n_s, nloc, A_unit, r_til, s_den, c_idx, c_mask, f_loc, g_loc,
                         lam_src, lam_mask, own_src, obs, n_u, dtype, device)


def build_hybrid_level_algebraic(level, ess: np.ndarray, rhs: np.ndarray, obs: np.ndarray,
                                 dtype: torch.dtype = torch.float32,
                                 device=None) -> Optional[HybridLevel]:
    """Algebraic hybridization of a Galerkin face-form level (the
    agglomerated coarse levels). agglomerate_level assembles the coarse RT
    mass per agglomerate, M_c(w) = sum_a w_a A_a with A_a supported on
    agglomerate a's faces, so the local blocks come from the level's mass
    triplets. Everything stays in the GLOBAL orientation basis: the
    divergence row is b_e = cell_signs, and the flux-continuity constraint
    u_owner - u_second = 0 carries the +-1 orientation through c_mask /
    lam_mask.

    Returns None (MINRES fallback) if the per-cell blocks do not tile the
    mass, a kept block is not SPD, the level has no interior face (a single
    agglomerate), or interior velocity loads exist."""
    cf = np.asarray(level.cell_faces, dtype=np.int64)
    cs = np.asarray(level.cell_signs, dtype=np.float64)
    n_u, n_s = level.n_u, level.n_s
    ne, nloc = cf.shape
    try:
        mr, mc, mv, mcell = _level_mass_triplets(level)
    except (AttributeError, ValueError):
        return None
    rows_cf = cf[mcell]
    si = np.argmax(rows_cf == mr[:, None], axis=1)
    sj = np.argmax(rows_cf == mc[:, None], axis=1)
    nz = mv != 0.0
    ok = (
        (cf[mcell, si] == mr) & (cf[mcell, sj] == mc)
        & (cs[mcell, si] != 0.0) & (cs[mcell, sj] != 0.0)
    )
    if not ok[nz].all():
        return None  # a mass entry outside its cell's face list
    Mt = np.zeros((ne, nloc, nloc))
    np.add.at(Mt, (mcell[nz], si[nz], sj[nz]), mv[nz])

    km = ((cs != 0.0) & ~ess[cf]).astype(np.float64)
    Mm = Mt * km[:, :, None] * km[:, None, :]
    idx = np.arange(nloc)
    Mm[:, idx, idx] += 1.0 - km
    try:
        if np.linalg.eigvalsh(Mm).min() <= 0.0:
            return None  # kept block not SPD: condensation invalid
        Minv = np.linalg.inv(Mm)
    except np.linalg.LinAlgError:
        return None
    b = cs * km
    Mb = np.einsum("eij,ej->ei", Minv, b)
    s_den = np.einsum("ei,ei->e", b, Mb)
    if np.any(s_den <= 0.0):
        return None
    A_unit = (
        Minv - Mb[:, :, None] * Mb[:, None, :] / s_den[:, None, None]
    ) * km[:, :, None] * km[:, None, :]
    r_til = Mb / s_den[:, None]

    interior = level.face_signs[:, 1] != 0.0
    lam_of_face = np.full(n_u, -1, dtype=np.int64)
    lam_of_face[interior] = np.arange(int(interior.sum()))
    n_lam = int(interior.sum())
    if n_lam == 0:
        return None  # a single agglomerate: no multiplier system
    c_idx = lam_of_face[cf]
    present = (c_idx >= 0) & (km > 0.0)
    # Signed continuity: owner copy +1, second copy -1 (global basis);
    # cell_signs is exactly that orientation.
    c_mask = np.where(present, cs, 0.0)
    c_idx = np.maximum(c_idx, 0)

    faces = np.arange(n_u)
    e0 = level.face_cells[:, 0]
    slot0 = np.argmax(cf[e0] == faces[:, None], axis=1)
    own_src = e0 * nloc + slot0
    fi = np.nonzero(interior)[0]
    e1 = level.face_cells[fi, 1]
    slot1 = np.argmax(cf[e1] == fi[:, None], axis=1)
    lam_src = np.stack([own_src[fi], e1 * nloc + slot1], axis=1)
    lam_mask = np.stack([cs[e0[fi], slot0[fi]], cs[e1, slot1]], axis=1)

    rhs_u = np.asarray(rhs[:n_u], dtype=np.float64)
    if np.any(rhs_u[interior] != 0.0):
        return None  # interior velocity loads would double-count
    # Global basis: the local rhs is the face value itself.
    f_loc = rhs_u[cf] * km
    g_loc = np.asarray(rhs[n_u:], dtype=np.float64)
    return _hybrid_level(n_lam, n_s, nloc, A_unit, r_til, s_den, c_idx, c_mask, f_loc, g_loc,
                         lam_src, lam_mask, own_src, obs, n_u, dtype, device)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] for an index table of any shape."""
    return torch.index_select(x, -1, idx.reshape(-1)).reshape(x.shape[:-1] + idx.shape)


def _face_sum(H: HybridLevel, ue: torch.Tensor) -> torch.Tensor:
    """(batch, ne, nloc) element-slot values -> (batch, n_lam) sums over
    the (<= 2) slots of each multiplier face."""
    flat = ue.reshape(ue.shape[:-2] + (-1,))
    return torch.sum(_take(flat, H.lam_src) * H.lam_mask, dim=-1)


@contextlib.contextmanager
def full_precision_matmul():
    """float32 matmuls without TF32 inside the block, the caller's setting
    restored after it."""
    prev = torch.get_float32_matmul_precision()
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def hybrid_solve(H: HybridLevel, w: torch.Tensor, max_iters: int, rtol: float,
                 atol: float = 0.0, restart_every: int = 0, aux_cycle=None, lam0=None,
                 return_lam: bool = False):
    """Solve the hybridized system for a batch of coefficients w
    (batch, n_s). Returns (Q, info, p_elem) with p_elem the recovered
    element pressures (batch, n_cells), and the multiplier after them
    under `return_lam`.

    aux_cycle: optional cell-space SPD V-cycle r_cell -> z_cell
    approximating S(w)^{-1} (the per-sample graph coefMG), used as the
    coarse half of an auxiliary-space preconditioner: the average-of-
    adjacent-cells interpolation Pi carries the residual to the cells, the
    V-cycle removes the smooth and global modes Jacobi cannot, and Jacobi
    the face-local ones. lam0: the PCG start (the mean-field multiplier)."""
    with full_precision_matmul():
        return _hybrid_solve(H, w, max_iters, rtol, atol, restart_every, aux_cycle, lam0,
                             return_lam)


def _hybrid_solve(H, w, max_iters, rtol, atol, restart_every, aux_cycle, lam0, return_lam):
    winv = 1.0 / w  # (batch, ne)

    def local_apply(vals):
        ue = torch.einsum("eij,...ej->...ei", H.A_unit, vals)
        return ue * winv[..., None]

    def gather_lam(lam):
        return _take(lam, H.c_idx) * H.c_mask

    apply_H = lambda lam: _face_sum(H, local_apply(gather_lam(lam)))

    # rhs_H = sum_e C_e [ (1/w) A f + r g ].
    fl = H.f_loc.expand(w.shape[:-1] + H.f_loc.shape)
    rhs = _face_sum(H, local_apply(fl) + H.r_til * H.g_loc[..., None])

    # Jacobi: diag H = sum over the slots of each face of (1/w_e)
    # A[slot, slot], with PRESENCE masks (mask^2): the algebraic tables
    # carry the +-1 orientation in lam_mask / c_mask, and a signed sum
    # here makes the diagonal ~0 or negative on agglomerated levels.
    lam_abs = H.lam_mask * H.lam_mask
    c_abs = H.c_mask * H.c_mask
    a_dd = torch.diagonal(H.A_unit, dim1=-2, dim2=-1)  # (ne, nloc)
    dflat = (a_dd * winv[..., None]).reshape(w.shape[:-1] + (-1,))
    diag = torch.clamp(torch.sum(_take(dflat, H.lam_src) * lam_abs, dim=-1), min=1e-30)
    # Constant-mode deflation: every element block annihilates local
    # constants, so H is nearly singular on the constant multiplier vector;
    # a rank-one SPD augmentation of the preconditioner removes that
    # eigenvalue for one extra operator application per solve.
    v = torch.ones_like(rhs) / np.sqrt(max(H.n_lam, 1))
    Hv = apply_H(v)
    vHv = torch.clamp(torch.sum(v * Hv, dim=-1, keepdim=True), min=1e-30)

    def deflate(r):
        return v * (torch.sum(v * r, dim=-1, keepdim=True) / vHv)

    if aux_cycle is not None:
        lam_elems = H.lam_src // H.nloc  # (n_lam, 2) adjacent elements

        def pi_apply(r_cell):  # cells -> multipliers (average of the two)
            # The multiplier is the interface pressure trace, orientation-
            # free, so the interpolation uses presence masks.
            return 0.5 * torch.sum(_take(r_cell, lam_elems) * lam_abs, dim=-1)

        def pi_t_apply(r_lam):  # multipliers -> cells
            return 0.5 * torch.sum(_take(r_lam, H.c_idx) * c_abs, dim=-1)

        def prec(r):
            return r / diag + pi_apply(aux_cycle(pi_t_apply(r))) + deflate(r)
    else:

        def prec(r):
            return r / diag + deflate(r)

    lam, info = pcg(apply_H, rhs, prec=prec, x0=lam0, max_iters=max_iters, rtol=rtol,
                    atol=atol, restart_every=restart_every)

    # Element-local recovery.
    resid = fl - gather_lam(lam)
    ue = local_apply(resid) + H.r_til * H.g_loc[..., None]
    pe = torch.sum(H.r_til * resid, dim=-1) - w * H.g_loc / H.s_den
    u_glob = torch.index_select(ue.reshape(ue.shape[:-2] + (-1,)), -1, H.own_src)
    Q = torch.sum(u_glob * H.obs_u, dim=-1) + torch.sum(pe * H.obs_p, dim=-1)
    if return_lam:
        return Q, info, pe, lam
    return Q, info, pe
