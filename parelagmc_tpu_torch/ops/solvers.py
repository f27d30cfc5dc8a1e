"""Batched preconditioned conjugate gradients with convergence masking.

Port of `pcg` and `SolveInfo` from parelagmc_tpu/ops/solvers.py (see its
docstring for the conventions: vectors (..., n) with the dof axis last,
per-row convergence ||r|| <= max(rtol ||b||, atol), converged rows frozen
by masking while the batch iterates together).

The reference runs the loop as a lax.while_loop; here it is a Python loop
whose continue test `any(rn > thresh)` reads one bool from the device per
iteration (a host sync; replaying the loop as a CUDA graph is later work).
Restarts every `restart_every` iterations are a host-side branch on the
iteration count, as the reference's lax.cond was.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class SolveInfo(NamedTuple):
    iterations: int  # iterations executed (batch-global)
    residual: torch.Tensor  # (...,) final |r| / |b|
    converged: torch.Tensor  # (...,) bool


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def pcg(
    apply_A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    prec: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    x0: Optional[torch.Tensor] = None,
    max_iters: int = 300,
    rtol: float = 1e-6,
    atol: float = 1e-12,
    restart_every: int = 0,
    want_r_true: bool = False,
):
    """Preconditioned CG for SPD systems, batched over leading dims.

    `restart_every > 0` recomputes the true residual r = b - A x and resets
    the search direction every that many iterations (the float32 rescue).
    On exit a claimed convergence is verified against the TRUE residual
    (4x slack for rows that claimed). `want_r_true=True` returns
    (x, info, r_true) with r_true = b - A x computed unconditionally.
    """
    if prec is None:
        prec = lambda r: r
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - apply_A(x) if x0 is not None else b
    z = prec(r)
    p = z
    rz = _vdot(r, z)
    b_norm = torch.sqrt(_vdot(b, b))
    thresh = torch.clamp(rtol * b_norm, min=atol)
    rn = torch.sqrt(_vdot(r, r))
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    it = 0
    while it < max_iters and bool(torch.any(rn > thresh)):
        active = rn > thresh
        Ap = apply_A(p)
        pAp = _vdot(p, Ap)
        alpha = torch.where(pAp > 0, rz / torch.where(pAp == 0, one, pAp), zero)
        alpha = torch.where(active, alpha, zero)[..., None]
        x = x + alpha * p
        r = r - alpha * Ap
        do_restart = restart_every > 0 and (it + 1) % restart_every == 0
        if do_restart:
            r = b - apply_A(x)
        z = prec(r)
        rz_new = _vdot(r, z)
        if do_restart:
            beta = torch.zeros_like(rz)  # steepest-descent reset
        else:
            beta = torch.where(rz > 0, rz_new / torch.where(rz == 0, one, rz), zero)
        p = z + torch.where(active, beta, zero)[..., None] * p
        rn = torch.sqrt(_vdot(r, r))
        rz = rz_new
        it += 1

    # Verify claimed convergence against the true residual (the f32 CG
    # recurrence drifts below it; see the reference's note).
    claimed = rn <= thresh
    r_true = None
    if want_r_true:
        r_true = b - apply_A(x)
        rn = torch.sqrt(_vdot(r_true, r_true))
        verified = True
    else:
        verified = bool(torch.any(claimed))
        if verified:
            r_t = b - apply_A(x)
            rn = torch.sqrt(_vdot(r_t, r_t))
    rel = rn / torch.where(b_norm == 0, one, b_norm)
    slack = torch.where(claimed, 4.0 * one, one) if verified else one
    conv = rn <= thresh * slack
    info = SolveInfo(it, rel, conv)
    if want_r_true:
        return x, info, r_true
    return x, info
