"""Batched Krylov solvers with convergence masking: PCG, MINRES, Chebyshev.

Port of parelagmc_tpu/ops/solvers.py (see its docstring for the
conventions: vectors (..., n) with the dof axis last, per-row convergence
||r|| <= max(rtol ||b||, atol), converged rows frozen by masking while the
batch iterates together).

The reference runs each loop as a lax.while_loop; here it is a Python loop
whose continue test (`any(rn > thresh)`, `any(phibar > thresh_row)`) reads
one bool from the device per iteration (a host sync; replaying the loop as
a CUDA graph is later work). PCG's restarts every `restart_every`
iterations and MINRES's restart cycles are host-side branches, as the
reference's lax.cond were. `SolveInfo.iterations` is batch-global.

Tracing (utils/trace.py): `krylov.pcg` spans each PCG call, `krylov.iter`
each of its iterations, with `krylov.apply` (the operator), `krylov.prec`
(the preconditioner) and the continue test `wait.krylov_test` inside; the
exit check is `wait.krylov_verify`. Both solvers count their loop trips
(`krylov.iterations`) and restarts (`krylov.restarts`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from parelagmc_tpu_torch.utils import trace

_KRYLOV = trace.counters("krylov")


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
    role: str = "primal",
):
    """Preconditioned CG for SPD systems, batched over leading dims.

    `restart_every > 0` recomputes the true residual r = b - A x and resets
    the search direction every that many iterations (the float32 rescue).
    On exit a claimed convergence is verified against the TRUE residual
    (4x slack for rows that claimed). `want_r_true=True` returns
    (x, info, r_true) with r_true = b - A x computed unconditionally.
    `role` names the system in the `krylov.pcg` span (primal, adjoint,
    stacked).
    """
    with trace.span("krylov.pcg", role=role) as sp:
        out = _pcg(apply_A, b, prec, x0, max_iters, rtol, atol, restart_every, want_r_true)
        sp.note("iterations", out[1].iterations)
    return out


def _pcg(apply_A, b, prec, x0, max_iters, rtol, atol, restart_every, want_r_true):
    if prec is None:
        prec = lambda r: r
    x = torch.zeros_like(b) if x0 is None else x0
    r = b
    if x0 is not None:
        with trace.span("krylov.apply"):
            r = b - apply_A(x)
    with trace.span("krylov.prec"):
        z = prec(r)
    p = z
    rz = _vdot(r, z)
    b_norm = torch.sqrt(_vdot(b, b))
    thresh = torch.clamp(rtol * b_norm, min=atol)
    rn = torch.sqrt(_vdot(r, r))
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    it = 0
    go = max_iters > 0 and trace.read_bool("krylov_test", torch.any(rn > thresh))
    while go:
        with trace.span("krylov.iter"):
            active = rn > thresh
            with trace.span("krylov.apply"):
                Ap = apply_A(p)
            pAp = _vdot(p, Ap)
            alpha = torch.where(pAp > 0, rz / torch.where(pAp == 0, one, pAp), zero)
            alpha = torch.where(active, alpha, zero)[..., None]
            x = x + alpha * p
            r = r - alpha * Ap
            do_restart = restart_every > 0 and (it + 1) % restart_every == 0
            if do_restart:
                _KRYLOV["restarts"] += 1
                with trace.span("krylov.apply"):
                    r = b - apply_A(x)
            with trace.span("krylov.prec"):
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
            _KRYLOV["iterations"] += 1
            go = it < max_iters and trace.read_bool("krylov_test", torch.any(rn > thresh))

    # Verify claimed convergence against the true residual (the f32 CG
    # recurrence drifts below it; see the reference's note).
    claimed = rn <= thresh
    r_true = None
    if want_r_true:
        with trace.span("krylov.apply"):
            r_true = b - apply_A(x)
        rn = torch.sqrt(_vdot(r_true, r_true))
        verified = True
    else:
        verified = trace.read_bool("krylov_verify", torch.any(claimed))
        if verified:
            with trace.span("krylov.apply"):
                r_t = b - apply_A(x)
            rn = torch.sqrt(_vdot(r_t, r_t))
    rel = rn / torch.where(b_norm == 0, one, b_norm)
    slack = torch.where(claimed, 4.0 * one, one) if verified else one
    conv = rn <= thresh * slack
    info = SolveInfo(it, rel, conv)
    if want_r_true:
        return x, info, r_true
    return x, info


def minres(
    apply_A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    prec: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    x0: Optional[torch.Tensor] = None,
    max_iters: int = 500,
    rtol: float = 1e-6,
    atol: float = 1e-12,
    cycles: int = 3,
    cycle_tighten: float = 0.25,
):
    """Preconditioned MINRES (Paige-Saunders) for symmetric indefinite
    systems with an SPD preconditioner, batched, with restart cycles driven
    by the true residual (the Darcy saddle system under minres-bj).

    The inner exit reads phibar, the residual estimate in the
    preconditioner's norm, while the contract is the 2-norm
    ||b - A x|| <= rtol ||b||; the two differ by a problem-dependent factor.
    Each cycle recomputes the true residual, stops rows that meet the
    2-norm target, and re-enters the Lanczos sweep from the current iterate
    with the inner target of the rest tightened by `cycle_tighten`; the
    iteration count runs on across sweeps and shares `max_iters`. Rows exit
    strictly on the 2-norm criterion; 4x slack is left only to rows whose
    inner estimate claimed convergence before the budget or the cycles ran
    out. Returns (x, SolveInfo)."""
    if prec is None:
        prec = lambda r: r
    x = torch.zeros_like(b) if x0 is None else x0
    b_norm = torch.sqrt(_vdot(b, b))
    thresh = torch.clamp(rtol * b_norm, min=atol)
    scalar = dict(dtype=b.dtype, device=b.device)
    eps = torch.full((), 1e-30, **scalar)
    big = torch.full((), float("inf"), **scalar)
    one = torch.ones((), **scalar)

    def safe_div(a, d):
        return a / torch.where(torch.abs(d) < eps, eps, d)

    def lanczos_sweep(x, r1, it, thresh_row):
        """One Paige-Saunders sweep from iterate x with residual r1 = b - A x;
        a row leaves when phibar falls under its thresh_row (+inf rows are
        frozen)."""
        y = prec(r1)
        beta = torch.sqrt(torch.clamp(_vdot(r1, y), min=0.0))
        r2 = r1
        beta_prev = torch.ones_like(beta)  # unused on the sweep's first step
        dbar = torch.zeros_like(beta)
        epsln = torch.zeros_like(beta)
        cs = -torch.ones_like(beta)
        sn = torch.zeros_like(beta)
        w = torch.zeros_like(b)
        w2 = torch.zeros_like(b)
        phibar = beta
        # No previous Lanczos vector yet: per sweep, not `it > 0`, since a
        # restarted sweep carries its count over.
        first = True
        while it < max_iters and trace.read_bool("krylov_test", torch.any(phibar > thresh_row)):
            active = phibar > thresh_row
            v = y * safe_div(one, beta)[..., None]
            yv = apply_A(v)
            if not first:
                yv = yv - safe_div(beta, beta_prev)[..., None] * r1
            alfa = _vdot(v, yv)
            yv = yv - safe_div(alfa, beta)[..., None] * r2
            y_new = prec(yv)
            beta_new = torch.sqrt(torch.clamp(_vdot(yv, y_new), min=0.0))
            # Apply the previous rotation.
            delta = cs * dbar + sn * alfa
            gbar = sn * dbar - cs * alfa
            epsln_new = sn * beta_new
            dbar_new = -cs * beta_new
            # The new rotation.
            gamma = torch.maximum(torch.sqrt(gbar * gbar + beta_new * beta_new), eps)
            cs_new = gbar / gamma
            sn_new = beta_new / gamma
            phi = cs_new * phibar
            w_new = (v - epsln[..., None] * w2 - delta[..., None] * w) * safe_div(
                one, gamma)[..., None]
            x_new = x + phi[..., None] * w_new
            # Gate the updates of converged rows.
            g = active[..., None]
            x = torch.where(g, x_new, x)
            r1, r2 = torch.where(g, r2, r1), torch.where(g, yv, r2)
            y = torch.where(g, y_new, y)
            beta_prev = torch.where(active, beta, beta_prev)
            beta = torch.where(active, beta_new, beta)
            dbar = torch.where(active, dbar_new, dbar)
            epsln = torch.where(active, epsln_new, epsln)
            w2, w = torch.where(g, w, w2), torch.where(g, w_new, w)
            phibar = torch.where(active, sn_new * phibar, phibar)
            cs = torch.where(active, cs_new, cs)
            sn = torch.where(active, sn_new, sn)
            first = False
            it += 1
            _KRYLOV["iterations"] += 1
        return x, it, phibar <= thresh_row

    it = 0
    thresh_i = thresh
    claimed = torch.zeros_like(thresh, dtype=torch.bool)
    for cycle in range(max(1, cycles)):
        if it >= max_iters:
            break
        if cycle > 0:
            _KRYLOV["restarts"] += 1
        r_t = b - apply_A(x)
        done = torch.sqrt(_vdot(r_t, r_t)) <= thresh  # strict 2-norm check per row
        x, it, sweep_claim = lanczos_sweep(x, r_t, it, torch.where(done, big, thresh_i))
        claimed = claimed | done | sweep_claim
        # Rows that failed the check re-enter with a tighter inner target.
        thresh_i = torch.where(done, thresh_i, thresh_i * cycle_tighten)
        if trace.read_bool("krylov_verify", done.all()):
            break
    # Rows that converged during the last sweep have not been checked in the
    # 2-norm yet: one unconditional apply_A keeps the report honest.
    r_t = b - apply_A(x)
    rn = torch.sqrt(_vdot(r_t, r_t))
    rel = rn / torch.where(b_norm == 0, one, b_norm)
    conv = rn <= thresh * torch.where(claimed, 4.0 * one, one)
    return x, SolveInfo(it, rel, conv)


def chebyshev(
    apply_A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    lam_max: torch.Tensor,
    lam_min_frac: float = 1.0 / 30.0,
    order: int = 5,
    x0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fixed-order Chebyshev iteration approximating A^{-1} b on the
    spectral interval [lam_min_frac * lam_max, lam_max] (Saad, Iterative
    Methods, alg. 12.1). `lam_max` is batched (per-sample upper bounds). A
    fixed polynomial in A, so linear in b: safe as a Krylov preconditioner."""
    lmin = lam_min_frac * lam_max
    theta = 0.5 * (lam_max + lmin)
    delta = 0.5 * (lam_max - lmin)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - apply_A(x) if x0 is not None else b
    ones = torch.ones_like(theta)
    alpha = torch.where(theta == 0, torch.zeros_like(theta),
                        1.0 / torch.where(theta == 0, ones, theta))
    d = alpha[..., None] * r
    safe_delta = torch.where(delta == 0, ones, delta)
    sigma = theta / safe_delta
    rho = 1.0 / sigma
    for _ in range(order):
        x = x + d
        r = r - apply_A(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho)[..., None] * d + (2.0 * rho_new / safe_delta)[..., None] * r
        rho = rho_new
    return x
