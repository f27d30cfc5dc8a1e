"""The coefficient-ELL operators, MINRES and Chebyshev of the port held
against scipy, dense oracles and the JAX package on the CPU in float64;
and the plain Thomas recurrence with several right-hand sides per table set
against separate solves and the kernel's addressing (line_index)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_parity import CPU, rel_err, to_np
from parelagmc_tpu.fem import build_mixed_level as jax_build_mixed_level
from parelagmc_tpu.mesh import make_box_mesh as jax_make_box_mesh
from parelagmc_tpu.ops import ell as jell
from parelagmc_tpu.ops.solvers import chebyshev as jax_chebyshev
from parelagmc_tpu.ops.solvers import minres as jax_minres
from parelagmc_tpu_torch.convert import coef_ell_from_jax, diag_coef_from_jax
from parelagmc_tpu_torch.fem import build_mixed_level
from parelagmc_tpu_torch.mesh import make_box_mesh
from parelagmc_tpu_torch.ops import ell as tell
from parelagmc_tpu_torch.ops.mass_solve import build_mass_tridiag_solver
from parelagmc_tpu_torch.ops.solvers import chebyshev, minres
from parelagmc_tpu_torch.ops.tridiag_pallas import (
    LineLayout,
    line_index,
    rows_first_layout,
    thomas,
    thomas_plain,
)

F64 = torch.float64
BOXES = [((5, 4, 3), (1.0, 2.0, 0.5), (1, 0, 1, 0, 1, 1)), ((4, 3), (1.0, 2.0), (0, 1, 1, 0))]


def _masked_mass(lvl, ess):
    """The masked coefficient-ELL values of the Darcy solver (essential
    rows and columns zeroed)."""
    m_vals = lvl.m_vals.copy()
    m_vals[ess, :] = 0.0
    return np.where(ess[lvl.m_cols], 0.0, m_vals)


# -- ELL / CoefELL / DiagCoef ------------------------------------------------------


@pytest.mark.parametrize("ncells,lengths,ess_attr", BOXES)
def test_coef_ell_apply_matches_scipy_and_jax(ncells, lengths, ess_attr):
    lvl = build_mixed_level(make_box_mesh(ncells, lengths=lengths))
    jlvl = jax_build_mixed_level(jax_make_box_mesh(ncells, lengths=lengths))
    ess = lvl.ess_faces(np.array(ess_attr))
    m_vals = _masked_mass(lvl, ess)
    rng = np.random.default_rng(len(ncells))
    c = np.exp(rng.normal(size=(3, lvl.n_s)))
    x = rng.normal(size=(3, lvl.n_u))
    op = tell.pack_coef_ell(lvl.m_cols, m_vals, lvl.m_cells, F64, device=CPU)
    assert op.cols.dtype == torch.int64 and op.cells.dtype == torch.int64
    got = to_np(tell.coef_ell_apply(op, torch.from_numpy(c), torch.from_numpy(x)))
    jop = jell.pack_coef_ell(jlvl.m_cols, m_vals, jlvl.m_cells, jnp.float64)
    ref = np.asarray(jell.coef_ell_apply(jop, jnp.asarray(c), jnp.asarray(x)))
    assert rel_err(got, ref) < 1e-12
    rows = np.repeat(np.arange(lvl.n_u), lvl.m_cols.shape[1])
    for b in range(3):
        M = sp.csr_matrix(((m_vals * c[b][lvl.m_cells]).ravel(), (rows, lvl.m_cols.ravel())),
                          shape=(lvl.n_u, lvl.n_u))
        np.testing.assert_allclose(got[b], M @ x[b], rtol=0, atol=1e-12 * np.abs(got).max())
    # The converted reference operator is the packed one.
    conv = coef_ell_from_jax(jop, device=CPU)
    for name in ("cols", "mvals", "cells"):
        assert torch.equal(getattr(conv, name), getattr(op, name)), name


@pytest.mark.parametrize("ncells,lengths,ess_attr", BOXES)
def test_diag_coef_matches_jax_scipy_and_masked_diag(ncells, lengths, ess_attr):
    """DiagCoef(w) is the diagonal of the masked M(w): equal to the JAX
    package's, to scipy's, and to the diagonal the Schur-CG solvers read
    off their factor tables (MassTridiagSolver.masked_diag)."""
    lvl = build_mixed_level(make_box_mesh(ncells, lengths=lengths))
    ess = lvl.ess_faces(np.array(ess_attr))
    m_vals = _masked_mass(lvl, ess)
    rng = np.random.default_rng(7)
    c = np.exp(rng.normal(size=(2, lvl.n_s)))
    dc = tell.coef_diag_structure(lvl.m_cols, m_vals, lvl.m_cells, F64, device=CPU)
    got = to_np(dc(torch.from_numpy(c)))
    jdc = jell.coef_diag_structure(lvl.m_cols, m_vals, lvl.m_cells, jnp.float64)
    assert rel_err(got, np.asarray(jdc(jnp.asarray(c)))) < 1e-12
    conv = diag_coef_from_jax(jdc, device=CPU)
    assert torch.equal(conv.cells, dc.cells) and torch.equal(conv.vals, dc.vals)
    for b in range(2):
        ref = lvl.mass_csr(c[b]).diagonal()
        np.testing.assert_allclose(got[b], np.where(ess, 0.0, ref), rtol=1e-13)
    ms = build_mass_tridiag_solver(lvl, ess, dtype=F64, device=CPU)
    masked = ms.masked_diag(ms.factor(torch.from_numpy(c)), (2,))
    assert rel_err(masked, got) < 1e-15


def test_coef_diag_structure_general_path_matches_jax():
    """Diagonal slots anywhere in the row (not the assembly's first two)."""
    rng = np.random.default_rng(3)
    n, K = 9, 4
    cols = rng.integers(0, n, size=(n, K))
    cols[:, 2] = np.arange(n)  # a diagonal slot in column 2
    cols[::2, 3] = np.arange(n)[::2]  # and a second one on every other row
    vals = rng.normal(size=(n, K))
    cells = rng.integers(0, 5, size=(n, K))
    c = np.exp(rng.normal(size=(2, 5)))
    dc = tell.coef_diag_structure(cols, vals, cells, F64, device=CPU)
    jdc = jell.coef_diag_structure(cols, vals, cells, jnp.float64)
    assert dc.cells.shape == tuple(np.asarray(jdc.cells).shape)
    assert rel_err(dc(torch.from_numpy(c)), np.asarray(jdc(jnp.asarray(c)))) < 1e-12


def test_ell_apply_matches_scipy():
    rng = np.random.default_rng(5)
    A = sp.random(12, 9, density=0.4, random_state=2, format="csr")
    x = rng.normal(size=(2, 3, 9))
    ell = tell.pack_csr_to_ell(A, F64, device=CPU)
    got = to_np(tell.ell_apply(ell, torch.from_numpy(x)))
    np.testing.assert_allclose(got, x @ A.toarray().T, rtol=0, atol=1e-12)


# -- MINRES -------------------------------------------------------------------------


def _random_spd(n, rng):
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return Q @ np.diag(np.logspace(0, 1.5, n)) @ Q.T


def _saddle(seed, nu, ns, with_prec):
    rng = np.random.default_rng(seed)
    M = _random_spd(nu, rng)
    B = rng.normal(size=(ns, nu))
    A = np.block([[M, B.T], [B, np.zeros((ns, ns))]])
    P = None
    if with_prec:
        S = B @ np.linalg.inv(np.diag(np.diag(M))) @ B.T
        P = np.block([[np.diag(1.0 / np.diag(M)), np.zeros((nu, ns))],
                      [np.zeros((ns, nu)), np.linalg.inv(S)]])
    return A, P, rng


def _both_minres(A, P, b, x0=None, **kw):
    jA, tA = jnp.asarray(A), torch.from_numpy(A)
    jprec = tprec = None
    if P is not None:
        jP, tP = jnp.asarray(P), torch.from_numpy(P)
        jprec, tprec = (lambda r: r @ jP.T), (lambda r: r @ tP.T)
    ref = jax_minres(lambda x: x @ jA.T, jnp.asarray(b), prec=jprec,
                     x0=None if x0 is None else jnp.asarray(x0), **kw)
    got = minres(lambda x: x @ tA.T, torch.from_numpy(b), prec=tprec,
                 x0=None if x0 is None else torch.from_numpy(x0), **kw)
    return got, ref


@pytest.mark.parametrize(
    "seed,nu,ns,with_prec,max_iters,rtol,atol",
    [(4, 25, 10, False, 400, 1e-12, 1e-6), (5, 20, 8, True, 300, 1e-11, 1e-5)],
)
def test_minres_saddle_vs_dense_and_jax(seed, nu, ns, with_prec, max_iters, rtol, atol):
    """The dense saddle oracles of the JAX package's solver tests."""
    A, P, rng = _saddle(seed, nu, ns, with_prec)
    b = rng.normal(size=(3, nu + ns))
    (x, info), (xj, ij) = _both_minres(A, P, b, max_iters=max_iters, rtol=rtol)
    np.testing.assert_allclose(to_np(x), b @ np.linalg.inv(A).T, atol=atol)
    assert bool(info.converged.all())
    assert rel_err(x, xj) < 1e-9
    assert abs(info.iterations - int(ij.iterations)) <= 2
    np.testing.assert_array_equal(to_np(info.converged), np.asarray(ij.converged))


@pytest.mark.parametrize(
    "case",
    [dict(rtol=1e-11), dict(rtol=1e-11, scale_row=1e-4), dict(rtol=1e-11, warm=True),
     dict(rtol=1e-11, cycles=1), dict(rtol=1e-11, cycle_tighten=0.5, cycles=4),
     dict(rtol=1e-12, max_iters=12), dict(rtol=1e-11, with_prec=False)],
    ids=["plain", "masked-row", "warm", "one-cycle", "tighten", "budget", "no-prec"],
)
def test_minres_matches_jax(case):
    """Same numpy-seeded inputs through both packages, solved deep (the two
    may stop an iteration apart, which moves x by the solver tolerance): x
    to 1e-9 (1e-6 of max |x| where the budget cuts the solve short of
    convergence), counts within 2, converged flags equal - rows converging
    at different iterations, a warm start, the cycle options, an exhausted
    budget."""
    case = dict(case)
    with_prec = case.pop("with_prec", True)
    A, P, rng = _saddle(11, 18, 7, with_prec)
    b = rng.normal(size=(4, 25))
    b[2] *= case.pop("scale_row", 1.0)
    x0 = 1e-2 * rng.normal(size=(4, 25)) if case.pop("warm", False) else None
    case.setdefault("max_iters", 400)
    (x, info), (xj, ij) = _both_minres(A, P, b, x0=x0, atol=1e-300, **case)
    assert abs(info.iterations - int(ij.iterations)) <= 2
    np.testing.assert_array_equal(to_np(info.converged), np.asarray(ij.converged))
    cut = case["max_iters"] < 400
    assert rel_err(x, xj) < (1e-6 if cut else 1e-9)
    assert bool(info.converged.all()) != cut
    if cut:  # the same iterate: the same residual
        np.testing.assert_allclose(to_np(info.residual), np.asarray(ij.residual), rtol=1e-3)
    else:  # both under the target; at this depth only rounding separates them
        assert (to_np(info.residual) <= case["rtol"]).all()
        assert (np.asarray(ij.residual) <= case["rtol"]).all()
    # The reported residual is the true one of the returned iterate.
    r = b - to_np(x) @ A.T
    np.testing.assert_allclose(to_np(info.residual),
                               np.linalg.norm(r, axis=-1) / np.linalg.norm(b, axis=-1),
                               rtol=1e-6, atol=1e-15)


def test_minres_zero_rhs_and_iteration_budget_shared_across_cycles():
    A, P, rng = _saddle(2, 12, 5, True)
    tA = torch.from_numpy(A)
    x, info = minres(lambda v: v @ tA.T, torch.zeros(2, 17, dtype=F64))
    assert info.iterations == 0 and bool(info.converged.all()) and not x.any()
    b = torch.from_numpy(rng.normal(size=(2, 17)))
    x, info = minres(lambda v: v @ tA.T, b, max_iters=5, rtol=1e-14, cycles=3)
    assert info.iterations == 5 and not bool(info.converged.any())


# -- Chebyshev ----------------------------------------------------------------------


@pytest.mark.parametrize("order,warm", [(5, False), (3, True), (8, False)])
def test_chebyshev_matches_jax(order, warm):
    rng = np.random.default_rng(order)
    A = _random_spd(20, rng)
    lam_max = np.array([np.abs(A).sum(axis=1).max()] * 3) * np.array([1.0, 1.5, 2.0])
    b = rng.normal(size=(3, 20))
    x0 = rng.normal(size=(3, 20)) if warm else None
    ref = jax_chebyshev(lambda x: x @ jnp.asarray(A), jnp.asarray(b), jnp.asarray(lam_max),
                        order=order, x0=None if x0 is None else jnp.asarray(x0))
    got = chebyshev(lambda x: x @ torch.from_numpy(A), torch.from_numpy(b),
                    torch.from_numpy(lam_max), order=order,
                    x0=None if x0 is None else torch.from_numpy(x0))
    assert rel_err(got, ref) < 1e-12


def test_chebyshev_is_linear_and_contracts():
    """A fixed polynomial in A: linear in b, and with the whole spectrum in
    the interval the residual shrinks with the order."""
    rng = np.random.default_rng(0)
    A = torch.from_numpy(_random_spd(16, rng))
    lam = torch.full((2,), float(torch.linalg.eigvalsh(A).max()), dtype=F64)
    b = torch.from_numpy(rng.normal(size=(2, 16)))
    apply_A = lambda v: v @ A
    x2 = chebyshev(apply_A, 2.0 * b, lam, order=6)
    x1 = chebyshev(apply_A, b, lam, order=6)
    assert torch.allclose(x2, 2.0 * x1, rtol=1e-13, atol=0)
    res = lambda x: (b - apply_A(x)).norm(dim=-1)
    assert (res(chebyshev(apply_A, b, lam, order=12)) < res(x1)).all()
    assert (res(x1) < b.norm(dim=-1)).all()


# -- Thomas with several right-hand sides per table set ----------------------------


def _tables(rng, n, rest):
    dl = rng.uniform(0.1, 1.0, size=(n,) + rest)
    du = rng.uniform(0.1, 1.0, size=(n,) + rest)
    d = dl + du + rng.uniform(0.5, 2.0, size=(n,) + rest)
    return [torch.from_numpy(t) for t in (dl, d, du)]


@pytest.mark.parametrize("R", [1, 2, 8])
@pytest.mark.parametrize("n,rest", [(7, (5,)), (1, (3,)), (6, (2, 4))])
def test_thomas_plain_with_rhs_equals_separate_solves(R, n, rest):
    rng = np.random.default_rng(n + R)
    dl, d, du = _tables(rng, n, rest)
    b = torch.from_numpy(rng.normal(size=(R, n) + rest))
    x = thomas_plain(dl, d, du, b)
    assert x.shape == b.shape and x.is_contiguous()
    for r in range(R):
        assert torch.equal(x[r], thomas_plain(dl, d, du, b[r]))
    assert torch.equal(thomas(dl, d, du, b), x)  # CPU tensors take the plain version


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_thomas_plain_with_rhs_in_reduced_precision(dtype):
    rng = np.random.default_rng(1)
    dl, d, du = (t.to(dtype) for t in _tables(rng, 9, (6,)))
    b = torch.from_numpy(rng.normal(size=(3, 9, 6))).to(dtype)
    x = thomas_plain(dl, d, du, b)
    assert x.dtype == dtype
    for r in range(3):
        assert torch.equal(x[r], thomas_plain(dl, d, du, b[r]))


@pytest.mark.parametrize("R", [1, 2, 5])
def test_line_index_with_rhs_drives_the_plain_recurrence(R):
    """The kernel's addressing of R right-hand sides (line_index with rhs,
    rhs_stride and the right-hand sides' own batch stride) on a strided
    layout: b and x are (B, R, n, J) while the tables are (B, n, J); every
    element is addressed exactly once and the result equals R separate
    solves."""
    rng = np.random.default_rng(R)
    B, n, J = 3, 6, 4
    dl, d, du = (t.movedim(0, 1).contiguous() for t in _tables(rng, n, (B, J)))  # (B, n, J)
    b = torch.from_numpy(rng.normal(size=(B, R, n, J)))
    lay = LineLayout(n=n, L=B * J, J=J, O=1, sO=0, sB=n * J, sI=J, base=0)
    lines, rows = torch.arange(lay.L)[None, :], torch.arange(n)[:, None]
    it = line_index(lay, lines, rows)
    ib = torch.stack([line_index(lay, lines, rows, r, n * J, R * n * J) for r in range(R)])
    assert sorted(ib.reshape(-1).tolist()) == list(range(b.numel()))
    x = torch.zeros(b.numel(), dtype=F64)
    x[ib] = thomas_plain(*(t.reshape(-1)[it] for t in (dl, d, du)), b.reshape(-1)[ib])
    x = x.reshape(b.shape)
    for r in range(R):
        ref = thomas_plain(*(t.movedim(1, 0) for t in (dl, d, du)), b[:, r].movedim(1, 0))
        assert torch.equal(x[:, r], ref.movedim(0, 1))
    # The defaults are the single right-hand side's addressing.
    assert torch.equal(line_index(lay, lines, rows, 0, 99), it)
    assert line_index(rows_first_layout(5, 7), 3, 2, rhs=2, rhs_stride=35) == 2 * 7 + 3 + 70


@pytest.mark.parametrize("ncells,lengths,ess_attr", BOXES)
def test_mass_solver_stacked_right_hand_sides(ncells, lengths, ess_attr):
    """apply_factored on (B, R, n_u): R vectors per sample against that
    sample's tables, equal to R separate applies; and through line_index
    with the layouts the kernel gets."""
    lvl = build_mixed_level(make_box_mesh(ncells, lengths=lengths))
    ess = lvl.ess_faces(np.array(ess_attr))
    ms = build_mass_tridiag_solver(lvl, ess, dtype=F64, device=CPU)
    rng = np.random.default_rng(0)
    B, R = 3, 2
    fac = ms.factor(torch.from_numpy(np.exp(rng.normal(size=(B, lvl.n_s)))))
    r = torch.from_numpy(rng.normal(size=(B, R, lvl.n_u)))
    z = ms.apply_factored(fac, r)
    assert z.shape == r.shape
    for q in range(R):
        assert torch.equal(z[:, q], ms.apply_factored(fac, r[:, q].contiguous()))
    flat = [t.reshape(-1) for t in fac]
    zz = torch.zeros(r.numel(), dtype=F64)
    for lay in ms.layouts(B):
        lines, rows = torch.arange(lay.L)[None, :], torch.arange(lay.n)[:, None]
        it = line_index(lay, lines, rows)
        ib = torch.stack([line_index(lay, lines, rows, q, lvl.n_u, R * lvl.n_u)
                          for q in range(R)])
        zz[ib] = thomas_plain(*(t[it] for t in flat), r.reshape(-1)[ib])
    assert torch.equal(zz.reshape(r.shape), z)
    with pytest.raises(ValueError, match="apply_factored"):
        ms.apply_factored(fac, r[:, :, :-1])
