"""M(w)^{-1} of the port (ops/mass_solve.py, plain Thomas of
ops/tridiag_pallas.py) held against the JAX package's Thomas scan, its
Pallas kernel in interpret mode, its MassTridiagSolver and the dense
oracle, in float64 on the CPU; and the K1 kernel's line addressing
(ops/tridiag_pallas.line_index) held against the plain composed path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, rel_err, to_np
from parelagmc_tpu.fem import build_mixed_level as jax_build_mixed_level
from parelagmc_tpu.fem.galerkin_mass import galerkin_block_chain as jax_galerkin_block_chain
from parelagmc_tpu.mesh import make_box_mesh as jax_make_box_mesh
from parelagmc_tpu.ops import mass_solve as jms
from parelagmc_tpu.ops.tridiag_pallas import tridiag_thomas_pallas
from parelagmc_tpu_torch.convert import mass_solver_from_jax
from parelagmc_tpu_torch.fem import build_geometric_hierarchy_from_fine, build_mixed_level
from parelagmc_tpu_torch.fem.galerkin_mass import galerkin_block_chain
from parelagmc_tpu_torch.mesh import SPE10_SPACING, make_box_mesh
from parelagmc_tpu_torch.ops import mass_solve as tms
from parelagmc_tpu_torch.ops.tridiag_pallas import (
    grid_axis_layout,
    line_index,
    rows_first_layout,
    thomas,
    thomas_plain,
)

F64 = torch.float64


def _spd_lines(rng, lead, n):
    """Diagonally dominant tridiagonal lines, solved axis last."""
    dl = rng.uniform(0.1, 1.0, size=lead + (n,))
    du = rng.uniform(0.1, 1.0, size=lead + (n,))
    d = dl + du + rng.uniform(0.5, 2.0, size=lead + (n,))
    dl[..., 0] = 0.0
    du[..., -1] = 0.0
    b = rng.normal(size=lead + (n,))
    return dl, d, du, b


@pytest.mark.parametrize("lead,n", [((3, 5), 7), ((2, 129), 17), ((1,), 1)])
def test_thomas_plain_matches_jax_scan_and_pallas_interpret(lead, n):
    rng = np.random.default_rng(n)
    dl, d, du, b = _spd_lines(rng, lead, n)
    ref_scan = np.asarray(jms._thomas_solve(*(jnp.asarray(x) for x in (dl, d, du, b))))
    ref_pallas = np.asarray(
        tridiag_thomas_pallas(*(jnp.asarray(x) for x in (dl, d, du, b)), interpret=True)
    )
    # The port takes the solved axis FIRST.
    first = lambda x: torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 0)))
    got = np.moveaxis(to_np(thomas(first(dl), first(d), first(du), first(b))), 0, -1)
    assert rel_err(got, ref_scan) < 1e-12
    assert rel_err(got, ref_pallas) < 1e-12
    # And it solves the system.
    resid = d * got - b
    resid[..., 1:] += dl[..., 1:] * got[..., :-1]
    resid[..., :-1] += du[..., :-1] * got[..., 1:]
    assert np.abs(resid).max() < 1e-12 * max(1.0, np.abs(b).max())


def test_thomas_wrapper_validates_arguments():
    x = torch.ones(4, 3, dtype=F64)
    with pytest.raises(ValueError):
        thomas(x, x, x, torch.ones(4, 2, dtype=F64))
    with pytest.raises(TypeError):
        thomas(x.float(), x, x, x)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent path
        m = x.to("meta")
        thomas(m, m, m, m)
    # CPU tensors take the plain version.
    np.testing.assert_allclose(to_np(thomas(0 * x, 2 * x, 0 * x, x)), 0.5)


def _dense_oracle(lvl, ess, w, rhs):
    M = lvl.mass_csr(w).toarray()
    M[ess, :] = 0.0
    M[:, ess] = 0.0
    idx = np.nonzero(ess)[0]
    M[idx, idx] = 1.0
    return np.linalg.solve(M, rhs)


@pytest.mark.parametrize(
    "ncells,lengths,ess_attr",
    [
        ((5, 4, 3), (1.0, 2.0, 0.5), (1, 0, 1, 0, 1, 1)),  # partial essential BCs
        ((4, 4, 4), (2.0, 2.0, 2.0), (0, 1, 1, 1, 1, 0)),  # Darcy golden BCs
        ((4, 3), (1.0, 2.0), (1, 1, 1, 1)),
    ],
)
def test_mass_solver_matches_dense_and_jax(ncells, lengths, ess_attr):
    lvl = build_mixed_level(make_box_mesh(ncells, lengths=lengths))
    jlvl = jax_build_mixed_level(jax_make_box_mesh(ncells, lengths=lengths))
    ess = lvl.ess_faces(np.array(ess_attr))
    rng = np.random.default_rng(4)
    w = np.exp(2.0 * rng.normal(size=(3, lvl.n_s)))
    rhs = rng.normal(size=(3, lvl.n_u))
    rhs[:, ess] = 0.0
    solver = tms.build_mass_tridiag_solver(lvl, ess, dtype=F64, device=CPU)
    got = to_np(solver(torch.from_numpy(w), torch.from_numpy(rhs)))
    jsolver = jms.build_mass_tridiag_solver(jlvl, ess, dtype=jnp.float64)
    ref = np.asarray(jsolver(jnp.asarray(w), jnp.asarray(rhs)))
    assert rel_err(got, ref) < 1e-12
    for b in range(3):
        np.testing.assert_allclose(got[b], _dense_oracle(lvl, ess, w[b], rhs[b]), atol=1e-11)
    # factor/apply_factored reuse across right-hand sides (the CG pattern).
    fac = solver.factor(torch.from_numpy(w))
    got2 = to_np(solver.apply_factored(fac, torch.from_numpy(2.0 * rhs)))
    assert rel_err(got2, 2.0 * ref) < 1e-12


def test_mass_solver_build_equals_converted_jax():
    args = ((5, 4, 3), (1.0, 2.0, 0.5))
    lvl = build_mixed_level(make_box_mesh(*args))
    jlvl = jax_build_mixed_level(jax_make_box_mesh(*args))
    ess = lvl.ess_faces(np.array([1, 0, 1, 0, 1, 1]))
    mine = tms.build_mass_tridiag_solver(lvl, ess, dtype=F64, device=CPU)
    conv = mass_solver_from_jax(jms.build_mass_tridiag_solver(jlvl, ess, dtype=jnp.float64),
                                device=CPU)
    assert mine.shape == conv.shape and mine.face_offsets == conv.face_offsets
    assert mine.n_u == conv.n_u
    assert torch.equal(mine.ess_flat, conv.ess_flat)
    for a, b in zip(mine.axes, conv.axes):
        assert a.dim == b.dim and a.n_a == b.n_a
        for name in ("m_lo", "m_mid", "m_hi", "ess"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_build_line_tables_matches_jax():
    rng = np.random.default_rng(9)
    n, lines = 6, (2, 3)
    m_lo, m_mid, m_hi = (rng.uniform(0.5, 1.0, size=lines + (n,)) for _ in range(3))
    w = np.exp(rng.normal(size=lines + (n,)))
    ess = rng.uniform(size=lines + (n + 1,)) < 0.3
    ref = jms.build_line_tables(*(jnp.asarray(x) for x in (m_lo, m_mid, m_hi, ess, w)))
    first = lambda x: torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 0)))
    got = tms.build_line_tables(*(first(x) for x in (m_lo, m_mid, m_hi, ess, w)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.moveaxis(to_np(g), 0, -1), np.asarray(r))


def _golden_and_spe10_factors():
    """(name, solver, factors, rhs) of M(w)^{-1} on the golden fine level
    (16^3, the reference's BCs) and on a 16x32x8 SPE10-shaped grid with
    Galerkin kinv_ref blocks on every level, float64."""
    rng = np.random.default_rng(11)
    out = []
    golden = build_mixed_level(make_box_mesh((16, 16, 16), lengths=(2.0, 2.0, 2.0)))
    hier = build_geometric_hierarchy_from_fine(make_box_mesh((16, 32, 8), spacings=SPE10_SPACING), 3)
    kinv = np.exp(rng.normal(size=(hier.levels[0].n_s, 3)))
    chain, _ = galerkin_block_chain([lvl.mesh for lvl in hier.levels], kinv)
    cases = [("golden", golden, None)] + [(f"spe10 level {l}", lvl, chain[l])
                                          for l, lvl in enumerate(hier.levels)]
    for name, lvl, blocks in cases:
        ess = lvl.ess_faces(np.array([0, 1, 1, 1, 1, 0]))
        ms = tms.build_mass_tridiag_solver(lvl, ess, dtype=F64, device=CPU, axis_blocks=blocks)
        B = 3
        fac = ms.factor(torch.from_numpy(np.exp(rng.normal(size=(B, lvl.n_s)))))
        out.append((name, ms, fac, torch.from_numpy(rng.normal(size=(B, lvl.n_u)))))
    return out


def test_kernel_line_addressing_matches_the_permute_path():
    """The offset arithmetic the K1 kernel uses (line_index over each axis's
    LineLayout in the flat (B, n_u) vector) drives the plain recurrence on
    the golden and SPE10-shaped factors: every face is addressed exactly
    once and the result equals apply_factored's slice / permute / cat path
    exactly."""
    for name, ms, fac, r in _golden_and_spe10_factors():
        B = r.shape[0]
        flat = [t.reshape(-1) for t in (*fac, r)]
        z = torch.zeros(r.numel(), dtype=r.dtype)
        hits = torch.zeros(r.numel(), dtype=torch.int64)
        for lay in ms.layouts(B):
            idx = line_index(lay, torch.arange(lay.L)[None, :], torch.arange(lay.n)[:, None])
            z[idx] = thomas_plain(*(t[idx] for t in flat))
            hits.index_add_(0, idx.reshape(-1), torch.ones(idx.numel(), dtype=torch.int64))
        assert bool((hits == 1).all()), name
        assert torch.equal(z.reshape(B, -1), ms.apply_factored(fac, r)), name
    # The line smoother's (n, L) tables are the special case of the layout.
    lay = rows_first_layout(5, 7)
    assert line_index(lay, 3, 2) == 2 * 7 + 3
    lines, rows = torch.arange(7)[None, :], torch.arange(5)[:, None]
    assert torch.equal(line_index(grid_axis_layout(1, (5, 7), 0), lines, rows),
                       line_index(lay, lines, rows))
