"""The static Schur multigrid (ops/multigrid.py) and the gather-form
per-sample coefficient multigrid (ops/coef_multigrid.py) of the port held
against the JAX package on the CPU in float64: the host-built tables and
damping factors equal, V-cycles to 1e-11, and the gather form against the
slicing form (ops/coef_multigrid_structured.py) as the JAX package's own
tests hold them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, rel_err, to_np
from parelagmc_tpu.mesh import make_box_mesh as jax_make_box_mesh
from parelagmc_tpu.ops import coef_multigrid as jcmg
from parelagmc_tpu.ops import multigrid as jmg
from parelagmc_tpu.physics import darcy as jdarcy
from parelagmc_tpu_torch.convert import coef_mg_from_jax, mg_hierarchy_from_jax
from parelagmc_tpu_torch.fem import build_mixed_level
from parelagmc_tpu_torch.fem.agglomeration import partition_cells
from parelagmc_tpu_torch.mesh import SPE10_SPACING, make_box_mesh
from parelagmc_tpu_torch.ops import coef_multigrid as tcmg
from parelagmc_tpu_torch.ops import coef_multigrid_structured as tstruct
from parelagmc_tpu_torch.ops import multigrid as tmg
from parelagmc_tpu_torch.physics import darcy as tdarcy
from parelagmc_tpu_torch.physics.spe10 import load_spe10_kinv

F64 = torch.float64
GRID = (12, 10, 7)
ESS_ATTR = np.array([0, 1, 1, 1, 1, 0])


def _schur_mgs(line_smoother, coarse_sweeps=0, cutoff=40):
    """(port, JAX) static Schur multigrids on an SPE10-shaped grid with the
    synthetic kinv_ref: each package assembles S_bar and builds its own."""
    kinv = load_spe10_kinv(None, ncells=GRID)
    args = (kinv, ESS_ATTR)
    mine = tdarcy._build_schur_mg(make_box_mesh(GRID, spacings=SPE10_SPACING), *args, F64, cutoff,
                                  coarse_sweeps=coarse_sweeps, line_smoother=line_smoother,
                                  device=CPU)
    ref = jdarcy._build_schur_mg(jax_make_box_mesh(GRID, spacings=SPE10_SPACING), *args,
                                 jnp.float64, cutoff, coarse_sweeps=coarse_sweeps,
                                 line_smoother=line_smoother)
    return mine, ref


def _ell_equal(a, b, what):
    np.testing.assert_array_equal(to_np(a.cols), np.asarray(b.cols), err_msg=what)
    np.testing.assert_array_equal(to_np(a.vals), np.asarray(b.vals), err_msg=what)


def test_assemble_sbar_matches_jax():
    kinv = load_spe10_kinv(None, ncells=GRID)
    a = tdarcy._assemble_sbar(make_box_mesh(GRID, spacings=SPE10_SPACING), kinv, ESS_ATTR)
    b = jdarcy._assemble_sbar(jax_make_box_mesh(GRID, spacings=SPE10_SPACING), kinv, ESS_ATTR)
    assert (a != b).nnz == 0


@pytest.mark.parametrize("line_smoother", [False, True])
def test_schur_mg_tables_and_every_omega_equal_jax(line_smoother):
    mine, ref = _schur_mgs(line_smoother)
    assert len(mine.levels) == len(ref.levels) >= 2
    assert mine.omega == ref.omega and mine.coarse_sweeps == ref.coarse_sweeps
    np.testing.assert_array_equal(to_np(mine.coarse_inv), np.asarray(ref.coarse_inv))
    np.testing.assert_array_equal(to_np(mine.coarse_inv_diag), np.asarray(ref.coarse_inv_diag))
    _ell_equal(mine.coarse_A, ref.coarse_A, "coarse_A")
    lines = 0
    for l, (a, b) in enumerate(zip(mine.levels, ref.levels)):
        for name in ("A", "P", "Pt"):
            _ell_equal(getattr(a, name), getattr(b, name), f"level {l} {name}")
        np.testing.assert_array_equal(to_np(a.inv_diag), np.asarray(b.inv_diag))
        assert (a.line is None) == (b.line is None)
        for la, lb in zip(a.line or (), b.line or ()):
            lines += 1
            assert la.omega == lb.omega  # the seeded power iteration, to the last bit
            for name in ("dl", "d", "du"):  # solved axis first here, last there
                np.testing.assert_array_equal(to_np(getattr(la, name)).T,
                                              np.asarray(getattr(lb, name)))
            nlines, m = np.asarray(lb.d).shape
            np.testing.assert_array_equal(to_np(la.perm).reshape(m, nlines).T.reshape(-1),
                                          np.asarray(lb.perm))
            assert torch.equal(la.perm[la.iperm], torch.arange(la.perm.numel()))
    assert (lines > 0) == line_smoother
    # The converter carries the reference's hierarchy to the same tables.
    conv = mg_hierarchy_from_jax(ref, device=CPU)
    for a, b in zip(mine.state_dict().items(), conv.state_dict().items()):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]


@pytest.mark.parametrize("omega", ["spectral", 0.7])
def test_build_mg_hierarchy_spectral_omega_equals_jax(omega):
    """Spectral damping (the seeded power iteration folded into inv_diag,
    Jacobi sweeps at the coarsest) on the S_bar chain."""
    import scipy.sparse as sp

    kinv = load_spe10_kinv(None, ncells=(6, 4, 4))
    fine = make_box_mesh((6, 4, 4), spacings=SPE10_SPACING)
    coarse = make_box_mesh((3, 2, 2), spacings=tuple(2 * h for h in SPE10_SPACING))
    kc = np.ones((coarse.num_cells, 3)) * kinv.mean(axis=0)
    mats = [tdarcy._assemble_sbar(fine, kinv, ESS_ATTR),
            tdarcy._assemble_sbar(coarse, kc, ESS_ATTR)]
    par = fine.parent_cells(coarse)
    P = sp.csr_matrix((np.ones(par.size), (np.arange(par.size), par)),
                      shape=(fine.num_cells, coarse.num_cells))
    mine = tmg.build_mg_hierarchy(mats, [P], F64, omega=omega, coarse_sweeps=3, device=CPU)
    ref = jmg.build_mg_hierarchy(mats, [P], jnp.float64, omega=omega, coarse_sweeps=3)
    assert mine.omega == ref.omega
    np.testing.assert_array_equal(to_np(mine.levels[0].inv_diag),
                                  np.asarray(ref.levels[0].inv_diag))
    np.testing.assert_array_equal(to_np(mine.coarse_inv_diag), np.asarray(ref.coarse_inv_diag))
    assert mine.coarse_inv.shape == (0, 0)
    b = np.random.default_rng(1).normal(size=(2, fine.num_cells))
    got = tmg.make_preconditioner(mine, sweeps=1)(torch.from_numpy(b))
    assert rel_err(got, jmg.make_preconditioner(ref, sweeps=1)(jnp.asarray(b))) < 1e-11


@pytest.mark.parametrize("line_smoother,coarse_sweeps,sweeps,lead",
                         [(False, 0, 2, (3,)), (True, 0, 2, (3,)), (True, 4, 1, (2, 2)),
                          (False, 2, 3, ())])
def test_v_cycle_matches_jax(line_smoother, coarse_sweeps, sweeps, lead):
    """One V-cycle on the same residuals, with and without line smoothing
    (the batch as right-hand sides of one static table set), dense and
    Jacobi coarsest level, batch shapes (B,), (B, R) as the stacked solve
    gives them, and none."""
    mine, ref = _schur_mgs(line_smoother, coarse_sweeps)
    n = int(np.prod(GRID))
    b = np.random.default_rng(sweeps).normal(size=lead + (n,))
    got = tmg.v_cycle(mine, torch.from_numpy(b), sweeps=sweeps)
    want = jmg.v_cycle(ref, jnp.asarray(b), sweeps=sweeps)
    assert got.shape == b.shape
    assert rel_err(got, want) < 1e-11


def test_v_cycle_is_symmetric():
    """Post-smoothing runs the line directions reversed: the cycle is a
    symmetric operator (a valid CG preconditioner)."""
    mine, _ = _schur_mgs(True)
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(rng.normal(size=int(np.prod(GRID)))) for _ in range(2))
    a = torch.dot(y, tmg.v_cycle(mine, x))
    b = torch.dot(x, tmg.v_cycle(mine, y))
    assert abs(float(a - b)) < 1e-11 * abs(float(a))


# -- the gather-form per-sample coefficient multigrid ------------------------------


def _coef_mgs(ncells, lengths, ess_attr, **kw):
    mesh = make_box_mesh(ncells, lengths=lengths)
    lvl = build_mixed_level(mesh)
    ess = lvl.ess_faces(np.array(ess_attr))
    mine = tcmg.build_coef_mg(mesh, ess, F64, device=CPU, **kw)
    ref = jcmg.build_coef_mg(jax_make_box_mesh(ncells, lengths=lengths), ess, jnp.float64, **kw)
    return mesh, lvl, ess, mine, ref


def _dinv0(lvl, ess, w):
    diag = np.stack([lvl.mass_csr(wi).diagonal() for wi in w])
    return np.where(ess | (diag <= 0), 0.0, 1.0 / np.maximum(diag, 1e-300))


def _coef_mg_equal(mine, ref):
    assert len(mine.levels) == len(ref.levels)
    assert (mine.omega, mine.coarse_sweeps, mine.cheby_order, mine.cheby_lo) == (
        ref.omega, ref.coarse_sweeps, ref.cheby_order, ref.cheby_lo)
    for l, (a, b) in enumerate(zip(mine.levels, ref.levels)):
        for name in tcmg._TABLES:
            ta, tb = getattr(a, name), getattr(b, name)
            assert (ta is None) == (tb is None), (l, name)
            if ta is not None:
                np.testing.assert_array_equal(to_np(ta), np.asarray(tb), err_msg=f"{l} {name}")


@pytest.mark.parametrize("kw", [dict(cutoff=8, coarse_sweeps=6),
                                dict(cutoff=8, cheby_order=3, cheby_lo=0.2)])
def test_coef_mg_tables_equal_jax(kw):
    *_, mine, ref = _coef_mgs((6, 10, 7), (1.2, 2.0, 0.7), [0, 1, 0, 1, 1, 1], **kw)
    assert len(mine.levels) >= 3
    _coef_mg_equal(mine, ref)
    assert mine.levels[1].face_src.dtype == torch.int64
    conv = coef_mg_from_jax(ref, device=CPU)
    for a, b in zip(mine.state_dict().items(), conv.state_dict().items()):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]


@pytest.mark.parametrize("cheby_order,sweeps,precomputed",
                         [(0, 2, True), (0, 1, False), (3, 2, True), (2, 2, False)])
def test_coef_v_cycle_matches_jax(cheby_order, sweeps, precomputed):
    mesh, lvl, ess, mine, ref = _coef_mgs((6, 10, 7), (1.2, 2.0, 0.7), [0, 1, 0, 1, 1, 1],
                                          cutoff=8, coarse_sweeps=6, cheby_order=cheby_order,
                                          cheby_lo=0.2)
    rng = np.random.default_rng(7 + cheby_order)
    w = np.exp(1.5 * rng.normal(size=(2, lvl.n_s)))
    d0 = _dinv0(lvl, ess, w)
    b = rng.normal(size=(2, lvl.n_s))
    dt = tcmg.coef_mg_dinvs(mine, torch.from_numpy(d0))
    dj = jcmg.coef_mg_dinvs(ref, jnp.asarray(d0))
    for a, c in zip(dt, dj):
        assert rel_err(a, c) < 1e-13
    it = tcmg.coef_mg_idiags(mine, dt) if precomputed else None
    ij = jcmg.coef_mg_idiags(ref, dj) if precomputed else None
    got = tcmg.coef_v_cycle(mine, dt, torch.from_numpy(b), sweeps, idiags=it)
    want = jcmg.coef_v_cycle(ref, dj, jnp.asarray(b), sweeps, idiags=ij)
    assert rel_err(got, want) < 1e-11
    assert rel_err(tcmg._s_apply(mine.levels[0], dt[0], torch.from_numpy(b)),
                   jcmg._s_apply(ref.levels[0], dj[0], jnp.asarray(b))) < 1e-13


@pytest.mark.parametrize(
    "ncells,lengths,ess_attr,kw,batch",
    [((6, 10, 7), (1.2, 2.0, 0.7), [0, 1, 0, 1, 1, 1], dict(cutoff=8, coarse_sweeps=6), 2),
     ((5, 8, 6), (1.0, 1.0, 1.0), [1, 1, 0, 0, 1, 0],
      dict(cutoff=8, cheby_order=3, cheby_lo=0.2), 1)],
    ids=["jacobi", "chebyshev"],
)
def test_struct_coef_mg_matches_gather(ncells, lengths, ess_attr, kw, batch):
    """The slicing-only coefMG is the SAME preconditioner as the gather
    form: per-level dinv hierarchies, fine-level operator applies and whole
    V-cycles agree to float reassociation on an anisotropic box with an odd
    (non-dyadic) axis and essential BCs."""
    mesh, lvl, ess, mg_g, _ = _coef_mgs(ncells, lengths, ess_attr, **kw)
    mg_s = tstruct.build_struct_coef_mg(mesh, **kw)
    assert len(mg_s.levels) == len(mg_g.levels) >= 3
    rng = np.random.default_rng(7)
    w = np.exp(1.5 * rng.normal(size=(batch, lvl.n_s)))
    dinv0 = torch.from_numpy(_dinv0(lvl, ess, w))
    dg = tcmg.coef_mg_dinvs(mg_g, dinv0)
    state = tstruct.struct_mg_setup(mg_s, dinv0)
    for l in range(len(mg_s.levels)):
        flat_s = torch.cat([state[l][0][a].reshape(batch, -1) for a in range(3)], dim=-1)
        np.testing.assert_allclose(to_np(flat_s), to_np(dg[l]), rtol=1e-12, atol=1e-14)
    x = torch.from_numpy(rng.normal(size=(batch, lvl.n_s)))
    np.testing.assert_allclose(to_np(tstruct.struct_s_apply(mg_s, state, x)),
                               to_np(tcmg._s_apply(mg_g.levels[0], dg[0], x)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(to_np(tstruct.struct_v_cycle(mg_s, state, x)),
                               to_np(tcmg.coef_v_cycle(mg_g, dg, x)), rtol=1e-10, atol=1e-12)


def test_both_coef_mgs_take_a_stacked_right_hand_side_axis():
    """With the per-sample state carrying a singleton axis at -2, both forms
    apply to (batch, R, n_s) residuals as to R separate ones (the stacked
    primal + adjoint solve), line smoothing included."""
    mesh, lvl, ess, mg_g, _ = _coef_mgs((6, 10, 7), (1.2, 2.0, 0.7), [0, 1, 0, 1, 1, 1],
                                        cutoff=8, cheby_order=2)
    mg_s = tstruct.build_struct_coef_mg(mesh, cutoff=8, cheby_order=2, line_axes=(2, 1))
    rng = np.random.default_rng(3)
    dinv0 = torch.from_numpy(_dinv0(lvl, ess, np.exp(rng.normal(size=(2, lvl.n_s)))))
    b = torch.from_numpy(rng.normal(size=(2, 3, lvl.n_s)))
    dg, dg1 = tcmg.coef_mg_dinvs(mg_g, dinv0), tcmg.coef_mg_dinvs(mg_g, dinv0.unsqueeze(-2))
    st = tstruct.struct_mg_setup(mg_s, dinv0)
    st1 = tstruct.struct_mg_setup(mg_s, dinv0.unsqueeze(-2))
    zg = tcmg.coef_v_cycle(mg_g, dg1, b)
    zs = tstruct.struct_v_cycle(mg_s, st1, b)
    for r in range(3):
        assert rel_err(zg[:, r], tcmg.coef_v_cycle(mg_g, dg, b[:, r])) < 1e-14
        assert rel_err(zs[:, r], tstruct.struct_v_cycle(mg_s, st, b[:, r].contiguous())) < 1e-14


def test_coef_mg_graph_tables_equal_jax():
    """build_coef_mg_graph from face incidence alone (greedy graph
    agglomeration; the port keeps its own copy of the partitioner)."""
    from parelagmc_tpu.fem.agglomeration import partition_cells as jax_partition_cells

    mesh = make_box_mesh((6, 5, 4), lengths=(1.0, 2.0, 0.5))
    lvl = build_mixed_level(mesh)
    ess = lvl.ess_faces(np.array([0, 1, 1, 1, 1, 0]))
    face_signs = lvl.face_signs.copy()
    face_signs[ess, :] = 0.0
    args = (lvl.face_cells, face_signs, mesh.cell_centers())
    mine = tcmg.build_coef_mg_graph(*args, F64, cutoff=20, factor=4, device=CPU)
    ref = jcmg.build_coef_mg_graph(*args, jnp.float64, cutoff=20, factor=4)
    assert len(mine.levels) >= 3
    _coef_mg_equal(mine, ref)
    # One cycle on it agrees too, and the partitioner copies agree.
    rng = np.random.default_rng(2)
    dinv0 = _dinv0(lvl, ess, np.exp(rng.normal(size=(2, lvl.n_s))))
    b = rng.normal(size=(2, lvl.n_s))
    got = tcmg.coef_v_cycle(mine, tcmg.coef_mg_dinvs(mine, torch.from_numpy(dinv0)),
                            torch.from_numpy(b))
    want = jcmg.coef_v_cycle(ref, jcmg.coef_mg_dinvs(ref, jnp.asarray(dinv0)), jnp.asarray(b))
    assert rel_err(got, want) < 1e-11
    import scipy.sparse as sp

    two = (face_signs[:, 0] != 0) & (face_signs[:, 1] != 0)
    r, c = lvl.face_cells[two, 0], lvl.face_cells[two, 1]
    adj = sp.csr_matrix((np.ones(2 * r.size), (np.r_[r, c], np.r_[c, r])),
                        shape=(lvl.n_s, lvl.n_s))
    np.testing.assert_array_equal(partition_cells(adj, mesh.cell_centers(), 4),
                                  jax_partition_cells(adj, mesh.cell_centers(), 4))
