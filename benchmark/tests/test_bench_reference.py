"""The plain reference against parelagmc_tpu_torch on the CPU, in float64
with deep solves: the golden problem on a small box, and an SPE10-shaped
grid with the synthetic permeability (odd counts, relabelled axes,
normalised field, Galerkin coarse levels)."""

import numpy as np
import pytest
import torch

from reference import krylov, problem as rp, threefry
from reference.mixed import Precision

DIRECT = lambda dl, w: [dl.solve(wi)[0] for wi in w]  # the sparse LU, row by row


def port_pair(cfg, kinv, key, level, batch):
    import parelagmc_tpu_torch.problems as pp
    from parelagmc_tpu_torch.uq.managers import eval_pair

    prob = pp.build_problem(cfg, kinv_ref=kinv, device="cpu")
    xi = prob.sampler.sample(level, key, batch)
    s_f, s_c = eval_pair(prob.sampler, level, xi)
    q, qc, _, _ = prob.solver.solve_fwd_pair(level, s_f, s_c)
    return q.numpy(), qc.numpy()


def test_golden_box_matches_the_port():
    from parelagmc_tpu_torch.config import ProblemConfig, SolverConfig

    p = dict(mesh="box", ncells=(2, 2, 2), refinements=2, dtype="float64")
    cfg = ProblemConfig(output_filename="", darcy_solver=SolverConfig(
        name="cg-schur", max_iterations=3000, relative_tolerance=1e-13), **p)
    key = threefry.fold_in(threefry.fold_in(threefry.prng_key(2 ** 33 + 9), 0), 1)
    q, qc = port_pair(cfg, None, key, 0, 3)
    ref = rp.ReferenceProblem({"problem": p})
    prec = Precision()
    qr = ref.q(0, ref.coefficients(key, 3, [0, 1, 2], 0, 0, prec), DIRECT)
    qcr = ref.q(1, ref.coefficients(key, 3, [0, 1, 2], 0, 1, prec), DIRECT)
    np.testing.assert_allclose(q, qr, rtol=1e-9)
    np.testing.assert_allclose(qc, qcr, rtol=1e-9)


@pytest.fixture
def small_spe10(monkeypatch):
    import parelagmc_tpu_torch.problems as pp
    from parelagmc_tpu_torch.config import ProblemConfig, SolverConfig
    from parelagmc_tpu_torch.physics.spe10 import synthetic_spe10_perm

    cells = (10, 18, 7)
    monkeypatch.setattr(pp, "SPE10_NCELLS", cells)
    monkeypatch.setattr(rp, "SPE10_CELLS", cells)
    p = dict(mesh="spe10", refinements=2, correlation_length=100.0, normalize_marginals=True,
             axis_order="auto", dtype="float64")
    cfg = ProblemConfig(output_filename="", darcy_solver=SolverConfig(
        name="cg-schur-coefmg", max_iterations=3000, relative_tolerance=1e-12), **p)
    return cfg, p, 1.0 / synthetic_spe10_perm(cells)


def test_spe10_grid_matches_the_port(small_spe10):
    cfg, p, kinv = small_spe10
    ref = rp.ReferenceProblem({"problem": p}, kinv=kinv)
    prec = Precision()
    for level in (0, 1):
        key = threefry.fold_in(threefry.fold_in(threefry.prng_key(2 ** 31 + 5), level), 1)
        q, qc = port_pair(cfg, kinv, key, level, 2)
        qr = ref.q(level, ref.coefficients(key, 2, [0, 1], level, level, prec), DIRECT)
        wc = ref.coefficients(key, 2, [0, 1], level, level + 1, prec)
        np.testing.assert_allclose(q, qr, rtol=1e-8)
        np.testing.assert_allclose(qc, ref.q(level + 1, wc, DIRECT), rtol=1e-8)


def test_iterative_solve_matches_the_lu(small_spe10, monkeypatch):
    """The CG on a block of samples, in blocks of three, against the LU."""
    cfg, p, kinv = small_spe10
    ref = rp.ReferenceProblem({"problem": p}, kinv=kinv)
    key = threefry.fold_in(threefry.prng_key(77), 0)
    for level in (0, 1):
        w = ref.coefficients(key, 8, list(range(8)), level, level, Precision())
        lu = np.array(DIRECT(ref.darcy[level], w))
        monkeypatch.setattr(krylov, "BLOCK_BYTES", 3 * (krylov.BLOCK_BYTES
                                                        // krylov.block_rows(ref.levels[level])))
        assert krylov.block_rows(ref.levels[level]) == 3
        cg = krylov.solve(ref.darcy[level], w, torch.device("cpu"), rtol=1e-12)
        np.testing.assert_allclose(cg, lu, rtol=1e-9)
