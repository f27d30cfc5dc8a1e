"""The covariance classes and the KL sampler of the port held against the
JAX package on the CPU in float64: eigenvalues to 1e-10, eigenvectors up to
sign, KLSampler.eval to 1e-10 from the same mode coefficients, directly and
through build_problem for the analytic and Matern samplers."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, port_config, rel_err, to_np
from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.mesh import factories as jfactories
from parelagmc_tpu.problems import build_problem as jax_build_problem
from parelagmc_tpu.samplers import covariance as jcov
from parelagmc_tpu.utils import special as jspecial
from parelagmc_tpu_torch.convert import sampler_from_jax
from parelagmc_tpu_torch.mesh import factories as tfactories
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.samplers import covariance as tcov
from parelagmc_tpu_torch.samplers.kl import KLSampler
from parelagmc_tpu_torch.utils import special as tspecial

F64 = torch.float64


def _assert_eigenpairs(mine, ref, tol=1e-10):
    np.testing.assert_allclose(mine.eigenvalues, ref.eigenvalues, rtol=tol, atol=tol)
    assert mine.eigenvectors.shape == ref.eigenvectors.shape
    sign = np.sign(np.sum(mine.eigenvectors * ref.eigenvectors, axis=0))
    np.testing.assert_allclose(mine.eigenvectors * sign, ref.eigenvectors, rtol=0, atol=1e-9)


def test_bessel_copies_match_the_jax_package():
    x = np.concatenate([np.linspace(1e-3, 2.0, 40), np.linspace(2.0, 12.0, 40), [-1.5, -5.0]])
    np.testing.assert_array_equal(tspecial.bessi1(x), jspecial.bessi1(x))
    np.testing.assert_array_equal(tspecial.bessk1(x[:-2]), jspecial.bessk1(x[:-2]))


@pytest.mark.parametrize("ncells,lengths,nmodes", [((8, 8), (1.0, 2.0), [3, 4]),
                                                    ((4, 4, 4), (2.0, 2.0, 2.0), 2)])
def test_analytic_covariance_matches_jax(ncells, lengths, nmodes):
    jm = jfactories.make_box_mesh(ncells, lengths=lengths)
    tm = tfactories.make_box_mesh(ncells, lengths=lengths)
    ref = jcov.AnalyticExponentialCovariance(jm, 0.3, nmodes)
    mine = tcov.AnalyticExponentialCovariance(tm, 0.3, nmodes)
    assert mine.num_modes == 0
    ref.solve_eigenvalue()
    mine.solve_eigenvalue()
    _assert_eigenpairs(mine, ref)
    # Continuous eigenfunctions at cell centers: orthogonal up to the grid.
    assert mine.check_orthogonality() == pytest.approx(ref.check_orthogonality(), rel=1e-9)
    assert mine.check_orthogonality() < 0.05
    assert mine.variability_fraction(tm) == pytest.approx(ref.variability_fraction(jm), rel=1e-12)
    np.testing.assert_array_equal(tcov._solve_omegas(5, 0.15), jcov._solve_omegas(5, 0.15))
    with pytest.raises(ValueError):
        tcov.AnalyticExponentialCovariance(tm, 0.3, [100] * len(ncells))


@pytest.mark.parametrize("ncells,lengths", [((8, 6), (1.0, 1.0)), ((4, 4, 4), (2.0, 2.0, 2.0))])
def test_matern_covariance_matches_jax(ncells, lengths):
    """2D runs the r K1(r) kernel, 3D the exp kernel; dense path."""
    jm = jfactories.make_box_mesh(ncells, lengths=lengths)
    tm = tfactories.make_box_mesh(ncells, lengths=lengths)
    ref = jcov.MaternCovariance(jm, 0.4, 6)
    mine = tcov.MaternCovariance(tm, 0.4, 6)
    np.testing.assert_allclose(mine.covariance_matrix(), ref.covariance_matrix(), rtol=1e-14)
    ref.solve_eigenvalue()
    mine.solve_eigenvalue()
    _assert_eigenpairs(mine, ref)


def test_matern_matrix_free_path_matches_jax_and_the_dense_path():
    """Above dense_cutoff: randomized subspace iteration over the FFT
    kernel products (seeded, so both packages draw the same subspace)."""
    args = ((8, 8, 4), (1.0, 1.0, 0.5))
    ref = jcov.MaternCovariance(jfactories.make_box_mesh(args[0], lengths=args[1]), 0.5, 5)
    mine = tcov.MaternCovariance(tfactories.make_box_mesh(args[0], lengths=args[1]), 0.5, 5)
    ref.solve_eigenvalue(dense_cutoff=10)
    mine.solve_eigenvalue(dense_cutoff=10)
    _assert_eigenpairs(mine, ref, tol=1e-9)
    X = np.random.default_rng(0).normal(size=(256, 3))
    np.testing.assert_allclose(mine._matmat(X), mine.covariance_matrix() @ X, rtol=1e-10,
                               atol=1e-12)
    dense = tcov.MaternCovariance(mine.mesh, 0.5, 5)
    dense.solve_eigenvalue()
    np.testing.assert_allclose(mine.eigenvalues, dense.eigenvalues, rtol=1e-6)


@pytest.mark.parametrize("lognormal", [False, True])
@pytest.mark.parametrize("sampler_name", ["analytic", "matern"])
def test_kl_sampler_through_build_problem_matches_jax(sampler_name, lognormal):
    # 8^3 cells on the finest of three levels: the Matern covariance solves a
    # dense eigenproblem of that size in each package.
    cfg = ProblemConfig(ncells=(2, 2, 2), refinements=2, sampler_name=sampler_name,
                        number_of_modes=12, correlation_length=0.5, variance=1.5,
                        lognormal=lognormal, dtype="float64")
    jp = jax_build_problem(cfg)
    tp = build_problem(port_config(cfg), device=CPU)
    js, ts = jp.sampler, tp.sampler
    assert isinstance(ts, KLSampler) and tp.embed_hierarchy is None
    # analytic: max(2, round(12^(1/3))) = 2 modes per axis.
    assert ts.nmodes == js.nmodes == (8 if sampler_name == "analytic" else 12)
    np.testing.assert_allclose(to_np(ts.sqrt_theta), np.asarray(js.sqrt_theta), rtol=1e-10)
    conv = sampler_from_jax(js, tp.hierarchy, tp.config, F64, CPU)
    xi = np.random.default_rng(3).normal(size=(4, ts.nmodes))
    # The eigenvectors agree up to sign: flip the coefficients to match.
    sign = np.sign(np.sum(to_np(ts.modes[0]) * np.asarray(js.modes[0]), axis=1))
    for level in range(3):
        assert ts.sample_size(level) == ts.nmodes and ts.nnz(level) == js.nnz(level)
        assert ts.field_size(level) == tp.hierarchy.levels[level].n_s
        want = np.asarray(js.eval(level, jnp.asarray(xi)))
        assert rel_err(ts.eval(level, torch.from_numpy(xi * sign), xi_level=0), want) < 1e-10
        assert rel_err(conv.eval(level, torch.from_numpy(xi)), want) < 1e-10
    key = jax.random.fold_in(jax.random.PRNGKey(9), 1)
    kd = tuple(int(v) for v in np.asarray(jax.random.key_data(key)))
    np.testing.assert_allclose(to_np(ts.sample(1, kd, 6)), np.asarray(js.sample(1, key, 6)),
                               rtol=0, atol=1e-10)


def test_kl_modes_are_the_cochain_projection():
    """Coarse modes are the volume-weighted averages of the fine ones."""
    cfg = port_config(ProblemConfig(refinements=1, sampler_name="matern", number_of_modes=4,
                                    dtype="float64"))
    tp = build_problem(cfg, device=CPU)
    fine, coarse = to_np(tp.sampler.modes[0]), to_np(tp.sampler.modes[1])
    Wf, Wc = tp.hierarchy.levels[0].W, tp.hierarchy.levels[1].W
    P = tp.hierarchy.p_l2(0)
    np.testing.assert_allclose(coarse, (P.T @ (Wf[:, None] * fine.T)).T / Wc, rtol=1e-12)


def test_normalize_marginals_warns_on_kl_samplers():
    cfg = port_config(ProblemConfig(refinements=0, sampler_name="analytic", dtype="float64",
                                    normalize_marginals=True))
    with pytest.warns(UserWarning, match="normalize_marginals=True has no effect"):
        build_problem(cfg, device=CPU)
    cfg.sampler_name = "pde"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        build_problem(cfg, device=CPU)
