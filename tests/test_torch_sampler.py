"""Tensor spectral solve and SPDE sampler of the port held against the JAX
package on the CPU in float64 (1e-12 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, port_config, rel_err, to_np
from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem import build_geometric_hierarchy as jax_build_geometric_hierarchy
from parelagmc_tpu.mesh import make_box_mesh as jax_make_box_mesh
from parelagmc_tpu.ops import tensorsolve as jts
from parelagmc_tpu.samplers import SPDESampler as JaxSPDESampler
from parelagmc_tpu_torch.convert import tensor_eig_from_jax
from parelagmc_tpu_torch.fem import build_geometric_hierarchy
from parelagmc_tpu_torch.mesh import make_box_mesh
from parelagmc_tpu_torch.ops import tensorsolve as tts
from parelagmc_tpu_torch.samplers import SPDESampler

F64 = torch.float64


@pytest.mark.parametrize(
    "ncells,lengths,alpha,ess_attr",
    [
        ((5, 4, 3), (1.0, 2.0, 0.5), 100.0, None),  # sampler: all faces essential
        ((4, 4, 4), (2.0, 2.0, 2.0), 0.0, (0, 1, 1, 1, 1, 0)),  # Darcy Schur S(1)
        ((6, 3), (1.0, 0.5), 10.0, (1, 0, 0, 1)),
    ],
)
def test_tensor_eig_build_and_solve_match_jax(ncells, lengths, alpha, ess_attr):
    mesh = make_box_mesh(ncells, lengths=lengths)
    ref = jts.build_tensor_solver(jax_make_box_mesh(ncells, lengths=lengths), alpha,
                                  ess_attr=ess_attr, dtype=jnp.float64)
    mine = tts.build_tensor_solver(mesh, alpha, ess_attr=ess_attr, dtype=F64, device=CPU)
    conv = tensor_eig_from_jax(ref, device=CPU)
    assert mine.shape == conv.shape
    for a, b in zip(mine.V, conv.V):
        assert torch.equal(a, b)
    for name in ("lam", "w_sqrt"):
        assert torch.equal(getattr(mine, name), getattr(conv, name))
    rng = np.random.default_rng(len(ncells))
    b = rng.normal(size=(3, mesh.num_cells))
    got = tts.tensor_solve(mine, torch.from_numpy(b))
    want = np.asarray(jts.tensor_solve(ref, jnp.asarray(b)))
    assert rel_err(got, want) < 1e-12


def _pair(refinements=1, **cfg_kw):
    """(port hierarchy, config, JAX sampler, port sampler) on the golden
    box; each package gets its own hierarchy and config class."""
    base = ((4, 4, 4), (2.0, 2.0, 2.0))
    hier = build_geometric_hierarchy(make_box_mesh(*base), refinements + 1)
    jhier = jax_build_geometric_hierarchy(jax_make_box_mesh(*base), refinements + 1)
    cfg = ProblemConfig(refinements=refinements, **cfg_kw)
    return (hier, cfg, JaxSPDESampler(jhier, cfg, jnp.float64),
            SPDESampler(hier, port_config(cfg), F64, device=CPU))


def test_sampler_noise_equals_jax():
    hier, cfg, js, ts = _pair(variance=2.0)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(3), 0), 1)
    kd = tuple(int(v) for v in np.asarray(jax.random.key_data(key)))
    ref = np.asarray(js.sample(0, key, 5))
    got = to_np(ts.sample(0, kd, 5))
    assert got.shape == ref.shape == (5, hier.levels[0].n_s)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("level,xi_level", [(0, 0), (1, 1), (2, 2), (1, 0), (2, 0), (2, 1)])
def test_spde_eval_matches_jax(level, xi_level):
    hier, cfg, js, ts = _pair(refinements=2)
    rng = np.random.default_rng(10 * level + xi_level)
    xi = rng.normal(size=(4, hier.levels[xi_level].n_s))
    ref = np.asarray(js.eval(level, jnp.asarray(xi), xi_level=xi_level))
    got = ts.eval(level, torch.from_numpy(xi), xi_level=xi_level)
    assert tuple(got.shape) == ref.shape == (4, hier.levels[level].n_s)
    assert rel_err(got, ref) < 1e-12


def test_spde_eval_gaussian_and_normalized_marginals_match_jax():
    hier, cfg, js, ts = _pair(lognormal=False, normalize_marginals=True)
    rng = np.random.default_rng(5)
    xi = rng.normal(size=(3, hier.levels[0].n_s))
    for level in (0, 1):
        ref = np.asarray(js.eval(level, jnp.asarray(xi), xi_level=0))
        got = ts.eval(level, torch.from_numpy(xi), xi_level=0)
        assert rel_err(got, ref) < 1e-12


def test_sampler_rejects_noise_from_a_coarser_level():
    hier, cfg, js, ts = _pair()
    with pytest.raises(ValueError):
        ts.eval(0, torch.zeros(1, hier.levels[1].n_s, dtype=F64), xi_level=1)


def test_restrict_cells_matmul_matches_parent_sum():
    from parelagmc_tpu_torch.samplers.pde import axis_restriction_matrices, restrict_cells_matmul

    hier, cfg, js, ts = _pair()
    f, c = hier.levels[0], hier.levels[1]
    x = np.random.default_rng(0).normal(size=(2, f.n_s))
    mats = axis_restriction_matrices(f.mesh, c.mesh, F64, CPU)
    got = to_np(restrict_cells_matmul(torch.from_numpy(x), mats, f.mesh.shape))
    want = np.stack([np.bincount(hier.parent[0], weights=row, minlength=c.n_s) for row in x])
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
