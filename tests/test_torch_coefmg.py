"""The per-sample Galerkin Schur MG of the port
(parelagmc_tpu_torch/ops/coef_multigrid_structured.py) held against the
JAX package's structured coefMG on the CPU in float64: the MG ladder, the
per-level face conductances, the Jacobi and line tables, S x and one
V-cycle for each smoother, to 1e-12. The grid is non-dyadic (12x10x7), so
the 3-cell tail groups and a passthrough axis are exercised."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from parelagmc_tpu.mesh import make_box_mesh as jax_make_box_mesh
from parelagmc_tpu.ops import coef_multigrid_structured as jmg
from parelagmc_tpu.physics.darcy import _parse_line_axes as jax_parse_line_axes
from parelagmc_tpu_torch.mesh import make_box_mesh
from parelagmc_tpu_torch.ops import coef_multigrid_structured as tmg
from parelagmc_tpu_torch.ops.tridiag_pallas import thomas

GRID = (12, 10, 7)
CUTOFF = 5  # four MG levels on GRID: (12,10,7) (6,5,3) (3,2,1) (1,1,1)

VARIANTS = {
    "jacobi": dict(),
    "cheb3": dict(cheby_order=3, cheby_lo=0.1),
    "lines": dict(cheby_order=3, cheby_lo=0.1, line_axes=(2, 0)),
    "harmonic": dict(line_axes=(2,), coarsen="harmonic"),
}


def _mesh():
    return make_box_mesh(GRID, lengths=(1.2, 2.0, 0.7))


def _jax_mesh():
    return jax_make_box_mesh(GRID, lengths=(1.2, 2.0, 0.7))


def _dinv0(mesh, batch=2, seed=0):
    """Positive face conductances over 6 decades, 0 at a random 10 %
    (essential faces)."""
    rng = np.random.default_rng(seed)
    d = np.exp(3.0 * rng.normal(size=(batch, mesh.num_faces)))
    d[rng.uniform(size=d.shape) < 0.1] = 0.0
    return d


def _pair(**kw):
    mesh = _mesh()
    return mesh, jmg.build_struct_coef_mg(_jax_mesh(), cutoff=CUTOFF, **kw), \
        tmg.build_struct_coef_mg(mesh, cutoff=CUTOFF, **kw)


def test_ladder_matches_jax():
    _, jm, tm = _pair(cheby_order=3, line_axes=(1,), coarsen="harmonic")
    assert [tuple(l) for l in tm.levels] == [tuple(l) for l in jm.levels]
    assert tm.face_offsets == jm.face_offsets
    assert len(tm.levels) == 4 and tm.levels[1].shape == (6, 5, 3)
    for f in ("omega", "coarse_sweeps", "cheby_order", "cheby_lo", "line_axes",
              "line_omega", "coarsen"):
        assert getattr(tm, f) == getattr(jm, f), f


@pytest.mark.parametrize("coarsen", ["galerkin", "harmonic"])
def test_dinvs_match_jax(coarsen):
    mesh, jm, tm = _pair(coarsen=coarsen)
    d0 = _dinv0(mesh)
    ref = jmg.struct_mg_dinvs(jm, jnp.asarray(d0))
    got = tmg.struct_mg_dinvs(tm, torch.from_numpy(d0))
    assert len(got) == len(ref) == 4
    for lg, lr in zip(got, ref):
        for g, r in zip(lg, lr):
            assert tuple(g.shape) == r.shape
            assert rel_err(g, r) < 1e-12


def test_setup_tables_match_jax_solved_axis_first():
    mesh, jm, tm = _pair(line_axes=(0, 1, 2))
    d0 = _dinv0(mesh, seed=1)
    ref = jmg.struct_mg_setup(jm, jnp.asarray(d0))
    got = tmg.struct_mg_setup(tm, torch.from_numpy(d0))
    for (ga, gi, gl), (ra, ri, rl) in zip(got, ref):
        assert rel_err(gi, ri) < 1e-12
        for g3, r3 in zip(gl, rl):  # per line axis: (dl, dd, du)
            for g, r in zip(g3, r3):
                assert g.is_contiguous()
                # The port holds the solved axis first; the reference last.
                assert rel_err(g, np.moveaxis(np.asarray(r), -1, 0)) < 1e-12


def test_line_tables_boundary_entries_are_ignored():
    """dl[0] and du[n-1] carry the boundary faces' conductances (nonzero);
    the Thomas recurrence must not read them: zeroing them changes no
    solution."""
    mesh, _, tm = _pair(line_axes=(2,))
    state = tmg.struct_mg_setup(tm, torch.from_numpy(_dinv0(mesh, seed=2)))
    dl, dd, du = state[0][2][0]
    assert dl[0].abs().max() > 0 and du[-1].abs().max() > 0
    r = torch.from_numpy(np.random.default_rng(3).normal(size=tuple(dd.shape)))
    x = thomas(dl, dd, du, r)
    dl0, du0 = dl.clone(), du.clone()
    dl0[0] = 0.0
    du0[-1] = 0.0
    assert torch.equal(x, thomas(dl0, dd, du0, r))


def test_s_apply_matches_jax():
    mesh, jm, tm = _pair()
    d0 = _dinv0(mesh, seed=4)
    x = np.random.default_rng(5).normal(size=(2, mesh.num_cells))
    ref = jmg.struct_s_apply(jm, jmg.struct_mg_setup(jm, jnp.asarray(d0)), jnp.asarray(x))
    got = tmg.struct_s_apply(tm, tmg.struct_mg_setup(tm, torch.from_numpy(d0)),
                             torch.from_numpy(x))
    assert rel_err(got, ref) < 1e-12


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_v_cycle_matches_jax(variant):
    mesh, jm, tm = _pair(**VARIANTS[variant])
    d0 = _dinv0(mesh, seed=6)
    b = np.random.default_rng(7).normal(size=(2, mesh.num_cells))
    ref = jmg.struct_v_cycle(jm, jmg.struct_mg_setup(jm, jnp.asarray(d0)), jnp.asarray(b),
                             sweeps=2)
    got = tmg.struct_v_cycle(tm, tmg.struct_mg_setup(tm, torch.from_numpy(d0)),
                             torch.from_numpy(b), sweeps=2)
    assert rel_err(got, ref) < 1e-12


def test_v_cycle_bfloat16_state_tracks_float64():
    """The bf16 preconditioner state (coefmg_prec_dtype): every table and
    the cycle's arithmetic in bf16, within bf16's resolution of the float64
    cycle."""
    mesh, _, tm = _pair(**VARIANTS["lines"])
    state = tmg.struct_mg_setup(tm, torch.from_numpy(_dinv0(mesh, seed=8)))
    b = torch.from_numpy(np.random.default_rng(9).normal(size=(2, mesh.num_cells)))
    ref = tmg.struct_v_cycle(tm, state, b)
    low = tmg.cast_state(state, torch.bfloat16)
    assert low[1][2][0][0].dtype == torch.bfloat16
    got = tmg.struct_v_cycle(tm, low, b.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert rel_err(got.double(), ref) < 0.1


@pytest.mark.parametrize("spec", ["", "z", "xz", "auto"])
def test_parse_line_axes_matches_jax(spec):
    mesh = _mesh()
    rng = np.random.default_rng(10)
    kinv = np.exp(rng.normal(size=(mesh.num_cells, 3)))
    kinv[:, 2] *= 1e-2  # z strongly coupled: "auto" picks it
    got = tmg.parse_line_axes(spec, mesh, kinv)
    assert got == jax_parse_line_axes(spec, _jax_mesh(), kinv)
    if spec == "auto":
        assert 2 in got
    assert tmg.parse_line_axes("auto", mesh, None) == ()
    with pytest.raises(ValueError):
        tmg.parse_line_axes("w", mesh, kinv)
