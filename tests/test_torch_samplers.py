"""The embedded, projection and plain SPDE samplers of the port, and the
helpers they stand on (split, cell restriction and prolongation,
tensor_sample, the flux evaluation, the 1D overlaps and the mortar coupling,
the ELL apply, the embedded selection), held against the JAX package on the
CPU in float64: helpers to 1e-12, sampler evaluations to 1e-10 from the
same noise, draws to the tolerance of tests/test_torch_prng.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_parity import CPU, port_config, rel_err, to_np
from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.mesh import factories as jfactories
from parelagmc_tpu.ops import ell as jell
from parelagmc_tpu.ops import tensorsolve as jts
from parelagmc_tpu.problems import build_problem as jax_build_problem
from parelagmc_tpu.samplers import pde as jpde
from parelagmc_tpu_torch.convert import ell_from_jax, sampler_from_jax
from parelagmc_tpu_torch.mesh import factories as tfactories
from parelagmc_tpu_torch.ops import ell as tell
from parelagmc_tpu_torch.ops import prng
from parelagmc_tpu_torch.ops import tensorsolve as tts
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.samplers import pde as tpde

F64 = torch.float64


def key_data(key):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("seed", [0, 101, 2 ** 31 + 5, 2 ** 40 + 7])
@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_equals_jax_random_split(seed, num):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jax.random.key_data(jax.random.split(jk, num)))
    got = np.array(prng.split(prng.fold_in(prng.PRNGKey(seed), 3), num), dtype=np.uint32)
    np.testing.assert_array_equal(got, want)
    if num == 2:  # the default
        np.testing.assert_array_equal(
            np.array(prng.split(prng.fold_in(prng.PRNGKey(seed), 3)), dtype=np.uint32), want)


@pytest.mark.parametrize("shape", [(4, 6, 2), (8, 4), (2, 2, 2)])
def test_restrict_and_prolong_cells_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=(2, 3, int(np.prod(shape))))
    got = tpde.restrict_cells(torch.from_numpy(x), shape)
    want = np.asarray(jpde.restrict_cells(jnp.asarray(x), shape))
    assert tuple(got.shape) == want.shape and rel_err(got, want) < 1e-12
    coarse = tuple(n // 2 for n in shape)
    xc = rng.normal(size=(3, int(np.prod(coarse))))
    got = tpde.prolong_cells(torch.from_numpy(xc), coarse)
    want = np.asarray(jpde.prolong_cells(jnp.asarray(xc), coarse))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(to_np(got), want)
    # P^T P = 2^d on a dyadic grid.
    back = tpde.restrict_cells(got, shape)
    np.testing.assert_allclose(to_np(back), 2 ** len(shape) * xc, rtol=1e-14)


def test_tensor_sample_matches_jax():
    args = dict(ncells=(5, 4, 3), lengths=(1.0, 2.0, 0.5))
    ref = jts.build_tensor_solver(jfactories.make_box_mesh(**args), 25.0, dtype=jnp.float64)
    mine = tts.build_tensor_solver(tfactories.make_box_mesh(**args), 25.0, dtype=F64, device=CPU)
    xi = np.random.default_rng(2).normal(size=(3, 60))
    got = tts.tensor_sample(mine, torch.from_numpy(xi), 0.7)
    assert rel_err(got, jts.tensor_sample(ref, jnp.asarray(xi), 0.7)) < 1e-12
    # The closed form of S^{-1}(scale * W^{1/2} xi).
    direct = tts.tensor_solve(mine, 0.7 * mine.w_sqrt * torch.from_numpy(xi))
    assert rel_err(got, direct) < 1e-12


@pytest.mark.parametrize(
    "orig,embed",
    [(np.linspace(0.0, 2.0, 5), np.linspace(-0.3, 2.5, 8)),
     (np.linspace(0.0, 1.0, 4), np.linspace(0.0, 1.0, 4)),
     (np.array([0.0, 0.5, 2.0]), np.array([-1.0, 0.25, 0.75, 3.0]))],
)
def test_overlap_matrix_1d_matches_jax(orig, embed):
    got = tpde.overlap_matrix_1d(orig, embed)
    want = jpde.overlap_matrix_1d(orig, embed)
    np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=0, atol=1e-15)
    np.testing.assert_allclose(got.toarray().sum(axis=1), np.diff(orig), atol=1e-14)


def test_mortar_coupling_and_ell_apply_match_jax():
    o_args = dict(ncells=(4, 3, 2), lengths=(2.0, 1.5, 1.0))
    e_args = dict(ncells=(7, 5, 3), origin=(-0.3, -0.2, -0.1), lengths=(2.8, 2.0, 1.3))
    G = tpde.mortar_coupling(tfactories.make_box_mesh(**o_args), tfactories.make_box_mesh(**e_args))
    Gj = jpde.mortar_coupling(jfactories.make_box_mesh(**o_args),
                              jfactories.make_box_mesh(**e_args))
    assert abs(G - Gj).max() < 1e-15
    np.testing.assert_allclose(np.asarray(G.sum(axis=1)).ravel(),
                               tfactories.make_box_mesh(**o_args).cell_volumes(), atol=1e-12)
    mine = tell.pack_csr_to_ell(G, F64, device=CPU)
    ref = jell.pack_csr_to_ell(Gj, jnp.float64)
    conv = ell_from_jax(ref, F64, CPU)
    assert mine.cols.dtype == torch.int64 and mine.n_rows == 24
    assert torch.equal(mine.cols, conv.cols) and torch.equal(mine.vals, conv.vals)
    x = np.random.default_rng(3).normal(size=(2, 5, G.shape[1]))
    got = tell.ell_apply(mine, torch.from_numpy(x))
    assert rel_err(got, jell.ell_apply(ref, jnp.asarray(x))) < 1e-12
    assert rel_err(got, np.einsum("rc,abc->abr", G.toarray(), x)) < 1e-12
    # Duplicate slots accumulate; a wider table pads with zeros.
    dup = sp.coo_matrix(([1.0, 2.0, 3.0], ([0, 0, 1], [1, 1, 0])), shape=(2, 2))
    wide = tell.pack_csr_to_ell(dup, F64, width=3, device=CPU)
    np.testing.assert_allclose(
        to_np(tell.ell_apply(wide, torch.tensor([[1.0, 10.0]], dtype=F64))), [[30.0, 3.0]])
    with pytest.raises(ValueError):
        tell.pack_csr_to_ell(G, F64, width=1, device=CPU)


def test_embedded_mesh_factories_match_jax():
    for kw in (dict(ncells=(4, 4), lengths=(2.0, 2.0), n_buffer=(1,)),
               dict(ncells=(4, 2, 6), spacings=(1.0, 0.5, 2.0), n_buffer=(2, 1, 3))):
        jm, tm = jfactories.make_embedded_box_mesh(**kw), tfactories.make_embedded_box_mesh(**kw)
        for a, b in zip(jm.axes, tm.axes):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jm.attributes, tm.attributes)
        box = {k: v for k, v in kw.items() if k != "n_buffer"}
        np.testing.assert_array_equal(
            tfactories.embedded_selection(tm, tfactories.make_box_mesh(**box)),
            jfactories.embedded_selection(jm, jfactories.make_box_mesh(**box)))
    with pytest.raises(ValueError):
        tfactories.embedded_selection(tm, tfactories.make_box_mesh((3, 2, 6)))
    assert tfactories.EGG_NCELLS == jfactories.EGG_NCELLS
    assert tfactories.EGG_SPACING == jfactories.EGG_SPACING
    for jm, tm in ((jfactories.make_egg_mesh(), tfactories.make_egg_mesh()),
                   (jfactories.make_embedded_spe10_mesh(2), tfactories.make_embedded_spe10_mesh(2)),
                   (jfactories.make_spe10_mesh(2), tfactories.make_spe10_mesh(2))):
        assert jm.shape == tm.shape
        np.testing.assert_array_equal(jm.attributes, tm.attributes)
    sh = tfactories.shift_mesh(tm, 1.0, -2.0)
    np.testing.assert_array_equal(sh.axes[1], jfactories.shift_mesh(jm, 1.0, -2.0).axes[1])


def _problems(embedding, ncells=(4, 4, 2), refinements=2, **kw):
    """(JAX problem, port problem) from one config through both
    build_problem functions."""
    cfg = ProblemConfig(ncells=ncells, lengths=(2.0, 2.0, 1.0)[: len(ncells)],
                        refinements=refinements, embedding=embedding, dtype="float64",
                        correlation_length=0.4, n_buffer=(1,), **kw)
    return jax_build_problem(cfg), build_problem(port_config(cfg), device=CPU)


def _assert_state_matches(ts, conv):
    """The port-built sampler state equals the reference's arrays."""
    for mine, ref in zip(ts.eigs, conv.eigs):
        for a, b in zip(mine.V + (mine.lam, mine.w_sqrt), ref.V + (ref.lam, ref.w_sqrt)):
            assert torch.equal(a, b)
    for name in ("w_sqrt", "field_scale", "selection", "winv_orig", "winv_embed"):
        if getattr(conv, name, None) is not None:
            for a, b in zip(getattr(ts, name), getattr(conv, name)):
                assert rel_err(a, b) < 1e-14, name
    for mats, refs in zip(ts.restrict_mats, conv.restrict_mats):
        for a, b in zip(mats, refs):
            assert torch.equal(a, b)
    for name in ("G", "Gt"):
        for a, b in zip(getattr(ts, name, []), getattr(conv, name, [])):
            assert torch.equal(a.cols, b.cols) and torch.equal(a.vals, b.vals)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("lognormal", [False, True])
@pytest.mark.parametrize("embedding", ["none", "matching", "projection"])
def test_sampler_eval_matches_jax(embedding, lognormal, normalize):
    """Every level and every xi_level < level, from the same noise: eval
    (and embed_eval) to 1e-10; the port-built state equals the reference's,
    and the port sampler carrying the reference's arrays evaluates alike."""
    jp, tp = _problems(embedding, lognormal=lognormal, normalize_marginals=normalize)
    js, ts = jp.sampler, tp.sampler
    assert type(ts).__name__ == type(js).__name__
    conv = sampler_from_jax(js, tp.embed_hierarchy or tp.hierarchy, tp.config, F64, CPU,
                            orig_hierarchy=tp.hierarchy)
    _assert_state_matches(ts, conv)
    rng = np.random.default_rng(7)
    for level in range(3):
        assert ts.sample_size(level) == js.sample_size(level)
        assert ts.field_size(level) == js.field_size(level) == tp.hierarchy.levels[level].n_s
        assert ts.nnz(level) == js.nnz(level)
        for xi_level in range(level + 1):
            xi = rng.normal(size=(3, ts.sample_size(xi_level)))
            want = np.asarray(js.eval(level, jnp.asarray(xi), xi_level=xi_level))
            got = ts.eval(level, torch.from_numpy(xi), xi_level=xi_level)
            assert tuple(got.shape) == want.shape == (3, ts.field_size(level))
            assert rel_err(got, want) < 1e-10
            assert rel_err(conv.eval(level, torch.from_numpy(xi), xi_level=xi_level), want) < 1e-10
            if embedding != "none":
                want = np.asarray(js.embed_eval(level, jnp.asarray(xi), xi_level=xi_level))
                got = ts.embed_eval(level, torch.from_numpy(xi), xi_level=xi_level)
                assert tuple(got.shape) == want.shape == (3, ts.sample_size(level))
                assert rel_err(got, want) < 1e-10


def test_projection_transfers_match_jax():
    jp, tp = _problems("projection")
    js, ts = jp.sampler, tp.sampler
    rng = np.random.default_rng(11)
    for level in range(3):
        xe = rng.normal(size=(2, ts.sample_size(level)))
        xo = rng.normal(size=(2, ts.field_size(level)))
        for fn, x in (("project", xe), ("transfer", xe), ("transfer_to_embed", xo)):
            want = np.asarray(getattr(js, fn)(level, jnp.asarray(x)))
            assert rel_err(getattr(ts, fn)(level, torch.from_numpy(x)), want) < 1e-10, fn
        # A constant survives the projection to the original mesh.
        ones = torch.ones(1, ts.sample_size(level), dtype=F64)
        np.testing.assert_allclose(to_np(ts.project(level, ones)), 1.0, rtol=1e-12)


@pytest.mark.parametrize("embedding", ["matching", "projection"])
def test_sampler_draw_matches_jax(embedding):
    jp, tp = _problems(embedding, variance=2.0)
    key = jax.random.fold_in(jax.random.PRNGKey(5), 2)
    for level in range(3):
        want = np.asarray(jp.sampler.sample(level, key, 4))
        got = to_np(tp.sampler.sample(level, key_data(key), 4))
        assert got.shape == want.shape == (4, tp.embed_hierarchy.levels[level].n_s)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_embedded_variants_agree_on_matching_mesh():
    """On one embedded mesh the 0/1 selection and the mortar projection give
    the same field from the same noise."""
    _, sel = _problems("matching", ncells=(4, 4), refinements=1)
    _, proj = _problems("projection", ncells=(4, 4), refinements=1)
    for level in range(2):
        xi = sel.sampler.sample(level, prng.PRNGKey(4 + level), 3)
        np.testing.assert_allclose(to_np(sel.sampler.eval(level, xi)),
                                   to_np(proj.sampler.eval(level, xi)), atol=1e-10)


@pytest.mark.parametrize("lognormal", [False, True])
def test_eval_with_flux_matches_jax(lognormal):
    jp, tp = _problems("none", lognormal=lognormal, refinements=1)
    rng = np.random.default_rng(13)
    for level, xi_level in ((0, 0), (1, 1), (1, 0)):
        xi = rng.normal(size=(2, tp.sampler.sample_size(xi_level)))
        s_ref, u_ref = jp.sampler.eval_with_flux(level, jnp.asarray(xi), xi_level=xi_level)
        s, u = tp.sampler.eval_with_flux(level, torch.from_numpy(xi), xi_level=xi_level)
        assert tuple(u.shape) == (2, tp.hierarchy.levels[level].n_u)
        assert rel_err(s, s_ref) < 1e-12 and rel_err(u, u_ref) < 1e-12
        assert rel_err(s, tp.sampler.eval(level, torch.from_numpy(xi), xi_level=xi_level)) == 0.0


def test_egg_projection_mlmc_matches_jax():
    """The Egg grid (60 x 60 x 7, non-dyadic in z) with the projection
    embedding, through build_problem and one MLMC round of two samples per
    level with deep solves on a log-std-0.5 field: embedded shapes (64, 64,
    11) and (32, 32, 5), fields from the same noise to 1e-10, per-level E[Q]
    and the estimate to 1e-8. (The pinned estimate 99835.47 of
    tests/test_nondyadic.py needs 16 samples cut at 500 iterations, minutes
    on this host: chip_smoke.py holds the port to it on the card.)"""
    from parelagmc_tpu.uq import MLMCManager as JaxMLMCManager
    from parelagmc_tpu_torch.uq import MLMCManager

    cfg = ProblemConfig(mesh="egg", embedding="projection", refinements=1, dtype="float64",
                        seed=0, correlation_length=30.0, variance=0.25, mse=1e10,
                        initial_samples=2, batch_size=2, output_filename="", cost_model="dofs")
    cfg.darcy_solver.relative_tolerance = 1e-9
    cfg.darcy_solver.max_iterations = 3000
    jp, tp = jax_build_problem(cfg), build_problem(port_config(cfg), device=CPU)
    assert tp.hierarchy.levels[0].mesh.shape == (60, 60, 7)
    assert [lvl.mesh.shape for lvl in tp.embed_hierarchy.levels] == [(64, 64, 11), (32, 32, 5)]
    xi = np.random.default_rng(5).normal(size=(2, tp.sampler.sample_size(0)))
    for level in range(2):
        want = np.asarray(jp.sampler.eval(level, jnp.asarray(xi), xi_level=0))
        assert rel_err(tp.sampler.eval(level, torch.from_numpy(xi), xi_level=0), want) < 1e-10
    jmgr = JaxMLMCManager(jp.solver, jp.sampler, cfg)
    mgr = MLMCManager(tp.solver, tp.sampler, tp.config)
    jmgr.init_run([2, 2])
    mgr.init_run([2, 2])
    np.testing.assert_allclose(mgr.eQ, jmgr.eQ, rtol=1e-8)
    np.testing.assert_allclose(mgr.estimate, jmgr.estimate, rtol=1e-8)
    np.testing.assert_allclose(mgr.solver_iterations, jmgr.solver_iterations, atol=1)


def test_matching_embedding_needs_dyadic_grids_and_projection_does_not():
    """A non-dyadic grid raises for matching embedding by design (the
    projection sampler runs there: test_egg_projection_mlmc_matches_jax)."""
    cfg = ProblemConfig(ncells=(3, 2, 3), lengths=(3.0, 2.0, 3.0), refinements=1,
                        embedding="matching", dtype="float64")
    bad = port_config(cfg)
    bad.mesh = "egg"  # 60 x 60 x 7
    with pytest.raises(ValueError, match="matching embedding requires"):
        build_problem(bad, device=CPU)
    with pytest.raises(ValueError, match="unknown embedding"):
        build_problem(port_config(ProblemConfig(embedding="mortar")), device=CPU)
    with pytest.raises(ValueError, match="unknown sampler"):
        build_problem(port_config(ProblemConfig(sampler_name="fourier")), device=CPU)
