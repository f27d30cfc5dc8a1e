"""The port's hybridized Darcy solve (parelagmc_tpu_torch/physics/hybrid.py,
"hybrid-cg" in unstructured.py) held against the JAX package's on generated
meshes (tests/_torch_parity.py), CPU, float64, the same numpy inputs: the
HybridLevel tables of the geometric and the algebraic construction field by
field to 1e-13 on nested and agglomerated tri and tet hierarchies, with
the same levels falling back to MINRES (None) in both packages;
hybrid_solve's Q, pressure and multiplier to 1e-10 with iteration counts
within 2 or 2 %, with and without the auxiliary-space cycle, from zero and
from the mean-field multiplier, for eff_perm and p_int; and Q against a
dense solve of the saddle system to 1e-7. The JAX side is jitted (its
eager while-loops are slow)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, general_mesh, port_config, rel_err, to_np
from parelagmc_tpu import unstructured as jun
from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem import agglomeration as jagg
from parelagmc_tpu.fem import simplicial_hierarchy as jsh
from parelagmc_tpu.mesh import mfem_io as jmfem
from parelagmc_tpu.physics import hybrid as jhybrid
from parelagmc_tpu_torch import unstructured as tun
from parelagmc_tpu_torch.convert import hybrid_level_from_jax, simplicial_hierarchy_from_jax
from parelagmc_tpu_torch.physics import hybrid as thybrid

F64 = torch.float64

# (kind, build): a 3-level hierarchy of each. "agglomerated" agglomerates
# the refined mesh with factor 8 (tet: 384 -> 48 -> 6 cells, every level
# hybridizes); "single" agglomerates the 6-tet cube into one cell, where
# the algebraic construction declines (no interior face) and MINRES runs.
HIERARCHIES = [("tri", "nested"), ("tet", "nested"), ("tri", "agglomerated"),
               ("tet", "agglomerated"), ("tet", "single")]


def hierarchies(kind: str, build: str):
    """(JAX hierarchy, the port's conversion of it)."""
    if build == "nested":
        base = {"tri": (2, 2), "tet": (1, 1, 1)}[kind]
        jh = jsh.build_simplicial_hierarchy(general_mesh(jmfem, base), 3)
    elif build == "single":
        jh = jagg.build_agglomerated_hierarchy(general_mesh(jmfem, (1, 1, 1)), 2,
                                               coarsening_factor=8)
    else:
        gm = general_mesh(jmfem, {"tri": (2, 2), "tet": (1, 1, 1)}[kind])
        for _ in range(2 if kind == "tet" else 3):
            gm, _ = jsh.refine_simplicial(gm)
        jh = jagg.build_agglomerated_hierarchy(gm, 3, coarsening_factor=8)
    return jh, simplicial_hierarchy_from_jax(jh)


def config(qoi="eff_perm", rtol=1e-11, meanfield=False):
    cfg = ProblemConfig(variance=0.25, correlation_length=0.4, dtype="float64", qoi=qoi)
    cfg.sampler_solver.relative_tolerance = 1e-12
    cfg.sampler_solver.max_iterations = 2000
    cfg.darcy_solver.name = "hybrid-cg"
    cfg.darcy_solver.relative_tolerance = rtol
    cfg.darcy_solver.max_iterations = 2000
    cfg.darcy_solver.coarse_dense_cutoff = 20
    cfg.darcy_solver.meanfield_x0 = meanfield
    return cfg


def solvers(kind, build, **kw):
    jh, th = hierarchies(kind, build)
    cfg = config(**kw)
    return (jh, th, jun.UnstructuredDarcySolver(jh, cfg, jnp.float64),
            tun.UnstructuredDarcySolver(th, port_config(cfg), F64, device=CPU))


def sampled_fields(th, batch, seed):
    """Lognormal SPDE fields (variance 0.25) on every level of `th`."""
    s = tun.UnstructuredSPDESampler(th, port_config(config()), F64, device=CPU)
    return [to_np(s.eval(l, s.sample(l, (seed, l), batch))) for l in range(th.nlevels)]


def assert_same_tables(H_t, H_j):
    for name in thybrid.HybridLevel._fields:
        a, b = getattr(H_t, name), getattr(H_j, name)
        if name in ("n_lam", "n_s", "nloc"):
            assert a == int(b), name
            continue
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        if name in ("c_idx", "lam_src", "own_src"):
            np.testing.assert_array_equal(to_np(a), b, err_msg=name)
        else:
            np.testing.assert_allclose(to_np(a), b, rtol=1e-13,
                                       atol=1e-13 * max(np.abs(b).max(), 1e-300), err_msg=name)


@pytest.mark.parametrize("kind,build", HIERARCHIES)
def test_hybrid_tables_match_jax(kind, build):
    """Per level the same construction (geometric on simplicial levels,
    algebraic on agglomerated ones) and the same tables, or None in both."""
    jh, th, jsol, tsol = solvers(kind, build)
    kinds = []
    for l, (H_t, H_j) in enumerate(zip(tsol._hybrid, jsol._hybrid)):
        assert (H_t is None) == (H_j is None), l
        if H_t is not None:
            assert_same_tables(H_t, H_j)
            kinds.append("geometric" if hasattr(th.levels[l], "mesh") else "algebraic")
        else:
            kinds.append("minres")
    want = {"nested": ["geometric"] * 3, "agglomerated": ["geometric", "algebraic", "algebraic"],
            "single": ["geometric", "minres"]}[build]
    assert kinds == want


def test_table_constructions_decline_as_the_jax_package_does():
    """Both constructions return None in both packages on the same inputs: the
    geometric one on an agglomerated level and under an interior velocity
    load, the algebraic one under an interior velocity load and on a
    single agglomerate; a simplicial level also hybridizes algebraically,
    with the tables of the JAX package's algebraic construction."""
    jh, th, jsol, tsol = solvers("tet", "agglomerated")
    for l in (0, 1):
        ess = to_np(tsol._lv[l]["ess"])
        rhs, obs = to_np(tsol._lv[l]["rhs"]), to_np(tsol._lv[l]["obs"])
        bad = np.ones_like(rhs)
        for tb, jb in ((thybrid.build_hybrid_level, jhybrid.build_hybrid_level),
                       (thybrid.build_hybrid_level_algebraic,
                        jhybrid.build_hybrid_level_algebraic)):
            t_args, j_args = (th.levels[l], ess, bad, obs), (jh.levels[l], ess, bad, obs)
            assert tb(*t_args, F64, CPU) is None and jb(*j_args, jnp.float64) is None
        got_j = jhybrid.build_hybrid_level(jh.levels[l], ess, rhs, obs, jnp.float64)
        got_t = thybrid.build_hybrid_level(th.levels[l], ess, rhs, obs, F64, CPU)
        assert (got_t is None) == (got_j is None) == (l == 1)
        got_j = jhybrid.build_hybrid_level_algebraic(jh.levels[l], ess, rhs, obs, jnp.float64)
        got_t = thybrid.build_hybrid_level_algebraic(th.levels[l], ess, rhs, obs, F64, CPU)
        assert_same_tables(got_t, got_j)
    _, _, jsol, tsol = solvers("tet", "single")
    assert tsol._hybrid[1] is None and jsol._hybrid[1] is None


def assert_iterations(info_t, info_j):
    n = int(info_j.iterations)
    assert abs(int(info_t.iterations) - n) <= max(2, 0.02 * n), (info_t.iterations, n)


@pytest.mark.parametrize("aux", [True, False], ids=["aux", "jacobi"])
@pytest.mark.parametrize("start", ["zero", "lam0"])
@pytest.mark.parametrize("kind,build,qoi", [("tet", "nested", "eff_perm"),
                                            ("tet", "agglomerated", "eff_perm"),
                                            ("tri", "agglomerated", "p_int")])
def test_hybrid_solve_matches_jax(kind, build, qoi, aux, start):
    """hybrid_solve on the port's tables against the JAX package's on its
    own: Q, element pressure and multiplier, on every level; the start is
    zero or the mean-field multiplier of each package's solver."""
    jh, th, jsol, tsol = solvers(kind, build, qoi=qoi)
    w = sampled_fields(th, 3, 5)
    cfg = tsol.solver_cfg
    for level in range(3):
        v = torch.as_tensor(w[level])
        lam_t = lam_j = None
        if start == "lam0":
            lam_t = tsol._meanfield_start(level).expand(3, -1)
            lam_j = jnp.broadcast_to(jsol._meanfield_start(level), (3, lam_t.shape[-1]))
            np.testing.assert_allclose(to_np(lam_t), np.asarray(lam_j), rtol=1e-9, atol=1e-12)
        kw = dict(max_iters=cfg.max_iterations, rtol=cfg.relative_tolerance,
                  restart_every=cfg.restart_every, return_lam=True)
        got = thybrid.hybrid_solve(tsol._hybrid[level], v, lam0=lam_t,
                                   aux_cycle=tsol._coefmg_cycle(level, v) if aux else None, **kw)
        want = jax.jit(lambda x, l0: jhybrid.hybrid_solve(
            jsol._hybrid[level], x, lam0=l0,
            aux_cycle=jsol._coefmg_cycle(level, x) if aux else None, **kw))(
                jnp.asarray(w[level]), lam_j)
        assert bool(got[1].converged.all()) and bool(np.asarray(want[1].converged).all())
        for i in (0, 2, 3):
            assert rel_err(got[i], want[i]) <= 1e-10, (level, i)
        assert_iterations(got[1], want[1])


@pytest.mark.parametrize("meanfield", [False, True])
def test_solve_fwd_and_pair_match_jax(meanfield):
    """UnstructuredDarcySolver under hybrid-cg: solve_fwd with the pressure
    and solve_fwd_pair (two cold solves) equal the JAX package's; on the
    single-agglomerate hierarchy level 1 runs MINRES in both."""
    for kind, build in (("tet", "agglomerated"), ("tet", "single")):
        jh, th, jsol, tsol = solvers(kind, build, meanfield=meanfield)
        w = sampled_fields(th, 3, 9)
        for level in range(th.nlevels):
            q_j, _, info_j, p_j = jax.jit(
                lambda v: jsol.solve_fwd(level, v, return_pressure=True))(jnp.asarray(w[level]))
            q_t, cost, info_t, p_t = tsol.solve_fwd(level, torch.as_tensor(w[level]),
                                                    return_pressure=True)
            assert cost == tsol.num_dofs(level)
            assert rel_err(q_t, q_j) <= 1e-10 and rel_err(p_t, p_j) <= 1e-10
            assert_iterations(info_t, info_j)
        out_j = jax.jit(lambda a, b: jsol.solve_fwd_pair(0, a, b))(jnp.asarray(w[0]),
                                                                 jnp.asarray(w[1]))
        out_t = tsol.solve_fwd_pair(0, torch.as_tensor(w[0]), torch.as_tensor(w[1]))
        assert rel_err(out_t[0], out_j[0]) <= 1e-10 and rel_err(out_t[1], out_j[1]) <= 1e-10
        assert_iterations(out_t[2], out_j[2])
        assert_iterations(out_t[3], out_j[3])


def _dense_solve(lvl, L, w):
    """Q and saddle solution of the assembled system [[M(w), B^T], [B, 0]]
    with the essential faces eliminated, by a dense solve."""
    ess = to_np(L["ess"])
    M = lvl.mass_csr(w).toarray()
    B = lvl.b_csr().toarray()
    M = np.where(np.outer(~ess, ~ess), M, 0.0)
    M[ess, ess] = 1.0
    B = B * (~ess)[None, :]
    A = np.block([[M, B.T], [B, np.zeros((lvl.n_s, lvl.n_s))]])
    x = np.linalg.solve(A, to_np(L["rhs"]))
    return float(x @ to_np(L["obs"])), x


@pytest.mark.parametrize("qoi", ["eff_perm", "p_int"])
@pytest.mark.parametrize("build", ["nested", "agglomerated"])
def test_hybrid_matches_dense(build, qoi):
    """tests/test_hybrid.py's oracle on generated meshes: Q of the port's
    hybridized solve against a dense solve of the saddle system to 1e-7,
    and the recovered pressure against its pressure block, on every level."""
    _, th, _, tsol = solvers("tet", build, qoi=qoi, rtol=1e-10)
    rng = np.random.default_rng(0)
    for level in range(3):
        lvl = th.levels[level]
        w = np.exp(rng.normal(size=(2, lvl.n_s)))
        q, _, info, p = tsol.solve_fwd(level, torch.as_tensor(w), return_pressure=True)
        assert bool(info.converged.all())
        for i in range(2):
            q_ref, x = _dense_solve(lvl, tsol._lv[level], w[i])
            assert abs(float(q[i]) - q_ref) <= 1e-7 * max(1.0, abs(q_ref)), (level, i)
            np.testing.assert_allclose(to_np(p[i]), -x[lvl.n_u:], rtol=1e-7, atol=1e-10)


def test_hybrid_converter_round_trip():
    """hybrid_level_from_jax gives the JAX package's tables as the port's
    HybridLevel; a solve on them equals the solve on the port's own."""
    _, th, jsol, tsol = solvers("tet", "nested")
    H = hybrid_level_from_jax(jsol._hybrid[0], device=CPU)
    assert_same_tables(H, jsol._hybrid[0])
    w = torch.as_tensor(sampled_fields(th, 2, 3)[0])
    a = thybrid.hybrid_solve(H, w, max_iters=500, rtol=1e-10)
    b = thybrid.hybrid_solve(tsol._hybrid[0], w, max_iters=500, rtol=1e-10)
    assert torch.equal(a[0], b[0]) and a[1].iterations == b[1].iterations
