"""The port's SPE10 layer probes (parelagmc_tpu_torch/examples/spe10_{
level0_breakdown,struct_profile,vcycle_profile,iter_cost,level1_cost,
layout_probe}.py) against the JAX package on the CPU.

What a probe computes is held to the JAX package's public functions on the
same numpy-seeded inputs, at a scaled grid: every component's output
before it is timed (M(w)^{-1}, the Schur apply, the V-cycle and its pieces,
the setup, ten PCG iterations, one composed CG iteration; float64 to 1e-10
of max |x|, the PCG to 1e-8), the iteration-cost solve's Q at each budget,
the level-1 step's per-stage iterations (2 or 2 %), converged fractions
and E[Y] (the JAX driver run in process, its stage outputs recorded), and
the layout probe's float32 S apply and V-cycle (2e-5 of max |x|). Each
probe's main also runs on the CPU from its command line to its end.
Timings are never compared.
"""

import dataclasses
import importlib
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (thread count)
from _torch_parity import CPU, close_iterations, drivers, port_config, rel_err
from parelagmc_tpu.config import ProblemConfig as JaxProblemConfig
from parelagmc_tpu.mesh.factories import make_box_mesh as jax_make_box_mesh
from parelagmc_tpu.ops import coef_multigrid_structured as jmg
from parelagmc_tpu.ops.solvers import pcg as jax_pcg
from parelagmc_tpu.physics.spe10 import load_spe10_kinv as jax_load_spe10_kinv
from parelagmc_tpu.problems import build_problem as jax_build_problem
from parelagmc_tpu_torch.examples import _evidence
from parelagmc_tpu_torch.mesh.factories import SPE10_NCELLS, SPE10_SPACING
from parelagmc_tpu_torch.physics.spe10 import load_spe10_kinv
from parelagmc_tpu_torch.problems import build_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = "parelagmc_tpu_torch.examples"
# struct_profile's scaled box: 12x44x16 cells, a coefMG of two levels.
GRID = (12, 44, 16)
BATCH = 2
F64_RTOL = 1e-10
PCG_RTOL = 1e-8
F32_RTOL = 2e-5


def twin(name):
    return importlib.import_module(f"{TWINS}.{name}")


@pytest.fixture(scope="module")
def pair():
    """(JAX problem, port problem, numpy inputs w, r_s, r_u) on GRID as the
    probes' box branch builds it, float64."""
    f = 4
    lengths = tuple(n * h for n, h in zip(SPE10_NCELLS, SPE10_SPACING))
    cfg = JaxProblemConfig(mesh="box", ncells=tuple(g // f for g in GRID), lengths=lengths,
                           refinements=2, batch_size=BATCH, correlation_length=100.0,
                           normalize_marginals=True, dtype="float64")
    cfg.darcy_solver.name = "cg-schur-coefmg"
    jprob = jax_build_problem(cfg, kinv_ref=jax_load_spe10_kinv(None, ncells=GRID))
    tprob = build_problem(port_config(cfg), kinv_ref=load_spe10_kinv(None, ncells=GRID),
                          device=CPU)
    rng = np.random.default_rng(0)
    L = tprob.solver.levels[0]
    w = np.exp(0.5 * rng.normal(size=(BATCH, L.n_s)))
    r_s = rng.normal(size=(BATCH, L.n_s))
    r_u = rng.normal(size=(BATCH, L.n_u))
    return jprob, tprob, (w, r_s, r_u)


def t(x):
    return torch.as_tensor(x, dtype=torch.float64)


def jax_state(jprob, jw):
    """The JAX package's coefMG state of level 0 for the field jw, from its
    masked diagonal of M(w)."""
    L = jprob.solver.levels[0]
    diag_w = L.m_diag(jw)
    dinv0 = jnp.where(diag_w > 0, 1.0 / jnp.where(diag_w == 0, 1.0, diag_w), 0.0)
    return dinv0, jmg.struct_mg_setup(L.coef_mg, dinv0)


def jitted(fn, *arrays):
    """fn(*arrays) as one compiled JAX program (the references' many small
    ops compile once, not one by one)."""
    return jax.jit(fn)(*(jnp.asarray(a) for a in arrays))


def assert_components(got: dict, ref: dict, rtol: float = F64_RTOL, loose=()):
    assert set(got) == set(ref)
    for label, (fn, x0) in got.items():
        out = fn(x0)
        assert tuple(out.shape) == ref[label].shape, label
        assert rel_err(out, ref[label]) < (PCG_RTOL if label in loose else rtol), label


def test_probe_inputs_and_masked_dinv_match_jax(pair):
    jprob, tprob, (w, r_s, r_u) = pair
    tw, tr_s, tr_u = twin("spe10_struct_profile").probe_inputs(tprob.solver, BATCH)
    for a, b in ((tw, w), (tr_s, r_s), (tr_u, r_u)):
        assert a.dtype == torch.float64 and np.array_equal(a.numpy(), b)
    dinv0 = jitted(lambda jw: jax_state(jprob, jw)[0], w)
    assert rel_err(_evidence.masked_dinv(tprob.solver.levels[0], t(w)), dinv0) < F64_RTOL


def test_level0_breakdown_components_match_jax(pair):
    jprob, tprob, (w, r_s, r_u) = pair
    js, L = jprob.solver, jprob.solver.levels[0]

    def reference(jw, jr_s, jr_u):
        apply_S = lambda p: js._apply_B(L, L.mass_solver(jw, js._apply_Bt(L, p)))
        dinvs = jmg.struct_mg_dinvs(L.coef_mg, jax_state(jprob, jw)[0])
        cycle = lambda r: jmg.struct_v_cycle(L.coef_mg, dinvs, r)
        return {
            "Minv": L.mass_solver(jw, jr_u),
            "apply_S": apply_S(jr_s),
            "v_cycle+setup": cycle(jr_s),
            "pcg_10": jax_pcg(apply_S, jr_s, prec=cycle, max_iters=10, rtol=0.0)[0],
        }

    ref = jitted(reference, w, r_s, r_u)
    got = twin("spe10_level0_breakdown").components(tprob.solver, t(w), t(r_u), t(r_s))
    assert_components(got, ref, loose=("pcg_10",))


def test_struct_profile_components_match_jax(pair):
    jprob, tprob, (w, r_s, r_u) = pair
    js, L = jprob.solver, jprob.solver.levels[0]
    mg = L.coef_mg
    B, Bt = (lambda u: js._apply_B(L, u)), (lambda p: js._apply_Bt(L, p))
    shape0 = mg.levels[0].shape

    def reference(jw, jr_s, jr_u):
        dinv0, state = jax_state(jprob, jw)
        fac = L.mass_solver.factor(jw)
        minv = lambda r: L.mass_solver.apply_factored(fac, r)
        grid = jr_s.reshape(BATCH, *shape0[::-1])
        setup = (sum(x.sum() for ent in jmg.struct_mg_setup(mg, dinv0) for x in ent[0])
                 + sum(tab.sum() for axf in L.mass_solver.factor(jnp.exp(-dinv0[..., : L.n_s]))
                       for tab in axf) + dinv0)
        return {
            "Minv(in-loop fac)": L.mass_solver(jw, jr_u),
            "Minv(factored)": minv(jr_u),
            "apply_Bt+B": B(Bt(jr_s)),
            "apply_S": B(minv(Bt(jr_s))),
            "mg_s_apply_0": jmg._s_apply_grid(state[0][0], grid).reshape(BATCH, -1),
            "v_cycle": jmg.struct_v_cycle(mg, state, jr_s),
            "setup(dinv+idiag+fac)": setup,
            "cg_iteration": jmg.struct_v_cycle(mg, state, B(minv(Bt(jr_s)))) + 1e-3 * jr_s,
        }

    ref = jitted(reference, w, r_s, r_u)
    got = twin("spe10_struct_profile").components(tprob.solver, t(w), t(r_s), t(r_u))
    assert_components(got, ref)


def test_vcycle_profile_components_match_jax(pair):
    jprob, tprob, (w, r_s, _) = pair
    mg = jprob.solver.levels[0].coef_mg
    assert len(mg.levels) == 2
    nxt = mg.levels[1]

    def reference(jw, jr_s):
        _, state = jax_state(jprob, jw)
        bg = jr_s.reshape(BATCH, *mg.levels[0].shape[::-1])
        dinv_axes0, idiag0 = state[0][0], state[0][1]
        return {
            "jacobi_sweep_0": bg + mg.omega * idiag0 * (bg - jmg._s_apply_grid(dinv_axes0, bg)),
            "restrict+prolong_0to1": jmg._prolong_cells(jmg._restrict_cells(bg, nxt, 3), nxt, 3),
            "v_cycle_from_level_1": jmg._v_cycle_grid(mg, state, jmg._restrict_cells(bg, nxt, 3),
                                                      2, 1),
            "v_cycle_sweeps1": jmg.struct_v_cycle(mg, state, jr_s, sweeps=1),
            "v_cycle_sweeps2": jmg.struct_v_cycle(mg, state, jr_s, sweeps=2),
            "s_apply_0": jmg._s_apply_grid(dinv_axes0, bg),
        }

    ref = jitted(reference, w, r_s)
    got = twin("spe10_vcycle_profile").components(tprob.solver, t(w), t(r_s))
    assert_components(got, ref)


def test_iter_cost_budgets_match_jax(pair):
    """The solve at each forced budget (rtol 0) runs exactly that many
    iterations and gives the JAX package's Q."""
    jprob, tprob, (w, _, _) = pair
    js, ts = jprob.solver, tprob.solver
    budget = twin("spe10_iter_cost").budget_solve
    saved = ts.solver_cfg
    ts.solver_cfg = dataclasses.replace(saved, relative_tolerance=0.0)
    try:
        for iters in (3, 6):
            js.solver_cfg = dataclasses.replace(js.solver_cfg, relative_tolerance=0.0,
                                                max_iterations=iters)
            q_ref, it_ref = jitted(lambda jw: js.solve_fwd(0, jw)[::2], w)
            q, info = budget(ts, t(w), iters)
            assert info.iterations == int(it_ref.iterations) == iters
            assert rel_err(q, q_ref) < PCG_RTOL
    finally:
        ts.solver_cfg = saved


def _small_grid(monkeypatch, grid):
    """SPE10's grid cut to `grid` for the level-0 probes: the constant
    mesh="spe10" reads and the synthetic permeability's loader in
    _evidence."""
    import parelagmc_tpu_torch.problems as tproblems

    monkeypatch.setattr(tproblems, "SPE10_NCELLS", grid)
    real = _evidence.load_spe10_kinv
    monkeypatch.setattr(_evidence, "load_spe10_kinv",
                        lambda perm, ncells: real(perm, ncells=grid))


def _finite(d) -> bool:
    """Every number in a nested dict/list is finite."""
    if isinstance(d, dict):
        return all(_finite(v) for v in d.values())
    if isinstance(d, (list, tuple)):
        return all(_finite(v) for v in d)
    if isinstance(d, (int, float)) and not isinstance(d, bool):
        return np.isfinite(d)
    return True


@pytest.mark.parametrize("name,argv,keys", [
    ("spe10_level0_breakdown", ["--grid", "12,44,16", "--batch", "2"],
     ("Minv", "apply_S", "v_cycle+setup", "pcg_10", "per_iteration")),
    ("spe10_struct_profile", ["--grid", "12,44,16", "--batch", "2"],
     ("Minv(in-loop fac)", "apply_S", "v_cycle", "cg_iteration")),
    ("spe10_vcycle_profile", ["--batch", "2"], ("jacobi_sweep_0", "v_cycle_sweeps2")),
    ("spe10_iter_cost", ["--batch", "2", "--lo", "2", "--hi", "4"],
     ("budgets", "per_iteration_ms")),
    ("spe10_layout_probe", ["--smoke", "--batch", "2"], ("orders",)),
])
def test_probe_main_runs_on_the_cpu(name, argv, keys, monkeypatch, capsys):
    """Each probe's main to its end on the CPU (the full-grid probes on the
    scaled grid): finite numbers behind a device line, every label."""
    _small_grid(monkeypatch, GRID)
    out = twin(name).main(argv + ["--device", "cpu"])
    printed = capsys.readouterr().out
    assert printed.startswith("device: cpu\n") and out["device"] == "cpu"
    assert set(keys) <= set(out) and _finite(out)
    if name == "spe10_iter_cost":
        assert [b["iterations"] for b in out["budgets"].values()] == [2, 4]
    if name == "spe10_layout_probe":
        assert [tuple(r["order"]) for r in out["orders"]] == [(6, 22, 9), (22, 9, 6), (22, 6, 9)]
        assert out["orders"][0]["v_cycle_speedup"] == 1.0


def test_layout_probe_components_match_jax():
    """The layout probe's float32 S apply and V(2,2) cycle on each smoke
    order, on the same draws, against the JAX package's."""
    probe = twin("spe10_layout_probe")
    rng = np.random.default_rng(0)
    jrng = np.random.default_rng(0)
    for order in probe.SMOKE_ORDERS:
        mg, state, r = probe.order_problem(order, BATCH, rng, torch.float32, CPU)
        mesh = jax_make_box_mesh(order)
        jm = jmg.build_struct_coef_mg(mesh)
        d0 = jnp.asarray(np.exp(jrng.normal(size=(BATCH, mesh.num_faces)) * 0.3), jnp.float32)
        jr = jnp.asarray(jrng.normal(size=(BATCH, mesh.num_cells)), jnp.float32)
        assert np.array_equal(r.numpy(), np.asarray(jr))

        def reference(d0, jr, jm=jm):
            jstate = jmg.struct_mg_setup(jm, d0)
            return jmg.struct_s_apply(jm, jstate, jr), jmg.struct_v_cycle(jm, jstate, jr)

        s_ref, v_ref = jitted(reference, d0, jr)
        assert rel_err(probe.cms.struct_s_apply(mg, state, r), s_ref) < F32_RTOL
        assert rel_err(probe.cms.struct_v_cycle(mg, state, r), v_ref) < F32_RTOL


# -- spe10_level1_cost ---------------------------------------------------------------

L1_GRID = (4, 8, 4)
# Deep float64 solves with a budget of 8 iterations a segment, so the fine
# solve needs a continuation; the float32 V-cycle state of the default in
# place of the production bfloat16 (which parts the packages by rounding).
L1_ARGV = ["--batches", "1", "--dtype", "float64", "--solver-opt", "relative_tolerance=1e-10",
           "--solver-opt", "coefmg_prec_dtype=", "--solver-opt", "max_iterations=8"]
STAGE = re.compile(r"(stage1|cont_c|stage2|cont_f)\s+\S+s it=\s*([\d.]+) conv=([\d.]+)")


def test_level1_cost_matches_the_original(monkeypatch, capsys):
    """Per batch, the stages (the same continuations), their iterations
    (2 or 2 %) and converged fractions, and E[Y] (1e-8 relative) of the
    twin against the JAX original's stage outputs, recorded as it runs."""
    import parelagmc_tpu.problems as jproblems
    import parelagmc_tpu_torch.problems as tproblems

    jmod, tmod = drivers(monkeypatch, "spe10_level1_cost")
    for problems, mod in ((jproblems, jmod), (tproblems, tmod)):
        monkeypatch.setattr(problems, "SPE10_NCELLS", L1_GRID)
        real = mod.load_spe10_kinv
        monkeypatch.setattr(mod, "load_spe10_kinv",
                            lambda perm, ncells, _real=real: _real(perm, ncells=L1_GRID))
    outputs, real_block = [], jax.block_until_ready

    def record(x):
        # The original's stage calls: stage1 returns 7 arrays, the others 5.
        if isinstance(x, tuple) and len(x) in (5, 7):
            outputs.append(x)
        return real_block(x)

    monkeypatch.setattr(jax, "block_until_ready", record)
    capsys.readouterr()
    jmod.main(list(L1_ARGV))
    ref_rows = [STAGE.findall(line) for line in capsys.readouterr().out.splitlines()
                if line.startswith("batch ")]
    ev = tmod.main(L1_ARGV + ["--device", "cpu"])
    assert ev["device"] == "cpu" and ev["batch"] == 128 and ev["segments"] == 4
    assert len(ev["batches"]) == len(ref_rows) == 1
    calls = iter(outputs)
    for row, ref in zip(ev["batches"], ref_rows):
        assert [s["stage"] for s in row["stages"]] == [r[0] for r in ref]
        assert "cont_f" in [r[0] for r in ref] and row["converged"] == 1.0
        qc = q = None
        for s, (_, it, conv) in zip(row["stages"], ref):
            assert close_iterations(s["iterations"], float(it)), (s, it)
            assert abs(s["converged"] - float(conv)) <= 0.005, (s, conv)
            out = next(calls)
            if s["stage"] == "stage1":
                qc = out[4]
            elif s["stage"] == "cont_c":
                qc = out[0]
            else:
                q = out[0]
        e_y = float(np.mean(np.asarray(q, np.float64) - np.asarray(qc, np.float64)))
        np.testing.assert_allclose(row["E_Y"], e_y, rtol=PCG_RTOL)


def test_layout_probe_launches_without_jax(tmp_path):
    """`python -m parelagmc_tpu_torch.examples.spe10_layout_probe --smoke
    --device cpu` runs to its end with neither jax, the JAX package nor the
    root examples package loaded (checked through runpy, as -m runs it)."""
    args = ["--smoke", "--batch", "2", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    code = ("import runpy, sys\n"
            f"sys.argv = ['spe10_layout_probe'] + {args!r}\n"
            f"runpy.run_module('{TWINS}.spe10_layout_probe', run_name='__main__',"
            " alter_sys=True)\n"
            "print('LOADED', sorted(k for k in sys.modules"
            " if k.split('.')[0] in ('jax', 'parelagmc_tpu', 'examples')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "vs current" in out.stdout
    assert out.stdout.splitlines()[-1] == "LOADED []"
