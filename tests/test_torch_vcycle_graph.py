"""The structured coefMG cycle replayed as a CUDA graph
(parelagmc_tpu_torch/ops/coef_multigrid_structured.py: GraphedVCycle,
VCycleGraphs) and the Darcy preconditioner that uses it.

On the CPU the graph is stood in for by a fake that reruns the captured
function into its output: that holds the capture policy (a key's second
solve), the cache key, the state loading, the fresh tensor per call and
the launch-count accounting, and shows that a CPU solve stays eager. The
tests marked `gpu` capture real graphs on a card and hold them bit for bit
against the eager cycle and solve. This file imports no jax, so it also
runs on a machine with a card."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import CPU, cuda_device  # noqa: F401
from parelagmc_tpu_torch.config import ProblemConfig, SolverConfig
from parelagmc_tpu_torch.mesh import make_box_mesh
from parelagmc_tpu_torch.ops import coef_multigrid_structured as tmg
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.utils import trace

BF16 = torch.bfloat16
GRID = (12, 10, 7)
# The SPE10 cells' V-cycle (bf16 Chebyshev-3), and the same with line
# relaxation on K1.
MG = {"cheb3": dict(cheby_order=3, cheby_lo=0.1),
      "lines": dict(cheby_order=3, cheby_lo=0.1, line_axes=(2, 0))}


class FakeGraph:
    """A CUDA graph's stand-in on the CPU: a replay reruns the captured
    function into the output the capture returned."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        self.out.copy_(self.fn())


@pytest.fixture
def fake_graphs(monkeypatch):
    """Graphs on the CPU; `launches` K1 launches recorded by each capture."""
    state = {"launches": 0}

    def capture(fn):
        out = fn()
        trace.counters("kernel")["thomas"] += state["launches"]
        return FakeGraph(fn, out), out

    monkeypatch.setattr(tmg, "_graphable", lambda r: True)
    monkeypatch.setattr(tmg, "_warm_up", lambda fn, device: None)
    monkeypatch.setattr(tmg, "_capture_graph", lambda fn, device: capture(fn))
    return state


def _mg(variant="cheb3", grid=GRID, cutoff=5):
    mesh = make_box_mesh(grid, lengths=(1.2, 2.0, 0.7))
    return mesh, tmg.build_struct_coef_mg(mesh, cutoff=cutoff, **MG[variant])


def _state(mesh, mg, batch=(2,), seed=0, device=CPU, pdt=BF16, spread=3.0,
           dtype=torch.float32):
    """Setup state (in `dtype`) of positive face conductances, log-normal
    with standard deviation `spread` (3: over 6 decades), 0 at a random
    10 % (essential faces), cast to pdt."""
    rng = np.random.default_rng(seed)
    d = np.exp(spread * rng.normal(size=batch + (mesh.num_faces,)))
    d[rng.uniform(size=d.shape) < 0.1] = 0.0
    state = tmg.struct_mg_setup(mg, torch.tensor(d, dtype=dtype, device=device))
    return tmg.cast_state(state, pdt) if pdt is not None else state


def _r(mesh, shape=(2,), seed=1, device=CPU, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape + (mesh.num_cells,), generator=g, dtype=dtype).to(device)


def _counts():
    return dict(trace.counter_values())


def _delta(before, name):
    return trace.counter_values().get(name, 0) - before.get(name, 0)


def test_a_key_is_captured_on_its_second_solve_and_loads_each_solves_state(fake_graphs):
    mesh, mg = _mg()
    states = [_state(mesh, mg, seed=s) for s in range(3)]
    r1, r2 = _r(mesh, seed=1), _r(mesh, seed=2)
    eager = lambda s, r: tmg.struct_cycle(mg, s, r, 2, BF16)
    graphs = tmg.VCycleGraphs()
    before = _counts()
    first = graphs.cycle(mg, states[0], 2, BF16)
    assert torch.equal(first(r1), eager(states[0], r1))
    assert torch.equal(first(r2), eager(states[0], r2))
    assert graphs.graphs == {} and _delta(before, "coefmg.eager_cycles") == 2
    second = graphs.cycle(mg, states[1], 2, BF16)
    assert torch.equal(second(r1), eager(states[1], r1))  # captured here
    assert _delta(before, "coefmg.graph_captures") == 1 and len(graphs.graphs) == 1
    assert torch.equal(second(r2), eager(states[1], r2))
    third = graphs.cycle(mg, states[2], 2, BF16)
    assert torch.equal(third(r1), eager(states[2], r1))  # this solve's state, loaded
    assert torch.equal(second(r2), eager(states[1], r2))  # and back, if they interleave
    assert _delta(before, "coefmg.graph_replays") == 4
    assert _delta(before, "coefmg.graph_captures") == 1
    # Another shape is another key: eager on its first solve.
    single = graphs.cycle(mg, _state(mesh, mg, batch=(1,)), 2, BF16)
    single(_r(mesh, shape=(1,)))
    assert _delta(before, "coefmg.eager_cycles") == 3 and len(graphs.graphs) == 1
    assert sorted(graphs.solves.values()) == [1, 3]


def test_two_calls_return_two_tensors(fake_graphs):
    """pcg keeps its first z as p across the next preconditioner call."""
    mesh, mg = _mg()
    graphs = tmg.VCycleGraphs()
    graphs.cycle(mg, _state(mesh, mg), 2, BF16)(_r(mesh))
    cycle = graphs.cycle(mg, _state(mesh, mg, seed=1), 2, BF16)
    z1 = cycle(_r(mesh, seed=1))
    kept = z1.clone()
    z2 = cycle(_r(mesh, seed=2))
    assert z1.data_ptr() != z2.data_ptr() and torch.equal(z1, kept)
    assert not torch.equal(z1, z2)


def test_each_replay_counts_the_launches_its_capture_recorded(fake_graphs):
    fake_graphs["launches"] = 3
    mesh, mg = _mg("lines")
    state = _state(mesh, mg)
    r = _r(mesh)
    before = _counts()
    graph = tmg.GraphedVCycle(mg, state, r, 2, BF16)
    assert graph.launches == {"thomas": 3} and _delta(before, "kernel.thomas") == 0
    for k in range(1, 4):
        graph(r)
        assert _delta(before, "kernel.thomas") == 3 * k
    assert _delta(before, "coefmg.graph_replays") == 3


def test_past_max_graphs_the_least_recently_used_graph_goes(fake_graphs, monkeypatch):
    monkeypatch.setattr(tmg, "MAX_GRAPHS", 2)
    mesh, mg = _mg()
    graphs = tmg.VCycleGraphs()

    def solve(batch, seed=0):
        cycle = graphs.cycle(mg, _state(mesh, mg, batch=(batch,), seed=seed), 2, BF16)
        r = _r(mesh, shape=(batch,), seed=seed)
        return cycle(r), tmg.struct_cycle(mg, _state(mesh, mg, batch=(batch,), seed=seed), r,
                                          2, BF16)

    for batch in (1, 2, 3):
        solve(batch)
    before = _counts()
    for batch in (1, 2):
        solve(batch, seed=1)  # captures 1, then 2
    solve(1, seed=2)  # replays 1: now the more recently used
    solve(3, seed=1)  # captures 3 and drops 2
    assert [k[3][0] for k in graphs.graphs] == [1, 3]
    assert _delta(before, "coefmg.graph_captures") == 3
    z, want = solve(2, seed=3)  # recaptured at once (its third solve), drops 1
    assert torch.equal(z, want) and [k[3][0] for k in graphs.graphs] == [3, 2]
    assert _delta(before, "coefmg.graph_captures") == 4
    assert _delta(before, "coefmg.eager_cycles") == 0


def test_the_cache_key_separates_shapes_dtypes_and_settings():
    mesh, mg = _mg()
    s2, r2 = _state(mesh, mg, batch=(3, 2)), _r(mesh, shape=(3, 2))
    stacked = _state(mesh, mg, batch=(3, 1))
    key = tmg.cycle_key(mg, s2, r2, 2, BF16)
    assert key == tmg.cycle_key(mg, _state(mesh, mg, batch=(3, 2), seed=5), r2.clone(), 2, BF16)
    others = [tmg.cycle_key(mg, stacked, r2, 2, BF16),  # the stacked solve's state
              tmg.cycle_key(mg, s2, r2.double(), 2, BF16),
              tmg.cycle_key(mg, s2, r2, 3, BF16),
              tmg.cycle_key(mg, _state(mesh, mg, batch=(3, 2), pdt=None), r2, 2, None),
              tmg.cycle_key(_mg("lines")[1], s2, r2, 2, BF16)]
    assert len({key, *others}) == 1 + len(others)
    hash(key)


SOLVERS = {
    "production": {},
    "stacked": dict(adjoint_stacked=True),
    "cycles2": dict(coefmg_cycles=2),
    "lines": dict(coefmg_line_axes="x"),
    # The state in the solve's own dtype (no cast): the f64 SPE10 anchor's.
    "f32": dict(coefmg_prec_dtype=""),
    "f64": dict(dtype="float64", coefmg_prec_dtype=""),
}


def _problem(device, dtype="float32", **solver_kw):
    """A 12 x 20 x 8 box hierarchy under the SPE10 cells' solver: coefMG
    with a bf16 Chebyshev-3 V-cycle over several grid levels, adjoint QoI,
    mean-field x0; the problem in `dtype`."""
    solver = SolverConfig(name="cg-schur-coefmg", max_iterations=75, relative_tolerance=1e-4,
                          adjoint_qoi=True, coefmg_cheby_order=3, coefmg_cheby_lo=0.1,
                          coefmg_prec_dtype="bfloat16", meanfield_x0=True,
                          coarse_dense_cutoff=4)
    solver = dataclasses.replace(solver, **solver_kw)
    cfg = ProblemConfig(mesh="box", ncells=(6, 10, 4), lengths=(1.2, 2.0, 0.8), refinements=1,
                        sampler_name="pde", correlation_length=0.3, variance=1.0,
                        lognormal=True, qoi="eff_perm", ess_attr=(0, 1, 1, 1, 1, 0),
                        obs_attr=(1, 0, 0, 0, 0, 0), inflow_attr=(0, 0, 0, 0, 0, 1),
                        batch_size=4, dtype=dtype, cost_model="dofs", output_filename="",
                        darcy_solver=solver)
    return build_problem(cfg, device=device)


def _fields(prob, n=3, batch=4):
    """n batches of log-normal coefficient fields at level 0."""
    g = torch.Generator().manual_seed(7)
    n_s = prob.solver.levels[0].n_s
    return [torch.exp(torch.randn(batch, n_s, generator=g, dtype=prob.dtype)).to(prob.solver.device)
            for _ in range(n)]


def _solves(solver, ws):
    return [solver.solve_fwd(0, w)[::2] for w in ws]  # (Q, info)


def _same_solves(got, want):
    for (q, info), (q0, info0) in zip(got, want):
        assert torch.equal(q, q0)
        assert info.iterations == info0.iterations > 0
        assert torch.equal(info.residual, info0.residual)


def test_a_cpu_solve_stays_eager_and_counts_every_cycle(monkeypatch):
    prob = _problem(CPU)

    def no_capture(fn):
        raise AssertionError("a CPU solve attempted a capture")

    calls = []
    eager = tmg.struct_cycle
    monkeypatch.setattr(tmg, "_capture_graph", no_capture)
    monkeypatch.setattr(tmg, "struct_cycle", lambda *a: calls.append(1) or eager(*a))
    before = _counts()
    _solves(prob.solver, _fields(prob))
    assert _delta(before, "coefmg.eager_cycles") == len(calls) > 0
    assert _delta(before, "coefmg.graph_captures") == _delta(before, "coefmg.graph_replays") == 0
    assert prob.solver._vcycle_graphs.graphs == {} == prob.solver._vcycle_graphs.solves


@pytest.mark.parametrize("variant", list(SOLVERS))
def test_graphed_solves_equal_eager_ones(variant, monkeypatch, fake_graphs):
    """The preconditioner's bookkeeping (state loaded per solve, primal and
    adjoint sharing it, composed cycles, the stacked key) leaves Q and the
    iterations as the eager solve has them."""
    prob = _problem(CPU, **SOLVERS[variant])
    ws = _fields(prob)
    monkeypatch.setattr(tmg, "_graphable", lambda r: False)
    want = _solves(prob.solver, ws)
    monkeypatch.setattr(tmg, "_graphable", lambda r: True)
    before = _counts()
    _same_solves(_solves(prob.solver, ws), want)
    assert _delta(before, "coefmg.graph_captures") == 1
    assert _delta(before, "coefmg.graph_replays") > _delta(before, "coefmg.eager_cycles") > 0


# -- on a card ---------------------------------------------------------------------


# The cycle's precisions: (setup dtype, state dtype pdt, r's dtype). bf16 is
# the SPE10 cells'; None keeps the setup's dtype, as the f64 SPE10 anchor does.
PRECISIONS = {"bf16": (torch.float32, BF16, torch.float32),
              "f32": (torch.float32, None, torch.float32),
              "f64": (torch.float64, None, torch.float64)}


@pytest.mark.parametrize("stacked", [False, True])
def test_bf16_line_tables_of_six_decades_are_a_known_defect(stacked):
    """A known defect of the bf16 line state, not of the graphs (PERF.md
    section 7): cast_state rounds the line tables dl, dd, du to bfloat16 one
    by one, so where conductances span ~6 decades (spread 3) rows of T_a
    lose diagonal dominance (dd < |dl| + |du|), a Thomas pivot falls to ~0
    and the eager cycle turns non-finite, stacked or not. The same
    state in float32 keeps every row dominant and the cycle finite. The
    card tests below hold the graphs to the eager cycle at spread 1. Turn
    this test round when the cast is cured."""
    mesh, mg = _mg("lines")
    batch, rhs = ((2, 1), (2, 2)) if stacked else ((2,), (2,))
    s32 = _state(mesh, mg, batch=batch, pdt=None)
    r = _r(mesh, shape=rhs)

    def lost(state):
        n = 0
        for _, _, lines in state:
            for dl, dd, du in lines:
                dl, dd, du = dl.float(), dd.float(), du.float()
                off = torch.zeros_like(dd)
                off[1:] += dl[1:].abs()
                off[:-1] += du[:-1].abs()
                n += int((dd < off).sum())
        return n

    assert lost(s32) == 0 and torch.isfinite(tmg.struct_cycle(mg, s32, r, 2, None)).all()
    sbf = tmg.cast_state(s32, BF16)
    assert lost(sbf) > 0 and not torch.isfinite(tmg.struct_cycle(mg, sbf, r, 2, BF16)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("variant,batch,rhs,prec", [
    ("cheb3", (8,), (8,), "bf16"), ("lines", (8,), (8,), "bf16"), ("cheb3", (4, 1), (4, 2), "bf16"),
    ("cheb3", (8,), (8,), "f32"), ("cheb3", (8,), (8,), "f64"), ("lines", (4, 1), (4, 2), "f64")])
def test_graphed_cycle_is_the_eager_cycle_on_the_card(cuda_device, variant, batch, rhs, prec):
    """Bit for bit against struct_cycle, on a second solve's state after
    `load`, a fresh tensor per call, and K1 launches counted per replay as
    the eager cycle counts them (line relaxation); the stacked state's
    singleton axis against two right-hand sides; a bf16 state and states in
    f32 and f64 (no cast). Conductances over ~2 decades: the bf16 line
    tables of wider ones are the known defect above."""
    mesh, mg = _mg(variant, grid=(30, 44, 17), cutoff=50)
    setup, pdt, rdt = PRECISIONS[prec]
    s1, s2 = (_state(mesh, mg, batch=batch, seed=s, device=cuda_device, pdt=pdt, spread=1.0,
                     dtype=setup) for s in (0, 1))
    r1, r2 = (_r(mesh, shape=rhs, seed=s, device=cuda_device, dtype=rdt) for s in (1, 2))
    before = _counts()
    want1 = tmg.struct_cycle(mg, s1, r1, 2, pdt)
    assert torch.isfinite(want1).all() and want1.dtype == rdt
    per_cycle = _delta(before, "kernel.thomas")
    assert (per_cycle > 0) == (variant == "lines")
    graph = tmg.GraphedVCycle(mg, s1, r1, 2, pdt)
    before = _counts()
    z1 = graph(r1)
    assert torch.equal(z1, want1) and _delta(before, "kernel.thomas") == per_cycle
    graph.load(s2)
    z2 = graph(r2)
    assert torch.equal(z2, tmg.struct_cycle(mg, s2, r2, 2, pdt))
    assert z1.data_ptr() != z2.data_ptr() and torch.equal(z1, want1)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(SOLVERS))
def test_graphed_solves_equal_eager_ones_on_the_card(cuda_device, variant, monkeypatch):
    prob = _problem(cuda_device, **SOLVERS[variant])
    ws = _fields(prob)
    monkeypatch.setattr(tmg, "_graphable", lambda r: False)
    want = _solves(prob.solver, ws)
    monkeypatch.undo()
    before = _counts()
    _same_solves(_solves(prob.solver, ws), want)
    assert _delta(before, "coefmg.graph_captures") == 1
    assert _delta(before, "coefmg.graph_replays") > _delta(before, "coefmg.eager_cycles") > 0
