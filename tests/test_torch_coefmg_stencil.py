"""The structured coefMG cycle's fused passes
(parelagmc_tpu_torch/ops/coef_multigrid_structured.py: _cheb_first,
_cheb_step, _jacobi, _residual_restrict, _prolong_add; the kernels of
csrc/coefmg_stencil.cu through ops/coefmg_stencil.py).

On the CPU the passes run as their plain twins, and the cycle built from
them is held bit for bit against the cycle as it was written before the
passes were fused (copied below as `_ref_v_cycle_level`), in float64,
float32 and bfloat16. The tests marked `gpu` hold each kernel against its
plain twin on a card, eagerly and replayed from a CUDA graph. This file
imports no jax, so it also runs on a machine with a card."""

import math

import numpy as np
import pytest
import torch

from _torch_parity import CPU, cuda_device  # noqa: F401
from parelagmc_tpu_torch.mesh import make_box_mesh
from parelagmc_tpu_torch.ops import coef_multigrid_structured as tmg
from parelagmc_tpu_torch.ops import coefmg_stencil
from parelagmc_tpu_torch.utils import trace

BF16 = torch.bfloat16
DTYPES = {"f64": torch.float64, "f32": torch.float32, "bf16": BF16}
# (12, 10, 7): every axis in pairs and tails; (11, 7, 1): tails of 3
# (11 -> 5 -> 2, 7 -> 3 -> 1, as SPE10's 85 -> 42) and a one-cell z axis,
# which every level passes through.
GRIDS = ((12, 10, 7), (11, 7, 1))
VARIANTS = {"cheb3": dict(cheby_order=3, cheby_lo=0.1),
            "jacobi": dict(cheby_order=0),
            "lines": dict(cheby_order=3, cheby_lo=0.1, line_axes=(2, 0))}
# The state's batch against r's: one vector a sample, or the stacked
# solve's singleton right-hand-side axis against two.
LAYOUTS = {"plain": ((2,), (2,)), "stacked": ((2, 1), (2, 2))}
KERNELS = ("coefmg_smooth", "coefmg_restrict", "coefmg_prolong")


# -- the cycle before its passes were fused (verbatim but for the names) -------


def _ref_cheb_smooth_grid(mg, dinv_axes, idiag, b, x):
    lam_max = 2.0
    lam_min = mg.cheby_lo * lam_max
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta
    rho = 1.0 / sigma
    if x is None:
        r = b
        x = torch.zeros_like(b)
    else:
        r = b - tmg._s_apply_grid(dinv_axes, x)
    dvec = (1.0 / theta) * idiag * r
    for _ in range(mg.cheby_order - 1):
        x = x + dvec
        r = r - tmg._s_apply_grid(dinv_axes, dvec)
        rho_new = 1.0 / (2.0 * sigma - rho)
        dvec = (rho_new * rho) * dvec + (2.0 * rho_new / delta) * (idiag * r)
        rho = rho_new
    return x + dvec


def _ref_line_smooth_grid(mg, dinv_axes, lines, b, x, reverse):
    order = list(range(len(mg.line_axes)))
    if reverse:
        order.reverse()
    for i in order:
        a = mg.line_axes[i]
        if x is None:
            x = mg.line_omega * tmg._line_solve(lines[i], b, a)
        else:
            r = b - tmg._s_apply_grid(dinv_axes, x)
            x = x + mg.line_omega * tmg._line_solve(lines[i], r, a)
    return x


def _ref_v_cycle_level(mg, state, b, sweeps, level):
    dinv_axes, idiag, lines = state[level]
    cheby = mg.cheby_order > 0
    use_lines = bool(mg.line_axes) and len(lines) == len(mg.line_axes)
    if level == len(mg.levels) - 1:
        if use_lines:
            x = _ref_line_smooth_grid(mg, dinv_axes, lines, b, None, False)
            x = _ref_line_smooth_grid(mg, dinv_axes, lines, b, x, True)
            for _ in range(max(1, mg.coarse_sweeps // 2) - 1):
                x = _ref_line_smooth_grid(mg, dinv_axes, lines, b, x, False)
                x = _ref_line_smooth_grid(mg, dinv_axes, lines, b, x, True)
            return x
        x = mg.omega * idiag * b
        for _ in range(mg.coarse_sweeps - 1):
            x = x + mg.omega * idiag * (b - tmg._s_apply_grid(dinv_axes, x))
        return x
    if cheby:
        x = _ref_cheb_smooth_grid(mg, dinv_axes, idiag, b, None)
    else:
        x = mg.omega * idiag * b
        for _ in range(sweeps - 1):
            x = x + mg.omega * idiag * (b - tmg._s_apply_grid(dinv_axes, x))
    if use_lines:
        x = _ref_line_smooth_grid(mg, dinv_axes, lines, b, x, reverse=False)
    r = b - tmg._s_apply_grid(dinv_axes, x)
    nxt = mg.levels[level + 1]
    xc = _ref_v_cycle_level(mg, state, tmg._restrict_cells(r, nxt), sweeps, level + 1)
    x = x + tmg._prolong_cells(xc, nxt)
    if use_lines:
        x = _ref_line_smooth_grid(mg, dinv_axes, lines, b, x, reverse=True)
    if cheby:
        return _ref_cheb_smooth_grid(mg, dinv_axes, idiag, b, x)
    for _ in range(sweeps):
        x = x + mg.omega * idiag * (b - tmg._s_apply_grid(dinv_axes, x))
    return x


# -- inputs ---------------------------------------------------------------------


def _mg(grid, variant="cheb3", cutoff=4):
    mesh = make_box_mesh(grid, lengths=(1.2, 2.0, 0.7))
    return mesh, tmg.build_struct_coef_mg(mesh, cutoff=cutoff, **VARIANTS[variant])


def _state(mesh, mg, batch, dtype, device=CPU, seed=0, spread=1.0):
    """Setup state of log-normal face conductances (standard deviation
    `spread`), 0 at a random 10 % (essential faces), set up on `device` in
    float64 (float32 under a bf16 or f32 state, as the solver does, so the
    level-0 face grids stay strided views of the flat face vector) and cast
    to `dtype`. Wider spreads: the known defect of the bf16 line tables
    (tests/test_torch_vcycle_graph.py)."""
    rng = np.random.default_rng(seed)
    d = np.exp(spread * rng.normal(size=batch + (mesh.num_faces,)))
    d[rng.uniform(size=d.shape) < 0.1] = 0.0
    setup = torch.float64 if dtype == torch.float64 else torch.float32
    state = tmg.struct_mg_setup(mg, torch.tensor(d, dtype=setup, device=device))
    return tmg.cast_state(state, dtype) if dtype != setup else state


def _grid_vec(shape, grid, dtype, device=CPU, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape + tuple(grid[::-1]), generator=g, dtype=torch.float64).to(
        device=device, dtype=dtype)


def _counts():
    return dict(trace.counter_values())


def _delta(before, name):
    return trace.counter_values().get(name, 0) - before.get(name, 0)


# -- on the CPU: the plain twins are the cycle as it was -------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_the_cycle_through_its_twins_is_the_cycle_as_it_was(dtype, variant, grid, layout):
    """Bit for bit, level 0 down to the coarsest sweeps (Chebyshev-3 with
    V(2,2) Jacobi beside it, line relaxation on K1's plain version)."""
    mesh, mg = _mg(grid, variant)
    assert len(mg.levels) >= 3
    sbatch, rbatch = LAYOUTS[layout]
    state = _state(mesh, mg, sbatch, DTYPES[dtype])
    b = _grid_vec(rbatch, mg.levels[0].shape, DTYPES[dtype])
    want = _ref_v_cycle_level(mg, state, b, 2, 0)
    before = _counts()
    got = tmg._v_cycle_grid(mg, state, b, 2, 0)
    assert torch.isfinite(want).all() and got.dtype == want.dtype
    assert torch.equal(got, want)
    assert _delta(before, "coefmg.eager_passes") > 0
    assert all(_delta(before, f"kernel.{k}") == 0 for k in KERNELS)


def _passes_per_cycle(mg, sweeps=2):
    """The fused passes of one cycle without line relaxation: per level
    above the coarsest a pre- and a post-smoothing sweep (Chebyshev: a first
    step and order - 1 steps; Jacobi: `sweeps` sweeps each), the residual
    with its restriction and the prolongation; the coarsest level's
    sweeps."""
    smooth = 2 * mg.cheby_order if mg.cheby_order > 0 else 2 * sweeps
    return (len(mg.levels) - 1) * (smooth + 2) + mg.coarse_sweeps


@pytest.mark.parametrize("variant", ["cheb3", "jacobi"])
def test_a_cycle_counts_its_passes(variant):
    mesh, mg = _mg(GRIDS[0], variant)
    state = _state(mesh, mg, (2,), BF16)
    before = _counts()
    tmg._v_cycle_grid(mg, state, _grid_vec((2,), mg.levels[0].shape, BF16), 2, 0)
    assert _delta(before, "coefmg.eager_passes") == _passes_per_cycle(mg)


def test_a_cpu_solve_counts_eager_passes_and_no_kernel():
    """The SPE10 cells' solver (bf16 Chebyshev-3 coefMG) on a small box:
    every cycle of the solve ran its passes as plain twins."""
    from test_torch_vcycle_graph import _fields, _problem, _solves

    prob = _problem(CPU)
    before = _counts()
    _solves(prob.solver, _fields(prob))
    cycles = _delta(before, "coefmg.eager_cycles")
    assert cycles > 0
    mg = prob.solver.levels[0].coef_mg
    assert _delta(before, "coefmg.eager_passes") == cycles * _passes_per_cycle(mg)
    assert all(_delta(before, f"kernel.{k}") == 0 for k in KERNELS)


def test_the_launchers_refuse_what_the_kernels_do_not_take():
    mesh, mg = _mg(GRIDS[0])
    (dinv_axes, idiag, _), = _state(mesh, mg, (2,), torch.float32)[:1]
    b = _grid_vec((2,), mg.levels[0].shape, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        coefmg_stencil.smooth(coefmg_stencil.JACOBI, dinv_axes, idiag, b, w=0.8)
    with pytest.raises(TypeError, match="dtype"):
        coefmg_stencil.prolong_add(b.to(torch.int32), b.to(torch.int32), mg.levels[0].shape,
                                   mg.levels[0].shape)


# -- on a card: each kernel against its plain twin --------------------------------


def _ulp(t: torch.Tensor) -> float:
    """One bfloat16 ulp at t's largest magnitude."""
    m = float(t.double().abs().max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


KERNEL_FNS = (tmg._cheb_first, tmg._cheb_step, tmg._jacobi, tmg._residual_restrict,
              tmg._prolong_add)
TWIN_FNS = (tmg._cheb_first_plain, tmg._cheb_step_plain, tmg._jacobi_plain,
            tmg._residual_restrict_plain, tmg._prolong_add_plain)


def _passes(mg, state, level, rbatch, dtype, device):
    """Every fused pass of one grid level, as (name, call): call(fns, cast)
    runs the pass with fns (KERNEL_FNS or TWIN_FNS) on the level's state
    and fixed vectors, each tensor passed through `cast`, and returns the
    tensors it made."""
    dinv_axes, idiag, _ = state[level]
    shape = mg.levels[level].shape
    b, x, r, dvec = (_grid_vec(rbatch, shape, dtype, device, seed=s) for s in (1, 2, 3, 4))
    a, c, w = 0.61, 0.37, 0.8
    calls = {
        "first": lambda f, k: f[0](k(dinv_axes), k(idiag), k(b), k(x), w),
        "first, x zero": lambda f, k: f[0](k(dinv_axes), k(idiag), k(b), None, w)[1:],
        "step": lambda f, k: f[1](k(dinv_axes), k(idiag), k(x), k(r), k(dvec), a, c, False),
        "step, x zero": lambda f, k: f[1](k(dinv_axes), k(idiag), None, k(r), k(dvec), a, c,
                                          False),
        "last step": lambda f, k: (f[1](k(dinv_axes), k(idiag), k(x), k(r), k(dvec), a, c,
                                        True),),
        "jacobi": lambda f, k: (f[2](k(dinv_axes), k(idiag), k(b), k(x), w),),
        "jacobi, x zero": lambda f, k: (f[2](k(dinv_axes), k(idiag), k(b), None, w),),
        "residual": lambda f, k: (f[3](k(dinv_axes), k(b), k(x), None),),
    }
    if level + 1 < len(mg.levels):
        nxt = mg.levels[level + 1]
        xc = _grid_vec(rbatch, nxt.shape, dtype, device, seed=5)
        calls["residual, restricted"] = lambda f, k: (f[3](k(dinv_axes), k(b), k(x), nxt),)
        calls["prolongation"] = lambda f, k: (f[4](k(x), k(xc), nxt),)
    return calls


def _same(t):
    return t


def _f32(t):
    return tuple(_f32(u) for u in t) if isinstance(t, tuple) else t.float()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", ["f32", "f64", "bf16"])
def test_each_kernel_is_its_twin_on_the_card(cuda_device, dtype, layout):
    """On every level of two ladders (tails of 3, a passthrough axis).
    float32 and float64 to 1e-6 and 1e-14 of the largest value (the kernels
    run the twins' operations one for one). bfloat16: against the twin run
    in float32 on the same bf16 inputs and rounded, within 1 ulp at the
    largest value (the kernel rounds once where it stores; a stored r or x
    that the same step reads again differs from the twin's unrounded one by
    half an ulp); against the twin in bf16 within 8 ulps there (the twin
    rounds each of the ~17 intermediate results of an S apply to bf16)."""
    sbatch, rbatch = LAYOUTS[layout]
    rtol = {"f32": 1e-6, "f64": 1e-14}.get(dtype)
    for grid in GRIDS:
        mesh, mg = _mg(grid)
        state = _state(mesh, mg, sbatch, DTYPES[dtype], cuda_device)
        for level in range(len(mg.levels)):
            for name, call in _passes(mg, state, level, rbatch, DTYPES[dtype],
                                      cuda_device).items():
                before = _counts()
                got = call(KERNEL_FNS, _same)
                assert sum(_delta(before, f"kernel.{k}") for k in KERNELS) == 1, name
                assert _delta(before, "coefmg.eager_passes") == 0, name
                refs = [(call(TWIN_FNS, _same), 8 if rtol is None else None)]
                if rtol is None:
                    refs.append((tuple(t.to(BF16) for t in call(TWIN_FNS, _f32)), 1))
                for want, ulps in refs:
                    for g, w in zip(got, want):
                        assert g.shape == w.shape and g.dtype == w.dtype and g.is_cuda, name
                        assert torch.isfinite(g).all(), name
                        err = float((g.double() - w.double()).abs().max())
                        bound = (rtol * float(w.double().abs().max()) if ulps is None
                                 else ulps * _ulp(w))
                        assert err <= bound, (name, level, err, bound)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_each_kernel_replays_from_a_graph_as_it_runs_eagerly(cuda_device, dtype):
    """Captured into a CUDA graph, its outputs cleared and replayed: bit
    for bit the eager launch (the stacked layout, every level)."""
    sbatch, rbatch = LAYOUTS["stacked"]
    mesh, mg = _mg(GRIDS[1])
    state = _state(mesh, mg, sbatch, DTYPES[dtype], cuda_device)
    for level in range(len(mg.levels)):
        for name, call in _passes(mg, state, level, rbatch, DTYPES[dtype],
                                  cuda_device).items():
            eager = call(KERNEL_FNS, _same)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                call(KERNEL_FNS, _same)
            torch.cuda.current_stream().wait_stream(side)
            before = _counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = call(KERNEL_FNS, _same)
            assert sum(_delta(before, f"kernel.{k}") for k in KERNELS) == 1, name
            for t in out:
                t.zero_()
            graph.replay()
            torch.cuda.synchronize()
            for g, w in zip(out, eager):
                assert torch.equal(g, w), (name, level)
