"""Per-sample Galerkin Schur multigrid on tensor grids (slicing form).

Port of parelagmc_tpu/ops/coef_multigrid_structured.py (see its docstring
and ops/coef_multigrid.py for the derivation). The preconditioner for the
pressure Schur complement S(w) = B M(w)^{-1} B^T is rebuilt per sample from
the masked mass-diagonal inverse dinv0 (one value per face, 0 at essential
faces): every MG level's per-axis face conductances follow from dinv0 by
static plane selection (Galerkin P0 RAP) or series composition (harmonic)
along the face axis and group sums across it, so the whole coefficient
dependence is a handful of face vectors per level. In plain PyTorch every
operation is a slice, a pad, a reshape-sum or a repeat:

* S x on the cell grid: flux t_k = dinv_k (x_{k-1} - x_k) with a zero pad,
  then (S x)_i = t_{i+1} - t_i, per axis;
* the Jacobi diagonal is d_i + d_{i+1} summed over axes;
* restriction / prolongation are per-axis group sums / repeats over groups
  of 2 with a trailing group of 2 or 3 (fem/hierarchy.derefine_axis);
* smoothers: damped Jacobi V(s, s), order-k Chebyshev(Jacobi), and line
  relaxation along `line_axes`, whose tridiagonal solves run on kernel K1
  (ops/tridiag_pallas.thomas: its (n, L) solved-axis-first layout, the
  special case of the kernel's strided lines).

Layout: cell grids are (batch..., z, y, x) with mesh axis a at array dim
ndim - 1 - a, as in the reference. The line tables are built once per solve
with the SOLVED axis first, (n_a, batch..., others...) contiguous - the
(n, L) layout K1 reads coalesced - so no sweep permutes them; the
right-hand side of each line solve is moved into that layout and back.

A SolverConfig's coefMG settings are read here alone (`ladder_settings`,
`struct_coef_mg_for`, `cycle_settings`), for physics/darcy.py and
parallel/spatial_darcy.py alike.

The reference's MISCOMPILE GUARD (moveaxis forms of the transfer helpers)
worked around XLA:TPU and is not carried over: the helpers below act on the
axis in place.

The cycle runs its grid passes through five fused steps (`_cheb_first`,
`_cheb_step`, `_jacobi`, `_residual_restrict`, `_prolong_add`): on a card
each is one hand-written kernel (csrc/coefmg_stencil.cu, launched by
ops/coefmg_stencil.py; counters `kernel.coefmg_smooth`,
`kernel.coefmg_restrict`, `kernel.coefmg_prolong`), about 30 launches a
cycle; on the CPU each is its plain twin, the same arithmetic in the
PyTorch ops above (counter `coefmg.eager_passes`).

A cycle has no data-dependent host read, so on a card the Darcy
preconditioner replays it as one CUDA graph (`GraphedVCycle`): the same
kernels in the same order on every call, issued by one launch.
`VCycleGraphs` holds a solver's graphs by the shapes and settings they were
captured for; the first solve of each key runs eagerly, its second captures,
and every later one loads its state into the graph's static copy and
replays; past MAX_GRAPHS keys the least recently used graph is dropped.
CPU tensors, and a call made while a capture is under way, run
eagerly. Counters `coefmg.graph_captures`, `coefmg.graph_replays`,
`coefmg.eager_cycles`; span `coefmg.replay` around each replayed cycle.
"""

from __future__ import annotations

import collections
import itertools
import warnings
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from parelagmc_tpu_torch.fem.hierarchy import derefine_axis
from parelagmc_tpu_torch.mesh.structured import StructuredMesh
from parelagmc_tpu_torch.ops import coefmg_stencil
from parelagmc_tpu_torch.ops.coef_multigrid import in_precision
from parelagmc_tpu_torch.ops.tridiag_pallas import thomas
from parelagmc_tpu_torch.utils import trace

_COEFMG = trace.counters("coefmg")
_KERNEL = trace.counters("kernel")
# A key's graph is captured on its second solve: one-off shapes (the
# mean-field start's single sample) never hold a graph's memory. A solver
# keeps at most MAX_GRAPHS graphs (a few hundred MB each at the SPE10
# cells' shapes) and drops the least recently used one past that.
CAPTURE_AT_SOLVE = 2
MAX_GRAPHS = 8


class StructMGLevel(NamedTuple):
    shape: Tuple[int, ...]  # cells per mesh axis (x first)
    # Cells per mesh axis of the previous (finer) level, grouped onto this
    # level's cells as [2]*(n_c - 1) + [tail]; () on level 0.
    fine_shape: Tuple[int, ...] = ()


class StructCoefMG(NamedTuple):
    levels: Tuple[StructMGLevel, ...]
    face_offsets: Tuple[int, ...]  # level-0 flat face-vector offsets
    omega: float
    coarse_sweeps: int
    cheby_order: int = 0
    cheby_lo: float = 0.25
    line_axes: Tuple[int, ...] = ()  # mesh axes of the line smoother
    line_omega: float = 1.0
    coarsen: str = "galerkin"  # "galerkin" (plane select) | "harmonic" (series)


def build_struct_coef_mg(mesh, cutoff: int = 5000, coarse_sweeps: int = 8, omega: float = 0.8,
                         cheby_order: int = 0, cheby_lo: float = 0.25,
                         line_axes: Tuple[int, ...] = (), line_omega: float = 1.0,
                         coarsen: str = "galerkin") -> StructCoefMG:
    """MG level shapes below `mesh` (a StructuredMesh), derefining by 2 per
    axis until <= cutoff cells (the reference's ladder)."""
    meshes = [mesh]
    while meshes[-1].num_cells > cutoff and max(meshes[-1].shape) > 2:
        meshes.append(StructuredMesh([derefine_axis(a) for a in meshes[-1].axes]))
    levels = [StructMGLevel(shape=tuple(int(s) for s in meshes[0].shape))]
    for l in range(1, len(meshes)):
        levels.append(StructMGLevel(shape=tuple(int(s) for s in meshes[l].shape),
                                    fine_shape=tuple(int(s) for s in meshes[l - 1].shape)))
    return StructCoefMG(
        levels=tuple(levels),
        face_offsets=tuple(int(x) for x in mesh.face_offsets),
        omega=float(omega),
        coarse_sweeps=int(coarse_sweeps),
        cheby_order=int(cheby_order),
        cheby_lo=float(cheby_lo),
        line_axes=tuple(int(a) for a in line_axes),
        line_omega=float(line_omega),
        coarsen=str(coarsen),
    )


def ladder_settings(scfg, slabs: Optional[int] = None) -> dict:
    """The ladder keywords of SolverConfig `scfg` that build_struct_coef_mg
    and the gather form's build_coef_mg share. For one of `slabs` y-slabs of
    the spatially sharded solve the coarsest size scales with 1/slabs (at
    least 256), so the slabs' coarsest levels add up to the whole grid's."""
    cutoff = scfg.coarse_dense_cutoff
    if slabs is not None:
        cutoff = max(256, int(cutoff) // slabs)
    return dict(cutoff=cutoff, coarse_sweeps=max(1, scfg.mg_coarse_sweeps),
                omega=scfg.coefmg_omega, cheby_order=scfg.coefmg_cheby_order,
                cheby_lo=scfg.coefmg_cheby_lo)


def struct_coef_mg_for(mesh, scfg, kinv: Optional[np.ndarray] = None,
                       slabs: Optional[int] = None) -> StructCoefMG:
    """The StructCoefMG ladder of SolverConfig `scfg` below `mesh`, its line
    axes parsed against `mesh` and `kinv`. On one of `slabs` y-slabs (see
    ladder_settings) "auto" line axes, which need the reference
    coefficient, warn and run without line relaxation."""
    spec = scfg.coefmg_line_axes
    if slabs is not None and spec.strip().lower() == "auto":
        warnings.warn(
            "coefmg_line_axes='auto' is unavailable on the spatially-sharded path (auto "
            "selection needs the reference coefficient); running WITHOUT line relaxation. "
            "Pass explicit letters (e.g. 'xz') to keep line smoothing under spatial_shards.",
            stacklevel=3)
        spec = ""
    return build_struct_coef_mg(mesh, line_axes=parse_line_axes(spec, mesh, kinv),
                                line_omega=scfg.coefmg_line_omega, coarsen=scfg.coefmg_coarsen,
                                **ladder_settings(scfg, slabs))


class CycleSettings(NamedTuple):
    """The per-solve settings of a SolverConfig's coefMG preconditioner."""

    sweeps: int  # pre/post Jacobi sweeps a grid level (coefmg_sweeps, at least 1)
    cycles: int  # V-cycles composed a preconditioner apply (coefmg_cycles, at least 1)
    dtype: Optional[torch.dtype]  # the state's (coefmg_prec_dtype; None: the solve's own)


PREC_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
               "float64": torch.float64}


def cycle_settings(scfg) -> CycleSettings:
    """SolverConfig `scfg`'s CycleSettings; an unknown coefmg_prec_dtype
    raises ValueError."""
    name = scfg.coefmg_prec_dtype
    if name and name not in PREC_DTYPES:
        raise ValueError(f"coefmg_prec_dtype {name!r}: expected one of {sorted(PREC_DTYPES)}")
    return CycleSettings(max(1, int(scfg.coefmg_sweeps)), max(1, int(scfg.coefmg_cycles)),
                         PREC_DTYPES[name] if name else None)


def parse_line_axes(spec: str, mesh, kinv: Optional[np.ndarray]) -> Tuple[int, ...]:
    """config.coefmg_line_axes -> mesh-axis tuple (the reference's
    physics/darcy._parse_line_axes). Letters x/y/z name the solver mesh's
    axes; "auto" keeps every axis whose kinv-weighted mean face conductance
    A / (h * kinv_axis) is >= 3x the weakest axis's mean."""
    spec = (spec or "").strip().lower()
    if not spec:
        return ()
    d = len(mesh.shape)
    if spec == "auto":
        if kinv is None:
            return ()
        vol = np.asarray(mesh.cell_volumes()).reshape(tuple(int(n) for n in mesh.shape[::-1]))
        means = []
        for a in range(d):
            h = np.diff(np.asarray(mesh.axes[a]))
            hg = h.reshape((1,) * (d - 1 - a) + (-1,) + (1,) * a)
            cond = (vol / hg) / (hg * np.asarray(kinv)[:, a].reshape(vol.shape))
            means.append(float(cond.mean()))
        lo = min(means)
        return tuple(a for a in range(d) if means[a] >= 3.0 * lo)
    letters = {"x": 0, "y": 1, "z": 2}
    axes = []
    for ch in spec:
        if ch not in letters or letters[ch] >= d:
            raise ValueError(
                f"coefmg_line_axes {spec!r}: unknown axis {ch!r} for a {d}-D mesh "
                "(use letters from 'xyz'[:d] or 'auto')"
            )
        axes.append(letters[ch])
    return tuple(axes)


# -- static axis helpers (axis = array dim of the mesh axis) -----------------


def _arr_ax(x: torch.Tensor, a: int) -> int:
    return x.ndim - 1 - a


def _strided(x: torch.Tensor, axis: int, start: int, stop: int, step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, stop, step)
    return x[tuple(idx)]


def _group_sum(x: torch.Tensor, axis: int, n_f: int, n_c: int) -> torch.Tensor:
    """Sum groups of [2]*(n_c - 1) + [tail] along `axis`."""
    if n_c == n_f:  # passthrough axis (already 1-2 cells)
        return x
    main = x.narrow(axis, 0, 2 * (n_c - 1)).unflatten(axis, (n_c - 1, 2)).sum(axis + 1)
    tail = x.narrow(axis, 2 * (n_c - 1), n_f - 2 * (n_c - 1)).sum(axis, keepdim=True)
    return torch.cat([main, tail], dim=axis)


def _repeat_groups(x: torch.Tensor, axis: int, n_f: int, n_c: int) -> torch.Tensor:
    """Adjoint structure of _group_sum: repeat each coarse entry over its
    group, n_c -> n_f entries."""
    if n_c == n_f:
        return x
    main = x.narrow(axis, 0, n_c - 1).repeat_interleave(2, dim=axis)
    tail = x.narrow(axis, n_c - 1, 1).repeat_interleave(n_f - 2 * (n_c - 1), dim=axis)
    return torch.cat([main, tail], dim=axis)


def _plane_select(x: torch.Tensor, axis: int, n_f: int, n_c: int) -> torch.Tensor:
    """Coarse face planes of one axis: fine planes 0, 2, ..., 2(n_c-1), n_f."""
    if n_c == n_f:
        return x
    return torch.cat([_strided(x, axis, 0, 2 * (n_c - 1) + 1, 2), x.narrow(axis, n_f, 1)],
                     dim=axis)


def _series(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Conductances in series, ab/(a+b); a blocked (0) face stays blocked."""
    s = a + b
    pos = s > 0
    return torch.where(pos, a * b / torch.where(pos, s, torch.ones_like(s)), torch.zeros_like(s))


def _face_series(x: torch.Tensor, axis: int, n_f: int, n_c: int) -> torch.Tensor:
    """Harmonic coarse faces of one axis: coarse face k combines fine faces
    2k and 2k+1 in series; the last takes the 1-2 faces the tail cell
    leaves over."""
    if n_c == n_f:
        return x
    main = _series(_strided(x, axis, 0, 2 * n_c, 2), _strided(x, axis, 1, 2 * n_c, 2))
    rest = x.narrow(axis, 2 * n_c, x.shape[axis] - 2 * n_c)
    last = rest.narrow(axis, 0, 1)
    if rest.shape[axis] > 1:
        last = _series(last, rest.narrow(axis, 1, 1))
    return torch.cat([main, last], dim=axis)


# -- per-sample hierarchy setup -----------------------------------------------


def struct_mg_dinvs(mg: StructCoefMG, dinv0_flat: torch.Tensor):
    """Per level, the per-axis face-grid conductances from the flat masked
    mass-diagonal inverse (batch..., n_u): level 0 is a reshape; each
    coarser level selects (or series-composes) the face planes and
    group-sums the transverse axes."""
    d = len(mg.levels[0].shape)
    batch = dinv0_flat.shape[:-1]
    shape0 = mg.levels[0].shape
    axes0 = []
    for a in range(d):
        fshape = list(shape0)
        fshape[a] += 1
        seg = dinv0_flat[..., mg.face_offsets[a]: mg.face_offsets[a + 1]]
        axes0.append(seg.reshape(batch + tuple(fshape[::-1])))
    out = [tuple(axes0)]
    coarsen_face = _face_series if mg.coarsen == "harmonic" else _plane_select
    for lvl in mg.levels[1:]:
        cur = []
        for a, x in enumerate(out[-1]):
            x = coarsen_face(x, _arr_ax(x, a), lvl.fine_shape[a], lvl.shape[a])
            for b in range(d):
                if b != a:
                    x = _group_sum(x, _arr_ax(x, b), lvl.fine_shape[b], lvl.shape[b])
            cur.append(x)
        out.append(tuple(cur))
    return out


def _jdiag_grid(dinv_axes) -> torch.Tensor:
    """Jacobi diagonal of S on the cell grid (1 where it is 0)."""
    diag = None
    for a, da in enumerate(dinv_axes):
        ax = _arr_ax(da, a)
        n = da.shape[ax] - 1
        c = da.narrow(ax, 0, n) + da.narrow(ax, 1, n)
        diag = c if diag is None else diag + c
    return torch.where(diag > 0, diag, torch.ones_like(diag))


def _line_tables(dinv_axes, a: int):
    """(dl, dd, du) of the line relaxation along mesh axis a, solved axis
    FIRST and contiguous: the full Jacobi diagonal, off-diagonals -dinv_a
    at the faces. Cell i couples to i-1 through face i and to i+1 through
    face i+1, so dl[0] and du[n-1] hold the boundary faces' values; the
    Thomas recurrence never reads them (T_a keeps the full diagonal, so it
    is SPD and the undamped line sweep is S-convergent)."""
    diag = _jdiag_grid(dinv_axes)
    da = dinv_axes[a]
    dm = da.movedim(_arr_ax(da, a), 0)  # (n_a + 1, ...)
    n = dm.shape[0] - 1
    dl = (-dm.narrow(0, 0, n)).contiguous()
    du = (-dm.narrow(0, 1, n)).contiguous()
    dd = diag.movedim(_arr_ax(diag, a), 0).contiguous()
    return dl, dd, du


def struct_mg_setup(mg: StructCoefMG, dinv0_flat: torch.Tensor):
    """Per-solve V-cycle state: per level (dinv_axes, idiag, line_tables),
    with the inverse Jacobi diagonal and (for mg.line_axes) the
    solved-axis-first line tables precomputed once per solve."""
    out = []
    for axes in struct_mg_dinvs(mg, dinv0_flat):
        lines = tuple(_line_tables(axes, a) for a in mg.line_axes)
        out.append((axes, 1.0 / _jdiag_grid(axes), lines))
    return out


def cast_state(state, dtype: torch.dtype):
    """The setup state with every tensor cast to `dtype` (the bfloat16
    preconditioner state of config.coefmg_prec_dtype)."""
    if isinstance(state, torch.Tensor):
        return state.to(dtype)
    return type(state)(cast_state(s, dtype) for s in state)


# -- device apply -------------------------------------------------------------


def _pad_axis(x: torch.Tensor, a: int) -> torch.Tensor:
    """Zero-pad mesh axis a (array dim ndim - 1 - a) by one on each side."""
    return F.pad(x, (0, 0) * a + (1, 1))


def _s_apply_grid(dinv_axes, x: torch.Tensor) -> torch.Tensor:
    """S x on the cell grid: per axis, flux t_k = d_k (x_{k-1} - x_k) with a
    zero-padded exterior, then (S x)_i += t_{i+1} - t_i."""
    y = None
    for a, da in enumerate(dinv_axes):
        ax = _arr_ax(x, a)
        n = x.shape[ax]
        xp = _pad_axis(x, a)
        t = da * (xp.narrow(ax, 0, n + 1) - xp.narrow(ax, 1, n + 1))
        contrib = t.narrow(ax, 1, n) - t.narrow(ax, 0, n)
        y = contrib if y is None else y + contrib
    return y


def _restrict_cells(x: torch.Tensor, lvl: StructMGLevel) -> torch.Tensor:
    for a in range(len(lvl.shape)):
        x = _group_sum(x, _arr_ax(x, a), lvl.fine_shape[a], lvl.shape[a])
    return x


def _prolong_cells(x: torch.Tensor, lvl: StructMGLevel) -> torch.Tensor:
    for a in range(len(lvl.shape)):
        x = _repeat_groups(x, _arr_ax(x, a), lvl.fine_shape[a], lvl.shape[a])
    return x


# -- the cycle's fused passes ---------------------------------------------------
# Each is one kernel of csrc/coefmg_stencil.cu for CUDA tensors
# (ops/coefmg_stencil.py, counted under kernel.coefmg_*) and its plain
# twin (`*_plain`, counted under coefmg.eager_passes), the same arithmetic
# in PyTorch ops, for CPU tensors.


def _cheb_first(dinv_axes, idiag, b, x, inv_theta: float):
    """A Chebyshev sweep's start: (r, dvec) with r = b - S x (b where x is
    None) and dvec = inv_theta idiag r."""
    if b.is_cuda:
        return coefmg_stencil.smooth(coefmg_stencil.FIRST, dinv_axes, idiag, b, x, w=inv_theta)
    return _cheb_first_plain(dinv_axes, idiag, b, x, inv_theta)


def _cheb_first_plain(dinv_axes, idiag, b, x, inv_theta: float):
    _COEFMG["eager_passes"] += 1
    r = b if x is None else b - _s_apply_grid(dinv_axes, x)
    return r, inv_theta * idiag * r


def _cheb_step(dinv_axes, idiag, x, r, dvec, a: float, c: float, last: bool):
    """One Chebyshev step: x + dvec (x None: 0), r - S dvec and
    a dvec + c idiag r' as (x, r, dvec); with `last`, that x plus that dvec
    alone (the sweep's result)."""
    if r.is_cuda:
        return coefmg_stencil.smooth(coefmg_stencil.STEP, dinv_axes, idiag, r, x, dvec, a=a,
                                     c=c, last=last)
    return _cheb_step_plain(dinv_axes, idiag, x, r, dvec, a, c, last)


def _cheb_step_plain(dinv_axes, idiag, x, r, dvec, a: float, c: float, last: bool):
    _COEFMG["eager_passes"] += 1
    x = (torch.zeros_like(dvec) if x is None else x) + dvec
    r = r - _s_apply_grid(dinv_axes, dvec)
    dvec = a * dvec + c * (idiag * r)
    return x + dvec if last else (x, r, dvec)


def _jacobi(dinv_axes, idiag, b, x, omega: float):
    """A damped Jacobi sweep x + omega idiag (b - S x); omega idiag b where
    x is None."""
    if b.is_cuda:
        return coefmg_stencil.smooth(coefmg_stencil.JACOBI, dinv_axes, idiag, b, x, w=omega)
    return _jacobi_plain(dinv_axes, idiag, b, x, omega)


def _jacobi_plain(dinv_axes, idiag, b, x, omega: float):
    _COEFMG["eager_passes"] += 1
    if x is None:
        return omega * idiag * b
    return x + omega * idiag * (b - _s_apply_grid(dinv_axes, x))


def _residual_restrict(dinv_axes, b, x, lvl: Optional[StructMGLevel] = None):
    """b - S x, group-summed onto the cells of the coarser level `lvl`
    (None: the residual itself)."""
    if b.is_cuda:
        fine = tuple(b.shape[b.dim() - len(dinv_axes):])[::-1]
        coarse = fine if lvl is None else lvl.shape
        return coefmg_stencil.residual_restrict(dinv_axes, b, x, fine, coarse)
    return _residual_restrict_plain(dinv_axes, b, x, lvl)


def _residual_restrict_plain(dinv_axes, b, x, lvl: Optional[StructMGLevel] = None):
    _COEFMG["eager_passes"] += 1
    r = b - _s_apply_grid(dinv_axes, x)
    return r if lvl is None else _restrict_cells(r, lvl)


def _prolong_add(x, xc, lvl: StructMGLevel):
    """x plus xc repeated over each coarse cell's group of `lvl`."""
    if x.is_cuda:
        return coefmg_stencil.prolong_add(x, xc, lvl.fine_shape, lvl.shape)
    return _prolong_add_plain(x, xc, lvl)


def _prolong_add_plain(x, xc, lvl: StructMGLevel):
    _COEFMG["eager_passes"] += 1
    return x + _prolong_cells(xc, lvl)


def _cheb_smooth_grid(mg: StructCoefMG, dinv_axes, idiag, b, x):
    """Order-k Chebyshev(Jacobi) sweep on [cheby_lo * 2, 2] of D^{-1} S."""
    lam_max = 2.0
    lam_min = mg.cheby_lo * lam_max
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta
    rho = 1.0 / sigma
    r, dvec = _cheb_first(dinv_axes, idiag, b, x, 1.0 / theta)
    steps = mg.cheby_order - 1
    if steps == 0:
        return (torch.zeros_like(b) if x is None else x) + dvec
    for k in range(steps):
        rho_new = 1.0 / (2.0 * sigma - rho)
        out = _cheb_step(dinv_axes, idiag, x, r, dvec, rho_new * rho, 2.0 * rho_new / delta,
                         last=k == steps - 1)
        rho = rho_new
        if k < steps - 1:
            x, r, dvec = out
    return out


def _line_solve(tables, r: torch.Tensor, a: int) -> torch.Tensor:
    """T_a^{-1} r on the cell grid through K1 (tables solved axis first).
    Where the state carries a singleton right-hand-side axis (the stacked
    solve: tables (n_a, batch..., 1, others...) against r with R vectors
    there), the R vectors go to K1 as right-hand sides of one table set."""
    dl, dd, du = tables
    ax = _arr_ax(r, a)
    rm = r.movedim(ax, 0)
    if rm.shape == dd.shape:
        return thomas(dl, dd, du, rm.contiguous()).movedim(0, ax)
    k = [i for i, (m, t) in enumerate(zip(rm.shape, dd.shape)) if m != t]
    if rm.dim() != dd.dim() or len(k) != 1 or dd.shape[k[0]] != 1:
        raise ValueError(f"line solve: residual {tuple(rm.shape)} against tables {tuple(dd.shape)}")
    k = k[0]
    x = thomas(*(t.squeeze(k) for t in tables), rm.movedim(k, 0).contiguous())  # (R, n_a, ...)
    return x.movedim(0, k).movedim(0, ax)


def _line_smooth_grid(mg: StructCoefMG, dinv_axes, lines, b, x, reverse: bool):
    """One line-relaxation pass, x += line_omega T_a^{-1} (b - S x) for each
    configured axis; the post-smoothing pass runs the axes reversed so the
    V-cycle stays self-adjoint."""
    order = list(range(len(mg.line_axes)))
    if reverse:
        order.reverse()
    for i in order:
        a = mg.line_axes[i]
        if x is None:
            x = mg.line_omega * _line_solve(lines[i], b, a)
        else:
            r = _residual_restrict(dinv_axes, b, x)
            x = x + mg.line_omega * _line_solve(lines[i], r, a)
    return x


def _v_cycle_grid(mg: StructCoefMG, state, b: torch.Tensor, sweeps: int, level: int):
    """The V-cycle from grid `level` down; each grid level is a
    `coefmg.level` span (attribute `grid`), nested by the recursion."""
    with trace.span("coefmg.level", grid=level):
        return _v_cycle_level(mg, state, b, sweeps, level)


def _v_cycle_level(mg: StructCoefMG, state, b: torch.Tensor, sweeps: int, level: int):
    dinv_axes, idiag, lines = state[level]
    cheby = mg.cheby_order > 0
    use_lines = bool(mg.line_axes) and len(lines) == len(mg.line_axes)
    if level == len(mg.levels) - 1:
        if use_lines:
            # (forward, reverse) line pass pairs at the coarsest level too.
            x = _line_smooth_grid(mg, dinv_axes, lines, b, None, False)
            x = _line_smooth_grid(mg, dinv_axes, lines, b, x, True)
            for _ in range(max(1, mg.coarse_sweeps // 2) - 1):
                x = _line_smooth_grid(mg, dinv_axes, lines, b, x, False)
                x = _line_smooth_grid(mg, dinv_axes, lines, b, x, True)
            return x
        x = _jacobi(dinv_axes, idiag, b, None, mg.omega)
        for _ in range(mg.coarse_sweeps - 1):
            x = _jacobi(dinv_axes, idiag, b, x, mg.omega)
        return x
    # Pre-smoothing: point/Chebyshev, then lines forward; post-smoothing the
    # mirror (lines reversed, then point/Chebyshev).
    if cheby:
        x = _cheb_smooth_grid(mg, dinv_axes, idiag, b, None)
    else:
        x = _jacobi(dinv_axes, idiag, b, None, mg.omega)
        for _ in range(sweeps - 1):
            x = _jacobi(dinv_axes, idiag, b, x, mg.omega)
    if use_lines:
        x = _line_smooth_grid(mg, dinv_axes, lines, b, x, reverse=False)
    nxt = mg.levels[level + 1]
    xc = _v_cycle_grid(mg, state, _residual_restrict(dinv_axes, b, x, nxt), sweeps, level + 1)
    x = _prolong_add(x, xc, nxt)
    if use_lines:
        x = _line_smooth_grid(mg, dinv_axes, lines, b, x, reverse=True)
    if cheby:
        return _cheb_smooth_grid(mg, dinv_axes, idiag, b, x)
    for _ in range(sweeps):
        x = _jacobi(dinv_axes, idiag, b, x, mg.omega)
    return x


# -- flat-vector API -----------------------------------------------------------


def struct_s_apply(mg: StructCoefMG, state, x_flat: torch.Tensor) -> torch.Tensor:
    """Fine-level S x for flat (batch..., n_s) vectors (struct_mg_setup state)."""
    batch = x_flat.shape[:-1]
    xg = x_flat.reshape(batch + tuple(mg.levels[0].shape[::-1]))
    return _s_apply_grid(state[0][0], xg).reshape(batch + (-1,))


def struct_v_cycle(mg: StructCoefMG, state, b_flat: torch.Tensor, sweeps: int = 2) -> torch.Tensor:
    """One V(sweeps, sweeps) cycle (Chebyshev when cheby_order > 0) for flat
    (batch..., n_s) residuals, with struct_mg_setup state."""
    batch = b_flat.shape[:-1]
    bg = b_flat.reshape(batch + tuple(mg.levels[0].shape[::-1]))
    return _v_cycle_grid(mg, state, bg, sweeps, 0).reshape(batch + (-1,))


def struct_cycle(mg: StructCoefMG, state, r: torch.Tensor, sweeps: int,
                 pdt: Optional[torch.dtype]) -> torch.Tensor:
    """The Darcy preconditioner's cycle: struct_v_cycle in the state's
    dtype `pdt` (None: r's own), the result in r's dtype."""
    return in_precision(lambda x: struct_v_cycle(mg, state, x, sweeps=sweeps), r, pdt)


# -- the cycle as a CUDA graph -------------------------------------------------


def _graphable(r: torch.Tensor) -> bool:
    """May a cycle on r run as a graph: r on a card, and no capture under
    way on its stream (a cycle inside someone else's capture is captured
    there, eagerly)."""
    return r.is_cuda and not torch.cuda.is_current_stream_capturing()


def _warm_up(fn: Callable[[], torch.Tensor], device: torch.device) -> None:
    """One eager run of fn on a side stream of `device` before its
    capture, as torch.cuda.graphs asks: lazy set-up happens outside the
    capture."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)


def _capture_graph(fn: Callable[[], torch.Tensor], device: torch.device):
    """fn() captured into a new CUDA graph on `device`: (the graph, fn's
    output, which every replay rewrites). The capture runs no kernel."""
    with torch.cuda.device(device):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
    return graph, out


def _state_tensors(state):
    if isinstance(state, torch.Tensor):
        yield state
    else:
        for s in state:
            yield from _state_tensors(s)


def _empty_like_state(state):
    if isinstance(state, torch.Tensor):
        return torch.empty_like(state)
    return type(state)(_empty_like_state(s) for s in state)


class GraphedVCycle:
    """struct_cycle(mg, state, r, sweeps, pdt) as one CUDA graph, for one
    shape and dtype of r and one of the state: static copies of the state
    (`load` puts a solve's in them) and of r, and the graph with its
    output. A call copies r in, replays and returns a clone of the output
    (the caller may keep it across the next call: pcg's first p is its z).
    Kernel launches that the capture recorded (the fused passes, K1) are
    added to the `kernel` counters at each replay, not at the capture,
    which launched nothing."""

    def __init__(self, mg: StructCoefMG, state, r: torch.Tensor, sweeps: int,
                 pdt: Optional[torch.dtype]):
        self.state = _empty_like_state(state)
        self.load(state)
        self.r = torch.empty_like(r)
        self.r.copy_(r)
        fn = lambda: struct_cycle(mg, self.state, self.r, sweeps, pdt)
        _warm_up(fn, r.device)
        before = dict(_KERNEL)
        self.graph, self.out = _capture_graph(fn, r.device)
        self.launches = {k: v - before.get(k, 0) for k, v in _KERNEL.items()
                         if v != before.get(k, 0)}
        for k, n in self.launches.items():
            _KERNEL[k] -= n
        self.loaded_by = None  # the token of the solve whose state is loaded
        _COEFMG["graph_captures"] += 1

    def load(self, state) -> None:
        """Copy a solve's state (struct_mg_setup's, cast) into the static one."""
        for dst, src in zip(_state_tensors(self.state), _state_tensors(state)):
            dst.copy_(src)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        with trace.span("coefmg.replay"):
            self.r.copy_(r)
            self.graph.replay()
            for k, n in self.launches.items():
                _KERNEL[k] += n
            _COEFMG["graph_replays"] += 1
            return self.out.clone()


def cycle_key(mg: StructCoefMG, state, r: torch.Tensor, sweeps: int,
              pdt: Optional[torch.dtype]) -> tuple:
    """What a graphed cycle is captured for: the MG ladder and its settings,
    the sweeps and state dtype, r's shape, dtype and device, and every
    state tensor's shape and dtype (the stacked solve's state carries a
    singleton right-hand-side axis that r fills with 2)."""
    return (mg, int(sweeps), pdt, tuple(r.shape), r.dtype, r.device,
            tuple((tuple(t.shape), t.dtype) for t in _state_tensors(state)))


class VCycleGraphs:
    """A solver's graphed cycles by `cycle_key`, least recently used
    first (at most MAX_GRAPHS), and how many solves each key has seen.
    Kept by the solver, so graphs outlive the managers."""

    def __init__(self):
        self.graphs: Dict[tuple, GraphedVCycle] = collections.OrderedDict()
        self.solves: Dict[tuple, int] = {}
        self._tokens = itertools.count()

    def cycle(self, mg: StructCoefMG, state, sweeps: int,
              pdt: Optional[torch.dtype]) -> Callable[[torch.Tensor], torch.Tensor]:
        """The cycle r -> struct_cycle(mg, state, r, sweeps, pdt) of one
        solve: eager where `_graphable` says no and on a key's first solve;
        the key's graph is captured on the first call of its second solve
        and replayed after that, with this solve's state loaded once."""
        token = next(self._tokens)
        keys: Dict[tuple, tuple] = {}  # this solve's keys by r's shape, dtype, device

        def run(r: torch.Tensor) -> torch.Tensor:
            if not _graphable(r):
                _COEFMG["eager_cycles"] += 1
                return struct_cycle(mg, state, r, sweeps, pdt)
            rk = (r.shape, r.dtype, r.device)
            key = keys.get(rk)
            if key is None:
                key = keys[rk] = cycle_key(mg, state, r, sweeps, pdt)
                self.solves[key] = self.solves.get(key, 0) + 1
            graph = self.graphs.get(key)
            if graph is None:
                if self.solves[key] < CAPTURE_AT_SOLVE:
                    _COEFMG["eager_cycles"] += 1
                    return struct_cycle(mg, state, r, sweeps, pdt)
                if len(self.graphs) >= MAX_GRAPHS:
                    self.graphs.popitem(last=False)
                graph = self.graphs[key] = GraphedVCycle(mg, state, r, sweeps, pdt)
                graph.loaded_by = token
            else:
                self.graphs.move_to_end(key)
                if graph.loaded_by != token:
                    graph.load(state)
                    graph.loaded_by = token
            return graph(r)

        return run
