"""Spatially sharded Darcy Schur solves: one realization split into y-slabs.

Port of parelagmc_tpu/parallel/spatial_darcy.py (see its docstring for the
design). The domain is cut into equal slabs along the mesh y axis (under
axis_order="auto", build_problem relabels the grid first); cell fields and
the x, z and slab-owned y face grids live slab-local, and every operator is
grid arithmetic on the slab plus a one-plane halo:

* M(w)^{-1} stays exact: the x and z lines are slab-local Thomas solves;
  the y lines, which cross the cuts, are solved by a SPIKE reduction -
  factored once per Krylov solve (the decoupled chunk, two spike solves, a
  gather of four tip values per line and the LU of the 2 n_sp interface
  system), then applied per iteration with one Thomas solve, a gather of
  two values per line and an LU back-substitution;
* the pressure Schur CG sums its dots over the slabs and leaves its loop
  on a flag reduced over every slab and sample row;
* under cg-schur-coefmg the preconditioner is the two-level Schwarz
  per-sample Galerkin MG: slab-local V-cycles whose cut faces keep their
  halo-coupled diagonal, plus a global coarse V-cycle grafted at the
  deepest pair-aligned slab level; else diag(S_bar) Jacobi scaled by
  sqrt(w).

The slab arithmetic is written once against a communicator
(parallel/slabs.py): in one process with the slabs on a leading axis
(`StackedSlabs`, the default: one K1 launch serves every slab, and all
slabs live on one device, so the memory of the device is NOT lowered), or
one slab per torch.distributed rank (`DistributedSlabs`, which lowers a
device's share of the solve state to about 1/n_sp; the inputs and outputs
stay whole on every rank). Every line solve runs on K1 in place
(ops/tridiag_pallas.thomas_grid: the x lines along the last dim, the z
lines with row stride m nx, the y lines with row stride nx, the spike
solves with two right-hand sides per table set); on CPU tensors it runs
thomas_plain. The reference's line solves here are a lax.scan
(ops/mass_solve._thomas_solve), not its Pallas kernel.

DarcySolver routes its finest level here when
config.darcy_solver.spatial_shards > 1 (physics/darcy.py). CPU tests:
tests/test_torch_spatial_darcy.py; on the card: chip_smoke.py phase 21.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from parelagmc_tpu_torch.device import resolve_device
from parelagmc_tpu_torch.fem.assembly import build_mixed_level
from parelagmc_tpu_torch.mesh.factories import make_box_mesh
from parelagmc_tpu_torch.mesh.structured import _mfem_bdr_attr
from parelagmc_tpu_torch.ops.coef_multigrid_structured import (
    _prolong_cells,
    _restrict_cells,
    _v_cycle_grid,
    build_struct_coef_mg,
    cast_state,
    parse_line_axes,
    struct_mg_setup,
    struct_s_apply,
    struct_v_cycle,
)
from parelagmc_tpu_torch.ops.mass_solve import build_line_tables
from parelagmc_tpu_torch.ops.tridiag_pallas import thomas_grid
from parelagmc_tpu_torch.parallel.slabs import slab_comm

Y = -2  # the cut axis: array dim of mesh axis y in (..., z, y, x) grids


class SpikeFactors(NamedTuple):
    """spike_tridiag_factor's tables for spike_tridiag_apply."""

    dl_in: torch.Tensor  # decoupled chunk (first dl and last du of each slab 0)
    d: torch.Tensor
    du_in: torch.Tensor
    v: torch.Tensor  # spike of the coupling to the slab below
    w: torch.Tensor  # spike of the coupling to the slab above
    lu: torch.Tensor  # LU of the (..., 2 n_sp, 2 n_sp) interface systems
    piv: torch.Tensor
    prev_idx: torch.Tensor  # (n_local,) interface index of z_{s-1} per local slab
    prev_on: torch.Tensor  # (n_local,) whether there is a slab below
    next_idx: torch.Tensor  # interface index of a_{s+1}
    next_on: torch.Tensor


def spike_tridiag_factor(dl, d, du, comm, dim: int = Y) -> SpikeFactors:
    """Matrix-dependent half of the slab-distributed SPIKE tridiagonal
    solve along array dim `dim` of (n_local, ...) slab tensors: the
    decoupled local tables, the two boundary spikes (one K1 launch with two
    right-hand sides per table set) and the LU-factored 2 n_sp interface
    system, factored once per Krylov solve. dl's first row holds the
    coupling to the slab below (0 on slab 0), du's last row the coupling to
    the slab above (0 on the last slab): the global line coefficients cut
    per slab. In the stacked form the interface systems are factored once;
    in the distributed form every rank factors the same ones."""
    n_sp = comm.n_sp
    dim = dim % d.dim()
    m = d.shape[dim]
    dl_in, du_in = dl.clone(), du.clone()
    dl_in.select(dim, 0).zero_()
    du_in.select(dim, m - 1).zero_()
    e = torch.zeros((2,) + tuple(d.shape), dtype=d.dtype, device=d.device)
    e[0].select(dim, 0).copy_(dl.select(dim, 0))
    e[1].select(dim, m - 1).copy_(du.select(dim, m - 1))
    lead = d.shape[:1]
    flat = lambda t: t.reshape((-1,) + tuple(t.shape[2:]))
    # (n_local * rows, 2, *grid): the two spikes ride K1's right-hand-side axis.
    rhs = e.movedim(0, 2).reshape((-1, 2) + tuple(d.shape[2:]))
    sol = thomas_grid(flat(dl_in), flat(d), flat(du_in), rhs, dim - 1)
    sol = sol.reshape(lead + d.shape[1:2] + (2,) + tuple(d.shape[2:])).movedim(2, 0)
    v, w = sol[0], sol[1]
    # Interface unknowns u = [a_0, z_0, a_1, z_1, ...] (a_s / z_s the first /
    # last entry of slab s's solution):
    #   a_s + v_s[0]  z_{s-1} + w_s[0]  a_{s+1} = xd_s[0]
    #   z_s + v_s[-1] z_{s-1} + w_s[-1] a_{s+1} = xd_s[-1]
    tips = torch.stack([v.select(dim, 0), v.select(dim, m - 1), w.select(dim, 0),
                        w.select(dim, m - 1)], dim=-1)
    allt = comm.all_gather(tips)  # (n_sp, ..., 4)
    ns2 = 2 * n_sp
    A = torch.eye(ns2, dtype=d.dtype, device=d.device).expand(
        tuple(allt.shape[1:-1]) + (ns2, ns2)).clone()
    for s in range(n_sp):
        t = allt[s]
        if s > 0:
            A[..., 2 * s, 2 * s - 1] = t[..., 0]
            A[..., 2 * s + 1, 2 * s - 1] = t[..., 1]
        if s + 1 < n_sp:
            A[..., 2 * s, 2 * (s + 1)] = t[..., 2]
            A[..., 2 * s + 1, 2 * (s + 1)] = t[..., 3]
    lu, piv = torch.linalg.lu_factor(A)
    slabs = torch.tensor(comm.slabs, device=d.device)
    return SpikeFactors(dl_in, d, du_in, v, w, lu, piv,
                        prev_idx=(2 * slabs - 1).clamp(min=0), prev_on=slabs > 0,
                        next_idx=(2 * (slabs + 1)).clamp(max=ns2 - 1), next_on=slabs + 1 < n_sp)


def spike_tridiag_apply(f: SpikeFactors, b, comm, dim: int = Y) -> torch.Tensor:
    """rhs-dependent half: one K1 solve on the decoupled chunk, a gather of
    two values per line, the LU back-substitution of the interface system,
    and the spike combination x = xd - v z_{s-1} - w a_{s+1}."""
    dim = dim % f.d.dim()
    m = f.d.shape[dim]
    flat = lambda t: t.reshape((-1,) + tuple(t.shape[2:]))
    xd = thomas_grid(flat(f.dl_in), flat(f.d), flat(f.du_in), flat(b), dim - 1).reshape(b.shape)
    tips = torch.stack([xd.select(dim, 0), xd.select(dim, m - 1)], dim=-1)  # (n_local, ..., 2)
    allt = comm.all_gather(tips)  # (n_sp, ..., 2)
    rhs = allt.movedim(0, -2).reshape(tuple(allt.shape[1:-1]) + (2 * comm.n_sp,))
    u = torch.linalg.lu_solve(f.lu, f.piv, rhs.unsqueeze(-1)).squeeze(-1)  # (..., 2 n_sp)
    take = lambda idx, on: (torch.index_select(u, -1, idx).movedim(-1, 0)
                            * on.view((-1,) + (1,) * (u.dim() - 1)).to(u.dtype))
    z_prev = take(f.prev_idx, f.prev_on).unsqueeze(dim)
    a_next = take(f.next_idx, f.next_on).unsqueeze(dim)
    return xd - f.v * z_prev - f.w * a_next


def spike_tridiag_solve(dl, d, du, b, comm, dim: int = Y) -> torch.Tensor:
    """Exact solve of slab-distributed tridiagonal systems along `dim`:
    factor and apply in one (Krylov callers keep the factors)."""
    return spike_tridiag_apply(spike_tridiag_factor(dl, d, du, comm, dim), b, comm, dim)


def _parse_line_axes_compat(scfg, mesh) -> tuple:
    """config.coefmg_line_axes on the spatial path: explicit letters only
    ("auto" needs the reference coefficient, not at hand here: it warns and
    runs without line relaxation)."""
    spec = (getattr(scfg, "coefmg_line_axes", "") or "").strip().lower()
    if spec == "auto":
        warnings.warn(
            "coefmg_line_axes='auto' is unavailable on the spatially-sharded path (auto "
            "selection needs the reference coefficient); running WITHOUT line relaxation. "
            "Pass explicit letters (e.g. 'xz') to keep line smoothing under spatial_shards.",
            stacklevel=2)
        return ()
    if not spec:
        return ()
    return parse_line_axes(spec, mesh, None)


class _Grids(NamedTuple):
    """Static slab grids, each (n_local, 1, ...) with the cut axis at -2:
    cells (nz, m, nx), x faces (nz, m, nx+1), slab-owned y faces (nz, m, nx:
    planes 0..m-1; the closing global plane is essential), z faces
    (nz+1, m, nx); and the static one-plane halos of the y tables and masks,
    taken on the host from the whole grid."""

    bll: Tuple[torch.Tensor, ...]  # per mesh axis (x, y, z), on the cell grid
    blr: Tuple[torch.Tensor, ...]
    brr: Tuple[torch.Tensor, ...]
    ess: Tuple[torch.Tensor, ...]  # per-axis face-grid essential masks (bool)
    rhs_u: Tuple[torch.Tensor, ...]
    obs_u: Tuple[torch.Tensor, ...]
    rhs_p: torch.Tensor
    obs_p: torch.Tensor
    pad_cell: torch.Tensor  # bool: padded (non-physical) cells
    sdiag: torch.Tensor  # diag of S_bar (Jacobi; ones when not given)
    brr_dn: torch.Tensor  # brr_y of the slab below's last cell plane (0 on slab 0)
    blr_dn: torch.Tensor  # blr_y of it
    bll_up: torch.Tensor  # bll_y of the slab above's first cell plane (0 on the last)
    ess_prev0: torch.Tensor  # ess of the y face below row 0 (True on slab 0)
    ess_next_top: torch.Tensor  # ess of the y face above the last row (True on the last slab)


class SpatialDarcy:
    """One Darcy level's pressure Schur-complement CG, sharded into n_sp
    y-slabs (and, with n_dp > 1, sample rows): the port of the reference's
    SpatialDarcy.

    Built from the same per-(cell, axis) mass blocks as the unsharded
    DarcySolver level (from_darcy), so it solves the identical discrete
    problem. Restrictions: both y boundaries essential (ValueError), and ny
    padded up to a multiple of n_sp with decoupled identity cells. It runs
    distributed (parallel/slabs.py) when a process group is up whose world
    size is n_sp * n_dp, else stacked. `device` None means cuda:0.
    """

    def __init__(self, mesh, blocks, ess_attr: np.ndarray, rhs: np.ndarray, obs: np.ndarray,
                 sbar_diag: np.ndarray, n_sp: int = 8, dtype: torch.dtype = torch.float32,
                 max_iters: int = 300, rtol: float = 1e-6, ess: Optional[np.ndarray] = None,
                 n_dp: int = 1, precond: str = "jacobi", mg_opts: Optional[dict] = None,
                 restart_every: int = 50, device=None):
        self.device = resolve_device(device)
        self.comm = slab_comm(n_sp, n_dp)
        self.n_sp, self.n_dp = int(n_sp), int(n_dp)
        self.restart_every = int(restart_every)
        self.dtype = dtype
        self.max_iters = int(max_iters)
        self.rtol = float(rtol)
        if mesh.dim != 3:
            raise ValueError("SpatialDarcy implements the 3D grid layout")
        nx, ny, nz = mesh.shape
        self.shape = (nx, ny, nz)
        ess_attr = np.asarray(ess_attr, dtype=np.int64)
        for side in (0, 1):
            if ess_attr[_mfem_bdr_attr(3, 1, side) - 1] != 1:
                raise ValueError(
                    "spatial sharding cuts the y axis: both y boundaries must be essential "
                    "(u.n = 0) so no shard needs the closing face plane")
        self.pad = (-ny) % self.n_sp
        self.ny_pad = ny + self.pad
        self.m = self.ny_pad // self.n_sp
        self.precond = precond
        self.global_mg = None
        if precond == "coefmg":
            o = dict(mg_opts or {})
            self.mg_cycles = max(1, int(o.pop("cycles", 1)))
            self.mg_sweeps = max(1, int(o.pop("sweeps", 2)))
            self.mg_prec_dtype = o.pop("prec_dtype", "") or None
            two_level = bool(o.pop("two_level", True))
            # The slab ladder's cutoff scales with 1/n_sp, so the slabs'
            # coarsest levels add up to the replicated ladder's.
            o_slab = dict(o)
            o_slab["cutoff"] = max(256, int(o.get("cutoff", 5000)) // self.n_sp)
            self.slab_mg = build_struct_coef_mg(make_box_mesh((nx, self.m, nz)), **o_slab)
            # Two-level Schwarz: hand off at the deepest slab level whose y
            # coarsening stays pair-aligned in every slab; there the slabs'
            # coarse grids tile the whole grid's, which a global ladder takes on.
            self.k_handoff = 0
            lv = self.slab_mg.levels
            for k in range(1, len(lv)):
                if lv[k - 1].shape[1] % 2 or lv[k].shape[1] * 2 != lv[k - 1].shape[1]:
                    break
                self.k_handoff = k
            if two_level and self.k_handoff > 0:
                gx, gy, gz = lv[self.k_handoff].shape
                self.global_mg = build_struct_coef_mg(make_box_mesh((gx, self.n_sp * gy, gz)),
                                                      **o)
        elif precond != "jacobi":
            raise ValueError(f"unknown precond {precond!r}")
        self.n_u = mesh.num_faces
        self.n_s = mesh.num_cells
        fo = tuple(int(x) for x in mesh.face_offsets)

        bll, blr, brr = (np.asarray(b, dtype=np.float64) for b in blocks)
        pad_y = lambda g, value=0.0: np.pad(g, ((0, 0), (0, self.pad), (0, 0)),
                                             constant_values=value)
        cell_grid = lambda v: pad_y(np.asarray(v, dtype=np.float64).reshape(nz, ny, nx))
        # Padded cells: identity x/z rows (bll = brr = 1/2 with w = 1), fully
        # decoupled along y (tables 0 there; the padded y faces are essential).
        pad_cell = np.zeros((nz, self.ny_pad, nx), dtype=bool)
        pad_cell[:, ny:, :] = True
        g_bll, g_blr, g_brr = [], [], []
        for a in range(3):
            lo, mid, hi = cell_grid(bll[:, a]), cell_grid(blr[:, a]), cell_grid(brr[:, a])
            if a != 1:
                lo[pad_cell] = 0.5
                hi[pad_cell] = 0.5
            g_bll.append(lo)
            g_blr.append(mid)
            g_brr.append(hi)
        ess_x, ess_y, ess_z = (pad_y(np.asarray(e), True)
                               for e in self._ess_face_grids(mesh, ess_attr, ess))

        def split_rhs(v):
            v = np.asarray(v, dtype=np.float64)
            vx = v[fo[0]: fo[1]].reshape(nz, ny, nx + 1)
            vy = v[fo[1]: fo[2]].reshape(nz, ny + 1, nx)[:, :ny, :]  # closing plane dropped
            vz = v[fo[2]: fo[3]].reshape(nz + 1, ny, nx)
            return tuple(pad_y(x) for x in (vx, vy, vz)), pad_y(v[self.n_u:].reshape(nz, ny, nx))

        (rux, ruy, ruz), rp = split_rhs(rhs)
        (oux, ouy, ouz), op_ = split_rhs(obs)
        # Essential-face rhs entries must be zero (DarcySolver zeroes them at
        # setup; a raw assembled rhs would leak boundary values through the
        # identity rows of the line solves).
        rux[ess_x] = 0.0
        ruy[ess_y] = 0.0
        ruz[ess_z] = 0.0
        sd = cell_grid(np.ones(self.n_s) if sbar_diag is None else sbar_diag)
        sd[pad_cell] = 1.0

        # Static one-plane halos of the y tables and masks, per slab.
        m, n = self.m, self.n_sp
        below = lambda g, fill: np.stack(
            [g[:, s * m - 1, :] if s > 0 else np.full_like(g[:, 0, :], fill) for s in range(n)])
        above = lambda g, fill: np.stack(
            [g[:, (s + 1) * m, :] if s + 1 < n else np.full_like(g[:, 0, :], fill)
             for s in range(n)])
        halos = dict(brr_dn=below(g_brr[1], 0.0), blr_dn=below(g_blr[1], 0.0),
                     bll_up=above(g_bll[1], 0.0), ess_prev0=below(ess_y, True),
                     ess_next_top=above(ess_y, True))

        local = self.comm.slabs

        def slab(g, dt=dtype):
            """(nz', ny_pad, nx') -> (n_local, 1, nz', m, nx') of the local slabs."""
            s = np.stack([g[:, k * m:(k + 1) * m, :] for k in local])
            return torch.as_tensor(np.ascontiguousarray(s[:, None]), dtype=dt, device=self.device)

        def halo(h, dt=dtype):
            """(n_sp, nz', nx') -> (n_local, 1, nz', 1, nx')."""
            s = np.stack([h[k] for k in local])[:, None, :, None, :]
            return torch.as_tensor(np.ascontiguousarray(s), dtype=dt, device=self.device)

        b_ = torch.bool
        self.grids = _Grids(
            bll=tuple(slab(g) for g in g_bll), blr=tuple(slab(g) for g in g_blr),
            brr=tuple(slab(g) for g in g_brr), ess=(slab(ess_x, b_), slab(ess_y, b_),
                                                    slab(ess_z, b_)),
            rhs_u=(slab(rux), slab(ruy), slab(ruz)), obs_u=(slab(oux), slab(ouy), slab(ouz)),
            rhs_p=slab(rp), obs_p=slab(op_), pad_cell=slab(pad_cell, b_), sdiag=slab(sd),
            brr_dn=halo(halos["brr_dn"]), blr_dn=halo(halos["blr_dn"]),
            bll_up=halo(halos["bll_up"]), ess_prev0=halo(halos["ess_prev0"], b_),
            ess_next_top=halo(halos["ess_next_top"], b_))

    @property
    def execution(self) -> str:
        return "distributed" if self.comm.distributed else "stacked"

    @staticmethod
    def _ess_face_grids(mesh, ess_attr, ess=None):
        """Essential-face masks as per-axis face grids (the y grid without
        its closing plane). Pass the flat `ess` when at hand (from_darcy
        does): rebuilding the mixed level costs seconds at SPE10 scale."""
        nx, ny, nz = mesh.shape
        if ess is None:
            ess = build_mixed_level(mesh).ess_faces(ess_attr)
        ess = np.asarray(ess)
        fo = mesh.face_offsets
        return (ess[fo[0]: fo[1]].reshape(nz, ny, nx + 1),
                ess[fo[1]: fo[2]].reshape(nz, ny + 1, nx)[:, :ny, :],
                ess[fo[2]: fo[3]].reshape(nz + 1, ny, nx))

    @classmethod
    def from_darcy(cls, solver, level: int, **kw):
        """Build from a DarcySolver level: the same blocks, BCs, rhs, QoI
        functional and Krylov settings, on the solver's device and in its
        dtype unless `device` / `dtype` say otherwise."""
        mesh = solver.hierarchy.levels[level].mesh
        L = solver.levels[level]
        scfg = solver.solver_cfg
        host = lambda t: t.detach().cpu().numpy()
        kw.setdefault("precond", "coefmg" if scfg.name == "cg-schur-coefmg" else "jacobi")
        kw.setdefault("mg_opts", {
            "cutoff": scfg.coarse_dense_cutoff,
            "coarse_sweeps": max(1, scfg.mg_coarse_sweeps),
            "omega": getattr(scfg, "coefmg_omega", 0.8),
            "cheby_order": getattr(scfg, "coefmg_cheby_order", 0),
            "cheby_lo": getattr(scfg, "coefmg_cheby_lo", 0.25),
            "cycles": max(1, getattr(scfg, "coefmg_cycles", 1)),
            "sweeps": max(1, getattr(scfg, "coefmg_sweeps", 2)),
            "prec_dtype": getattr(scfg, "coefmg_prec_dtype", ""),
            # Line relaxation along y becomes slab-local lines (a Schwarz
            # block smoother); "auto" resolves to () here.
            "line_axes": _parse_line_axes_compat(scfg, mesh),
            "line_omega": getattr(scfg, "coefmg_line_omega", 1.0),
            "coarsen": getattr(scfg, "coefmg_coarsen", "galerkin"),
        })
        kw.setdefault("device", solver.device)
        kw.setdefault("dtype", solver.dtype)
        # diag(S_bar) feeds the Jacobi preconditioner alone: its assembly
        # (seconds of host work at SPE10 scale) is skipped under coefMG.
        sdiag = solver.sbar_diag_np(level) if kw["precond"] == "jacobi" else None
        return cls(mesh, solver.level_blocks(level), np.asarray(solver.config.ess_attr[:6]),
                   host(L.rhs).astype(np.float64), host(L.obs_func).astype(np.float64),
                   sdiag, max_iters=scfg.max_iterations,
                   rtol=scfg.relative_tolerance, ess=host(L.ess),
                   restart_every=int(getattr(scfg, "restart_every", 50) or 0), **kw)

    # -- slab operators ---------------------------------------------------------
    def _minv_factor(self, g: _Grids, w, w_dn):
        """Line tables and SPIKE factors of M(w)^{-1}, once per solve. w_dn:
        the last cell plane of w of the slab below (halo)."""
        fx = build_line_tables(g.bll[0], g.blr[0], g.brr[0], g.ess[0], w, dim=-1)
        fz = build_line_tables(g.bll[2], g.blr[2], g.brr[2], g.ess[2], w, dim=-3)
        # y lines: row j couples the cell below (the halo for j = 0) and cell j.
        lower = lambda h, t: torch.cat([h, t.narrow(Y, 0, self.m - 1)], dim=Y)
        w_lo = lower(w_dn, w)
        diag = w_lo * lower(g.brr_dn, g.brr[1]) + w * g.bll[1]
        dl = w_lo * lower(g.blr_dn, g.blr[1])
        du = w * g.blr[1]
        essy = g.ess[1]
        # Couplings into essential neighbours are zeroed, across the cuts
        # too: below row 0 lies the last y face of the slab below (a missing,
        # essential plane on slab 0); above the last row the first of the
        # slab above (the essential closing plane on the last slab).
        ess_prev = torch.cat([g.ess_prev0, essy.narrow(Y, 0, self.m - 1)], dim=Y)
        ess_next = torch.cat([essy.narrow(Y, 1, self.m - 1), g.ess_next_top], dim=Y)
        diag = diag.masked_fill(essy, 1.0)
        dl = dl.masked_fill(essy | ess_prev, 0.0)
        du = du.masked_fill(essy | ess_next, 0.0)
        return fx, spike_tridiag_factor(dl, diag, du, self.comm, Y), fz

    def _minv_apply(self, factors, r):
        """Exact M(w)^{-1} on the face-grid triple r = (rx, ry, rz)."""
        fx, fy, fz = factors
        rx, ry, rz = r
        flat = lambda t: t.reshape((-1,) + tuple(t.shape[2:]))
        zx = thomas_grid(*(flat(t) for t in (*fx, rx)), -1).reshape(rx.shape)
        zz = thomas_grid(*(flat(t) for t in (*fz, rz)), 1).reshape(rz.shape)
        return zx, spike_tridiag_apply(fy, ry, self.comm, Y), zz

    def _slab_mg_state(self, g: _Grids, w, w_dn):
        """Per-solve state of the slab coefMG: the slab's inverse masked mass
        diagonals, the cut faces with their halo-coupled diagonal, through
        struct_mg_setup; and with two levels the global coarse state from
        the handoff level's gathered diagonals."""

        def dinv(ess, diag):
            pos = diag > 0
            return torch.where(ess | ~pos, torch.zeros_like(diag),
                               1.0 / torch.where(pos, diag, torch.ones_like(diag)))

        def line(bll, brr, ess, dim):
            c_lo, c_hi = w * bll, w * brr
            zl = torch.zeros_like(c_lo.narrow(dim, 0, 1))
            return dinv(ess, torch.cat([c_lo, zl], dim=dim) + torch.cat([zl, c_hi], dim=dim))

        dx = line(g.bll[0], g.brr[0], g.ess[0], -1)
        dz = line(g.bll[2], g.brr[2], g.ess[2], -3)
        # y faces: m + 1 planes; plane 0 couples the halo cell below, plane m
        # the first cell of the slab above (the closing plane on the last slab).
        m = self.m
        w_lo = torch.cat([w_dn, w.narrow(Y, 0, m - 1)], dim=Y)
        brr_lo = torch.cat([g.brr_dn, g.brr[1].narrow(Y, 0, m - 1)], dim=Y)
        diag_low = w_lo * brr_lo + w * g.bll[1]
        w_up = self.comm.halo_dn(w.narrow(Y, 0, 1))
        diag_top = w.narrow(Y, m - 1, 1) * g.brr[1].narrow(Y, m - 1, 1) + w_up * g.bll_up
        dy = dinv(torch.cat([g.ess[1], g.ess_next_top], dim=Y),
                  torch.cat([diag_low, diag_top], dim=Y))
        lead = w.shape[:2]
        flat = torch.cat([t.reshape(lead + (-1,)) for t in (dx, dy, dz)], dim=-1)
        pdt = getattr(torch, self.mg_prec_dtype) if self.mg_prec_dtype else None
        cast = (lambda st: st) if pdt is None else (lambda st: cast_state(st, pdt))
        state = cast(struct_mg_setup(self.slab_mg, flat))
        if self.global_mg is None:
            return state, None
        # The slabs' handoff-level grids tile the global one (pair-aligned
        # y); the duplicated cut planes hold the same value on both sides,
        # so the y faces drop each slab's top plane except the last one's.
        gdx, gdy, gdz = (self.comm.all_gather(t) for t in state[self.k_handoff][0])
        join = lambda t: t.movedim(0, -3).flatten(-3, -2)  # (n_sp, B, z, y, x) -> (B, z, n_sp y, x)
        gy = torch.cat([join(gdy.narrow(Y, 0, gdy.shape[Y] - 1)),
                        gdy[-1].narrow(Y, gdy.shape[Y] - 1, 1)], dim=Y)
        batch = gdx.shape[1:2]
        gflat = torch.cat([t.reshape(batch + (-1,)) for t in (join(gdx), gy, join(gdz))], dim=-1)
        return state, cast(struct_mg_setup(self.global_mg, gflat))

    def _slab_mg_apply(self, states, r):
        """Additive two-level Schwarz on the slab residual r: slab-local
        V-cycle(s) plus the global coarse V-cycle at the handoff level,
        restricted and prolonged through the slab ladder's own transfers."""
        state, gstate = states
        rdt = r.dtype
        if self.mg_prec_dtype is not None:
            r = r.to(getattr(torch, self.mg_prec_dtype))
        lead = r.shape[:2]
        rf = r.reshape(lead + (-1,))
        cycle = lambda b: struct_v_cycle(self.slab_mg, state, b, sweeps=self.mg_sweeps)
        z = cycle(rf)
        for _ in range(self.mg_cycles - 1):
            z = z + cycle(rf - struct_s_apply(self.slab_mg, state, z))
        z = z.reshape(r.shape)
        if gstate is None:
            return z.to(rdt)
        rc = r
        for lvl in range(1, self.k_handoff + 1):
            rc = _restrict_cells(rc, self.slab_mg.levels[lvl])
        ag = self.comm.all_gather(rc)  # (n_sp, B, z, m_k, x)
        m_k = ag.shape[Y]
        zg = _v_cycle_grid(self.global_mg, gstate, ag.movedim(0, -3).flatten(-3, -2),
                           self.mg_sweeps, 0)
        zc = zg.unflatten(-2, (self.n_sp, m_k)).movedim(-3, 0)[self.comm.slabs[0]:][
            : self.comm.n_local]
        for lvl in range(self.k_handoff, 0, -1):
            zc = _prolong_cells(zc, self.slab_mg.levels[lvl])
        return (z + zc).to(rdt)

    def _apply_b(self, g: _Grids, u):
        """B u on the cells: signed face differences, with the first y plane
        of the slab above (halo)."""
        ux, uy, uz = u
        uy_hi = torch.cat([uy.narrow(Y, 1, self.m - 1), self.comm.halo_dn(uy.narrow(Y, 0, 1))],
                          dim=Y)
        out = (ux[..., 1:] - ux[..., :-1] + uy_hi - uy
               + uz[..., 1:, :, :] - uz[..., :-1, :, :])
        return out.masked_fill(g.pad_cell, 0.0)

    def _apply_bt(self, g: _Grids, p):
        """B^T p on the face grids, p[lo cell] - p[hi cell], with the last
        cell plane of the slab below (halo)."""
        pz = p.masked_fill(g.pad_cell, 0.0)
        zx = torch.zeros_like(pz[..., :1])
        tx = torch.cat([zx, pz], dim=-1) - torch.cat([pz, zx], dim=-1)
        p_dn = self.comm.halo_up(pz.narrow(Y, self.m - 1, 1))
        ty = torch.cat([p_dn, pz.narrow(Y, 0, self.m - 1)], dim=Y) - pz
        zz = torch.zeros_like(pz[..., :1, :, :])
        tz = torch.cat([zz, pz], dim=-3) - torch.cat([pz, zz], dim=-3)
        return (tx.masked_fill(g.ess[0], 0.0), ty.masked_fill(g.ess[1], 0.0),
                tz.masked_fill(g.ess[2], 0.0))

    # -- the sharded solve --------------------------------------------------------
    def _run_cg(self, apply_S, prec, vdot, rhs_s, x0t, max_iters: int, want_r_true=False,
                rtol: Optional[float] = None):
        """PCG on the slab Schur grids with thresh = rtol ||b|| (no atol
        clamp; `rtol` None is the solver's), true-residual restarts every
        restart_every iterations, a
        verified exit with 4x slack; the loop flag is reduced over every
        slab and sample row, so every rank runs the same iterations.
        Returns (x, iterations, rnorm, bnorm, converged, r_true)."""
        comm = self.comm
        one = torch.ones((), dtype=rhs_s.dtype, device=rhs_s.device)
        zero = torch.zeros((), dtype=rhs_s.dtype, device=rhs_s.device)
        col = lambda s: s[..., None, None, None]
        if x0t is None:
            x = torch.zeros_like(rhs_s)
            r = rhs_s
        else:
            x = x0t.expand(rhs_s.shape).contiguous()
            r = rhs_s - apply_S(x)
        z = prec(r)
        p = z
        rz = vdot(r, z)
        bn = torch.sqrt(vdot(rhs_s, rhs_s))
        thresh = (self.rtol if rtol is None else rtol) * bn
        rn = torch.sqrt(vdot(r, r))
        re_ = self.restart_every
        it = 0
        go = comm.any_all(rn > thresh)
        while it < max_iters and go:
            Ap = apply_S(p)
            pAp = vdot(p, Ap)
            alpha = torch.where(pAp > 0, rz / torch.where(pAp == 0, one, pAp), zero)
            active = rn > thresh
            alpha = torch.where(active, alpha, zero)
            x = x + col(alpha) * p
            r = r - col(alpha) * Ap
            # `it` is the same on every rank, so the restart is too.
            restart = re_ > 0 and (it + 1) % re_ == 0
            if restart:
                r = rhs_s - apply_S(x)
            z = prec(r)
            rz_new = vdot(r, z)
            if restart:
                beta = torch.zeros_like(rz)  # steepest-descent reset
            else:
                beta = torch.where(rz > 0, rz_new / torch.where(rz == 0, one, rz), zero)
            p = z + col(torch.where(active, beta, zero)) * p
            rz = rz_new
            rn = torch.sqrt(vdot(r, r))
            it += 1
            go = comm.any_all(rn > thresh)
        # Verify a claimed convergence against the true residual; the flag
        # is reduced over every rank, so the extra S application is too.
        claimed = rn <= thresh
        r_true = None
        if want_r_true:
            r_true = rhs_s - apply_S(x)
            rn = torch.sqrt(vdot(r_true, r_true))
            verified = True
        else:
            verified = comm.any_all(claimed)
            if verified:
                r_t = rhs_s - apply_S(x)
                rn = torch.sqrt(vdot(r_t, r_t))
        slack = torch.where(claimed, 4.0 * one, one) if verified else one
        return x, it, rn, bn, rn <= thresh * slack, r_true

    def _local_solve(self, w, x0t=None, lam0t=None, adjoint=False, max_iters=None, rtol=None):
        """The slab solve of local coefficient slabs w (n_local, rows, nz, m,
        nx); x0t a warm start in the p~ = -p convention, lam0t one of the
        adjoint, both slab-cut; `rtol` the primal's tolerance (None: the
        solver's; the adjoint keeps the solver's). Returns (Q, iterations,
        relres, converged, p~ slabs[, lambda slabs])."""
        g = self.grids
        comm = self.comm
        max_iters = self.max_iters if max_iters is None else int(max_iters)
        w = w.masked_fill(g.pad_cell, 1.0)
        w_dn = comm.halo_up(w.narrow(Y, self.m - 1, 1))
        mfac = self._minv_factor(g, w, w_dn)
        minv = lambda r: self._minv_apply(mfac, r)
        lead = w.shape[:2]
        full = lambda v: v.expand(lead + v.shape[2:]).contiguous()
        f = tuple(full(v) for v in g.rhs_u)
        rhs_s = self._apply_b(g, minv(f)) - g.rhs_p
        vdot = lambda a, b: comm.psum(torch.sum(a * b, dim=(-1, -2, -3)))
        apply_S = lambda p: self._apply_b(g, minv(self._apply_bt(g, p)))
        if self.precond == "coefmg":
            mg_state = self._slab_mg_state(g, w, w_dn)
            prec = lambda r: self._slab_mg_apply(mg_state, r)
        else:
            # diag(S_bar) Jacobi, scaled symmetrically by sqrt(w).
            sw = torch.sqrt(w)
            prec = lambda r: sw * (r / g.sdiag) * sw
        x, it, rn, bn, conv, r_true = self._run_cg(apply_S, prec, vdot, rhs_s, x0t, max_iters,
                                                   want_r_true=adjoint, rtol=rtol)
        bt = self._apply_bt(g, x)
        u = minv(tuple(fv - bv for fv, bv in zip(f, bt)))
        q = vdot(x, g.obs_p)
        for ua, oa in zip(u, g.obs_u):
            q = q + vdot(ua, oa)
        one = torch.ones((), dtype=bn.dtype, device=bn.device)
        rel = rn / torch.where(bn == 0, one, bn)
        lam = None
        if adjoint:
            # Goal-oriented correction: q_s = obs_p - B M(w)^{-1} obs_u, solve
            # S lam = q_s, add lam^T r_true (r_true from the primal exit check).
            q_s = full(g.obs_p) - self._apply_b(g, minv(tuple(full(v) for v in g.obs_u)))
            lam, it_a, rn_a, bn_a, conv_a, _ = self._run_cg(apply_S, prec, vdot, q_s, lam0t,
                                                            max_iters)
            q = q + vdot(lam, r_true)
            it = it + it_a
            rel = torch.maximum(rel, rn_a / torch.where(bn_a == 0, one, bn_a))
            conv = conv & conv_a
        return q[0], it, rel[0], conv[0], x, lam

    def _to_slabs(self, v: torch.Tensor, pad_value: float, rows: slice) -> torch.Tensor:
        """(B, n_s) flat cell fields -> the local (n_local, rows, nz, m, nx)
        slabs, ny padded with pad_value."""
        nx, ny, nz = self.shape
        vg = v[rows].reshape(-1, nz, ny, nx)
        if self.pad:
            vg = torch.cat([vg, vg.new_full((vg.shape[0], nz, self.pad, nx), pad_value)], dim=-2)
        vg = vg.unflatten(-2, (self.n_sp, self.m)).movedim(-3, 0)
        s0 = self.comm.slabs[0]
        return vg[s0: s0 + self.comm.n_local].contiguous()

    def _from_slabs(self, x: torch.Tensor) -> torch.Tensor:
        """Local (n_local, rows, nz, m, nx) slabs -> (B, n_s) flat fields of
        the whole batch (gathered in the distributed form)."""
        nx, ny, nz = self.shape
        full = self.comm.gather_slabs(x)  # (rows groups, n_sp, rows, nz, m, nx)
        full = full.movedim(1, -3).flatten(-3, -2).flatten(0, 1)  # (B, nz, ny_pad, nx)
        return full[..., :ny, :].reshape(full.shape[0], -1)

    def solve_fwd(self, w: torch.Tensor, p0: Optional[torch.Tensor] = None,
                  return_pressure: bool = False, lam0: Optional[torch.Tensor] = None,
                  adjoint: bool = False, max_iters: Optional[int] = None,
                  rtol: Optional[float] = None):
        """Solve for coefficient fields w (batch..., n_s) in the unsharded
        flat cell order; returns (Q, iterations, relres, converged[, p][,
        lam]) with the iterations broadcast to the batch and p the physical
        cell pressure (flat, unsharded order) when asked for. p0 warm-starts
        CG from a physical pressure of the same level; with adjoint the QoI
        is goal-oriented-corrected and lam0 warm-starts the adjoint solve
        (lam returned after p). `max_iters` overrides the Krylov budget,
        `rtol` the primal's tolerance.
        In the distributed form every rank passes the whole batch and gets
        the whole batch's results."""
        if lam0 is not None and not adjoint:
            raise ValueError("lam0 requires adjoint=True")
        batch = w.shape[:-1]
        if self.n_dp > 1 and (not batch or batch[0] % self.n_dp):
            raise ValueError(f"leading batch dim must be a multiple of n_dp={self.n_dp}")
        flat = lambda v: v.reshape((-1, self.n_s))
        B = flat(w).shape[0]
        rows = self.comm.local_rows(B)
        wg = self._to_slabs(flat(w), 1.0, rows)
        x0 = None if p0 is None else self._to_slabs(flat(-p0.expand(w.shape)), 0.0, rows)
        l0 = None if lam0 is None else self._to_slabs(flat(lam0.expand(w.shape)), 0.0, rows)
        q, it, rel, conv, x, lam = self._local_solve(wg, x0, l0, adjoint=adjoint,
                                                     max_iters=max_iters, rtol=rtol)
        gr = self.comm.gather_rows
        q, rel, conv = (gr(t).reshape(batch) for t in (q, rel, conv))
        its = torch.full(batch, it, dtype=torch.int64, device=q.device)
        out = (q, its, rel, conv)
        if return_pressure:
            out = out + ((-self._from_slabs(x)).reshape(w.shape),)
            if adjoint:
                out = out + (self._from_slabs(lam).reshape(w.shape),)
        return out
