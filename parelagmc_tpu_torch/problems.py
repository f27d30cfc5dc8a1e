"""Problem assembly: config -> (hierarchy, sampler, solver).

Port of parelagmc_tpu/problems.py for the tensor-grid configurations:

* "box": cfg.ncells is the COARSEST mesh, refined cfg.refinements times;
* "spe10": the full 60x220x85-cell SPE10 grid (20x10x2 ft cells); its odd
  z-count coarsens non-dyadically (the trailing layer merges into the last
  coarse cell);
* `axis_order` relabels the mesh axes ("auto": the largest cell count
  becomes x) together with every axis-coupled input - kinv_ref, the
  boundary-side attributes, lengths, qoi_point, the coefMG line-axis
  letters - so the physical problem is the same and the noise lands on the
  cells exactly as in the reference;
* a static `kinv_ref` (finest mesh, (n_s, d) or (n_s,)) goes to the solver.

The sampler is the SPDE sampler, without embedding. The Egg mesh, mesh
files, embeddings and the KL samplers raise NotImplementedError naming
their ROADMAP item instead of running something else.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.fem.hierarchy import GeometricHierarchy, build_geometric_hierarchy_from_fine
from parelagmc_tpu_torch.mesh.factories import SPE10_NCELLS, SPE10_SPACING, make_box_mesh
from parelagmc_tpu_torch.mesh.structured import _mfem_bdr_attr
from parelagmc_tpu_torch.device import resolve_device, torch_dtype
from parelagmc_tpu_torch.physics.darcy import DarcySolver
from parelagmc_tpu_torch.samplers.pde import SPDESampler


class Problem(NamedTuple):
    config: ProblemConfig
    hierarchy: GeometricHierarchy
    sampler: SPDESampler
    solver: DarcySolver
    dtype: torch.dtype
    device: torch.device


def _not_ported(what: str, item) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md Queue 1, item {item})")


def fine_mesh_spec(cfg: ProblemConfig):
    """(fine_ncells, fine_spacings) for the configured mesh."""
    if cfg.mesh == "box":
        f = 2 ** cfg.refinements
        return (tuple(n * f for n in cfg.ncells),
                [L / (n * f) for L, n in zip(cfg.lengths, cfg.ncells)])
    if cfg.mesh == "spe10":
        return tuple(SPE10_NCELLS), list(SPE10_SPACING)
    if cfg.mesh == "egg":
        raise _not_ported("mesh 'egg'", 7)
    raise _not_ported(f"mesh {cfg.mesh!r}", 15)


def resolve_axis_order(axis_order, fine_ncells) -> tuple:
    """cfg.axis_order -> an explicit permutation (new axis i = original
    axis order[i]); "auto" moves the largest cell count to x and keeps the
    other axes in their order."""
    d = len(fine_ncells)
    if axis_order is None or axis_order == "none":
        return tuple(range(d))
    if axis_order == "auto":
        i = int(np.argmax(fine_ncells))
        return (i,) + tuple(a for a in range(d) if a != i)
    order = tuple(int(a) for a in axis_order)
    if sorted(order) != list(range(d)):
        raise ValueError(f"axis_order {order} is not a permutation of 0..{d - 1}")
    return order


def permute_cell_field(field, ncells, order):
    """Re-flatten an x-fastest cell field (n,) or per-axis (n, d), given on
    the ORIGINAL `ncells` grid, to the permuted grid's x-fastest layout."""
    if field is None:
        return None
    field = np.asarray(field)
    d = len(ncells)
    order = tuple(order)
    if order == tuple(range(d)):
        return field
    grid_shape = tuple(int(n) for n in ncells[::-1])  # (z, y, x)
    # Output array position j holds new mesh axis d-1-j = original axis
    # order[d-1-j], which lives at input array position d-1-order[d-1-j].
    perm = tuple(d - 1 - order[d - 1 - j] for j in range(d))
    if field.ndim == 2:  # per-axis columns (n, d)
        g = field.reshape(grid_shape + (d,)).transpose(perm + (d,))
        return np.ascontiguousarray(g[..., list(order)]).reshape(-1, d)
    return np.ascontiguousarray(field.reshape(grid_shape).transpose(perm)).reshape(-1)


def permute_side_attrs(attrs, order):
    """Remap an MFEM-convention per-side attribute tuple: the data of the
    physical side (original axis order[i], side s) is addressed, after the
    relabel, by attr(new axis i, side s)."""
    d = len(order)
    if len(attrs) != 2 * d:
        return attrs  # not a box attribute list: left to the caller
    new = list(attrs)
    for i in range(d):
        for s in (0, 1):
            new[_mfem_bdr_attr(d, i, s) - 1] = attrs[_mfem_bdr_attr(d, order[i], s) - 1]
    return tuple(new)


def permute_config_axes(cfg: ProblemConfig, order) -> ProblemConfig:
    """Config with every axis-coupled field relabeled by `order` and
    axis_order cleared, so the permutation is applied once."""
    d = len(order)
    pick = lambda t: tuple(t[a] for a in order) if len(t) == d else tuple(t)
    # bayes_obs_coords is m points x d coords flattened.
    obs = tuple(cfg.bayes_obs_coords)
    if obs and len(obs) % d == 0:
        pts = [obs[i: i + d] for i in range(0, len(obs), d)]
        obs = tuple(p[a] for p in pts for a in order)
    # coefmg_line_axes letters name PHYSICAL axes; physical axis p lives at
    # new index order.index(p). "auto" and "" pass through.
    solver = cfg.darcy_solver
    la = (getattr(solver, "coefmg_line_axes", "") or "").strip().lower()
    if la and la != "auto":
        letters = "xyz"[:d]
        bad = sorted(set(c for c in la if c not in letters))
        if bad:
            raise ValueError(f"coefmg_line_axes={la!r}: unknown axis letter(s) {bad}; "
                             f"expected a subset of {letters!r} or 'auto'")
        solver = dataclasses.replace(
            solver, coefmg_line_axes="".join(letters[order.index(letters.index(c))] for c in la))
    return dataclasses.replace(
        cfg,
        axis_order=None,
        darcy_solver=solver,
        ncells=pick(cfg.ncells),
        lengths=pick(cfg.lengths),
        n_buffer=pick(cfg.n_buffer),
        qoi_point=pick(cfg.qoi_point),
        bayes_obs_coords=obs,
        ess_attr=permute_side_attrs(cfg.ess_attr, order),
        obs_attr=permute_side_attrs(cfg.obs_attr, order),
        inflow_attr=permute_side_attrs(cfg.inflow_attr, order),
    )


def build_problem(cfg: ProblemConfig, kinv_ref: Optional[np.ndarray] = None,
                  device=None) -> Problem:
    """Build the multilevel hierarchy, the SPDE sampler and the Darcy solver
    on `device` (None: cuda:0; without a card pass device="cpu"). The
    returned config is the relabeled one when axis_order permutes the axes."""
    if cfg.embedding != "none":
        raise _not_ported(f"embedding {cfg.embedding!r}", 11)
    if cfg.sampler_name != "pde":
        raise _not_ported(f"sampler {cfg.sampler_name!r}", 11)
    dtype = torch_dtype(cfg.dtype)
    device = resolve_device(device)
    fine_ncells, fine_spacings = fine_mesh_spec(cfg)
    order = resolve_axis_order(cfg.axis_order, fine_ncells)
    if order != tuple(range(len(fine_ncells))):
        kinv_ref = permute_cell_field(kinv_ref, fine_ncells, order)
        cfg = permute_config_axes(cfg, order)
        fine_ncells = tuple(fine_ncells[a] for a in order)
        fine_spacings = [fine_spacings[a] for a in order]
    fine = make_box_mesh(fine_ncells, spacings=fine_spacings)
    hier = build_geometric_hierarchy_from_fine(fine, cfg.nlevels)
    sampler = SPDESampler(hier, cfg, dtype, device)
    solver = DarcySolver(hier, cfg, dtype, device, kinv_ref=kinv_ref)
    return Problem(cfg, hier, sampler, solver, dtype, device)
