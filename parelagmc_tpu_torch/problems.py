"""Problem assembly: config -> (hierarchy, sampler, solver).

Port of parelagmc_tpu/problems.py for the tensor-grid configurations:

* "box": cfg.ncells is the COARSEST mesh, refined cfg.refinements times;
* "spe10": the full 60x220x85-cell SPE10 grid (20x10x2 ft cells); its odd
  z-count coarsens non-dyadically (the trailing layer merges into the last
  coarse cell);
* "egg": the Egg-model grid (60x60x7 cells of 8x8x4); cfg.embedding adds
  the buffer layers;
* `axis_order` relabels the mesh axes ("auto": the largest cell count
  becomes x) together with every axis-coupled input - kinv_ref, the
  boundary-side attributes, lengths, qoi_point, the coefMG line-axis
  letters - so the physical problem is the same and the noise lands on the
  cells exactly as in the reference;
* a static `kinv_ref` (finest mesh, (n_s, d) or (n_s,)) goes to the solver.

The sampler follows cfg.sampler_name and cfg.embedding: the SPDE sampler
on the original mesh ("pde", "none"), on a matching enlarged mesh
("matching") or on a non-matching one with mortar projection
("projection"), or a KL sampler over the analytic exponential or the
Matern covariance ("analytic", "matern").

An MFEM mesh file (cfg.mesh = path ending in ".mesh") is the COARSEST
mesh, refined cfg.refinements times (examples/MLMC.cpp's semantics): one
that reads as a tensor grid takes the structured classes, a simplicial one
the unstructured stack (unstructured.py), where cfg.unstructured_coarsening
makes the file the FINEST mesh and agglomerates the coarse levels, and
cfg.embedding reads an enlarged mesh from cfg.embed_mesh or from the
file's "_embed.mesh" (matching) / "_enlarge.mesh" (projection) twin.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.fem.agglomeration import build_agglomerated_hierarchy
from parelagmc_tpu_torch.fem.hierarchy import (
    GeometricHierarchy,
    build_geometric_hierarchy,
    build_geometric_hierarchy_from_fine,
)
from parelagmc_tpu_torch.fem.simplicial_hierarchy import build_simplicial_hierarchy
from parelagmc_tpu_torch.mesh.factories import (
    EGG_NCELLS,
    EGG_SPACING,
    SPE10_NCELLS,
    SPE10_SPACING,
    make_box_mesh,
    make_embedded_box_mesh,
)
from parelagmc_tpu_torch.mesh.mfem_io import read_mfem_mesh
from parelagmc_tpu_torch.mesh.structured import StructuredMesh, _mfem_bdr_attr
from parelagmc_tpu_torch.device import resolve_device, torch_dtype
from parelagmc_tpu_torch.physics.darcy import DarcySolver
from parelagmc_tpu_torch.samplers.base import MLSampler
from parelagmc_tpu_torch.samplers.covariance import (
    AnalyticExponentialCovariance,
    MaternCovariance,
)
from parelagmc_tpu_torch.samplers.kl import KLSampler
from parelagmc_tpu_torch.samplers.pde import (
    EmbeddedSPDESampler,
    L2ProjectionSPDESampler,
    SPDESampler,
    _TensorSPDEBase,
)
from parelagmc_tpu_torch.unstructured import (
    UnstructuredDarcySolver,
    UnstructuredEmbeddedSPDESampler,
    UnstructuredProjectionSPDESampler,
    UnstructuredSPDESampler,
    build_embedded_simplicial_hierarchies,
    label_box_boundaries_gm,
)


class Problem(NamedTuple):
    config: ProblemConfig
    hierarchy: GeometricHierarchy
    embed_hierarchy: Optional[GeometricHierarchy]
    sampler: MLSampler
    solver: DarcySolver
    dtype: torch.dtype
    device: torch.device


def fine_mesh_spec(cfg: ProblemConfig):
    """(fine_ncells, fine_spacings) for the configured mesh."""
    if cfg.mesh == "box":
        f = 2 ** cfg.refinements
        return (tuple(n * f for n in cfg.ncells),
                [L / (n * f) for L, n in zip(cfg.lengths, cfg.ncells)])
    if cfg.mesh == "spe10":
        return tuple(SPE10_NCELLS), list(SPE10_SPACING)
    if cfg.mesh == "egg":
        return tuple(EGG_NCELLS), list(EGG_SPACING)
    raise ValueError(f"unknown mesh '{cfg.mesh}'")


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
    la = solver.coefmg_line_axes.strip().lower()
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
    """Build the multilevel hierarchy (and the embedded one, if any), the
    sampler and the Darcy solver on `device` (None: cuda:0; without a card
    pass device="cpu"). The returned config is the relabeled one when
    axis_order permutes the axes."""
    dtype = torch_dtype(cfg.dtype)
    device = resolve_device(device)
    if cfg.mesh.endswith(".mesh"):
        if cfg.axis_order is not None:
            warnings.warn("axis_order applies only to the tensor-grid factories "
                          "(box/spe10/egg); it is ignored for mesh files", stacklevel=2)
        return _build_from_mesh_file(cfg, dtype, device)
    fine_ncells, fine_spacings = fine_mesh_spec(cfg)
    order = resolve_axis_order(cfg.axis_order, fine_ncells)
    if order != tuple(range(len(fine_ncells))):
        kinv_ref = permute_cell_field(kinv_ref, fine_ncells, order)
        cfg = permute_config_axes(cfg, order)
        fine_ncells = tuple(fine_ncells[a] for a in order)
        fine_spacings = [fine_spacings[a] for a in order]
    if cfg.embedding == "matching" and any(n % 2 ** cfg.refinements for n in fine_ncells):
        # Matching embedding needs the 0/1 cell selection to hold on EVERY
        # level: with a non-dyadic axis both hierarchies merge their
        # trailing layer, but the original mesh merges at its own end and
        # the embedded mesh inside the buffer, so the interiors stop
        # aligning. Projection embedding has no such constraint: the mortar
        # coupling is the exact cell-overlap operator of each level pair.
        raise ValueError(
            "matching embedding requires per-axis cell counts divisible by "
            f"2^{cfg.refinements} so the embedded hierarchies stay aligned "
            "(use embedding='projection' for non-dyadic grids)"
        )
    fine = make_box_mesh(fine_ncells, spacings=fine_spacings)
    hier = build_geometric_hierarchy_from_fine(fine, cfg.nlevels)

    embed_hier = None
    if cfg.embedding != "none":
        nb = list(cfg.n_buffer)
        if len(nb) == 1:
            nb = nb * len(fine_ncells)
        f = 2 ** cfg.refinements
        # The buffer is given in coarsest-level cells (the enlarged base
        # mesh adds whole coarse layers).
        embed_fine = make_embedded_box_mesh(fine_ncells, spacings=fine_spacings,
                                            n_buffer=[b * f for b in nb])
        embed_hier = build_geometric_hierarchy_from_fine(embed_fine, cfg.nlevels)

    fine_mesh = hier.levels[0].mesh
    if cfg.sampler_name == "pde":
        if cfg.embedding == "matching":
            sampler = EmbeddedSPDESampler(hier, embed_hier, cfg, dtype, device)
        elif cfg.embedding == "projection":
            sampler = L2ProjectionSPDESampler(hier, embed_hier, cfg, dtype, device)
        elif cfg.embedding == "none":
            sampler = SPDESampler(hier, cfg, dtype, device)
        else:
            raise ValueError(f"unknown embedding '{cfg.embedding}'")
    elif cfg.sampler_name == "analytic":
        d = fine_mesh.dim
        nmodes = max(2, round(cfg.number_of_modes ** (1.0 / d)))
        cov = AnalyticExponentialCovariance(fine_mesh, cfg.correlation_length, [nmodes] * d)
        sampler = KLSampler(hier, cov, cfg, dtype, device)
    elif cfg.sampler_name == "matern":
        cov = MaternCovariance(fine_mesh, cfg.correlation_length, cfg.number_of_modes)
        sampler = KLSampler(hier, cov, cfg, dtype, device)
    else:
        raise ValueError(f"unknown sampler '{cfg.sampler_name}'")

    _check_marginal_norm_support(cfg, sampler)
    solver = DarcySolver(hier, cfg, dtype, device, kinv_ref=kinv_ref)
    return Problem(cfg, hier, embed_hier, sampler, solver, dtype, device)


def _check_marginal_norm_support(cfg: ProblemConfig, sampler) -> None:
    """normalize_marginals is implemented by the tensor SPDE samplers (the
    closed spectral form of the covariance diagonal); every other sampler
    ignores it. Warn instead of silently dropping the flag."""
    if cfg.normalize_marginals and not isinstance(sampler, _TensorSPDEBase):
        warnings.warn(
            "normalize_marginals=True has no effect on "
            f"{type(sampler).__name__} (only the tensor-grid SPDE "
            "samplers implement exact marginal normalization); the field "
            "keeps its raw per-level marginal variances"
        )


def _build_from_mesh_file(cfg: ProblemConfig, dtype: torch.dtype, device: torch.device) -> Problem:
    """Build from an MFEM mesh file (cfg.mesh = path), the file being the
    COARSEST mesh refined cfg.refinements times, or with
    unstructured_coarsening the FINEST mesh of an agglomerated hierarchy."""
    mesh = read_mfem_mesh(cfg.mesh)
    if isinstance(mesh, StructuredMesh):
        hier = build_geometric_hierarchy(mesh, cfg.nlevels)
        if cfg.sampler_name != "pde" or cfg.embedding != "none":
            raise ValueError("mesh-file configs currently support the plain SPDE sampler")
        sampler = SPDESampler(hier, cfg, dtype, device)
        solver = DarcySolver(hier, cfg, dtype, device)
        return Problem(cfg, hier, None, sampler, solver, dtype, device)

    if np.unique(mesh.boundary_attributes).size <= 1:
        # Single-attribute meshes: relabel the box sides so that the MFEM
        # attribute convention applies to BCs and QoIs.
        label_box_boundaries_gm(mesh)
    embed_hier = None
    selection = None
    if cfg.embedding != "none" and cfg.sampler_name != "pde":
        raise ValueError("embedding requires the SPDE sampler")
    if cfg.embedding != "none":
        embed_path = cfg.embed_mesh
        if not embed_path:
            stem = cfg.mesh[: -len(".mesh")]
            suffix = "_embed.mesh" if cfg.embedding == "matching" else "_enlarge.mesh"
            embed_path = stem + suffix
        if not os.path.exists(embed_path):
            raise ValueError(f"embedding='{cfg.embedding}' needs an enlarged mesh at "
                             f"'{embed_path}' (or set embed_mesh)")
        embed_gm = read_mfem_mesh(embed_path)
        if cfg.embedding == "matching":
            hier, embed_hier, selection = build_embedded_simplicial_hierarchies(
                mesh, embed_gm, cfg.nlevels, unstructured_coarsening=cfg.unstructured_coarsening,
                coarsening_factor=cfg.coarsening_factor)
        else:
            if cfg.unstructured_coarsening:
                raise ValueError("projection embedding with agglomeration is not wired yet; "
                                 "use matching embedding or refinement hierarchies")
            hier = build_simplicial_hierarchy(mesh, cfg.nlevels)
            embed_hier = build_simplicial_hierarchy(embed_gm, cfg.nlevels)
    elif cfg.unstructured_coarsening:
        # "Unstructured coarsening" (examples/MLMC.cpp): the file is the
        # FINEST mesh and the coarse levels come from agglomeration.
        hier = build_agglomerated_hierarchy(mesh, cfg.nlevels,
                                            coarsening_factor=cfg.coarsening_factor)
    else:
        hier = build_simplicial_hierarchy(mesh, cfg.nlevels)
    if cfg.sampler_name == "pde":
        if cfg.embedding == "matching":
            sampler = UnstructuredEmbeddedSPDESampler(hier, embed_hier, selection, cfg, dtype,
                                                      device)
        elif cfg.embedding == "projection":
            sampler = UnstructuredProjectionSPDESampler(hier, embed_hier, cfg, dtype, device)
        else:
            sampler = UnstructuredSPDESampler(hier, cfg, dtype, device)
    elif cfg.sampler_name == "matern":
        # The Matern KL expansion is mesh-agnostic (a dense kernel at the
        # cell centers).
        cov = MaternCovariance(hier.levels[0].mesh, cfg.correlation_length, cfg.number_of_modes)
        sampler = KLSampler(hier, cov, cfg, dtype, device)
    elif cfg.sampler_name == "analytic":
        d = mesh.dim
        nmodes = max(2, round(cfg.number_of_modes ** (1.0 / d)))
        cov = AnalyticExponentialCovariance(hier.levels[0].mesh, cfg.correlation_length,
                                            [nmodes] * d)
        sampler = KLSampler(hier, cov, cfg, dtype, device)
    else:
        raise ValueError(f"unknown sampler '{cfg.sampler_name}'")
    _check_marginal_norm_support(cfg, sampler)
    solver = UnstructuredDarcySolver(hier, cfg, dtype, device)
    return Problem(cfg, hier, embed_hier, sampler, solver, dtype, device)
