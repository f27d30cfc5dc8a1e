"""Problem assembly: config -> (hierarchy, sampler, solver).

Port of parelagmc_tpu/problems.py for the configurations of the golden MLMC
path: the "box" mesh (cfg.ncells is the COARSEST mesh, refined
cfg.refinements times), no embedding, the SPDE sampler and the natural axis
order. Every other choice raises NotImplementedError naming its ROADMAP
item instead of running something else.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem.hierarchy import GeometricHierarchy, build_geometric_hierarchy_from_fine
from parelagmc_tpu.mesh.factories import make_box_mesh
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


def build_problem(cfg: ProblemConfig, kinv_ref: Optional[np.ndarray] = None,
                  device=None) -> Problem:
    """Build the multilevel hierarchy, the SPDE sampler and the cg-schur
    Darcy solver on `device` (None: the CPU)."""
    if cfg.mesh != "box":
        raise _not_ported(f"mesh {cfg.mesh!r}", "7 (SPE10/Egg) or 15 (mesh files)")
    if cfg.embedding != "none":
        raise _not_ported(f"embedding {cfg.embedding!r}", 11)
    if cfg.sampler_name != "pde":
        raise _not_ported(f"sampler {cfg.sampler_name!r}", 11)
    if cfg.axis_order not in (None, "none"):
        raise _not_ported("axis_order", 7)
    if kinv_ref is not None:
        raise _not_ported("kinv_ref", 7)
    dtype = torch_dtype(cfg.dtype)
    device = resolve_device(device)
    f = 2 ** cfg.refinements
    fine = make_box_mesh(
        tuple(n * f for n in cfg.ncells),
        spacings=[L / (n * f) for L, n in zip(cfg.lengths, cfg.ncells)],
    )
    hier = build_geometric_hierarchy_from_fine(fine, cfg.nlevels)
    sampler = SPDESampler(hier, cfg, dtype, device)
    solver = DarcySolver(hier, cfg, dtype, device)
    return Problem(cfg, hier, sampler, solver, dtype, device)
