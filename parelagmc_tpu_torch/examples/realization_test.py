"""Draw and save random-field realizations. Twin of
examples/realization_test.py (reference analog: examples/RealizationTest.cpp
+ the GLVis/VTK savers of the samplers, src/PDESampler.cpp:637-755). Writes
VTK rectilinear-grid files and MFEM/GLVis mesh+field files per level into
the working directory; --velocity-transfer runs the RT0 mortar transfer
check of the projection sampler on a simplicial mesh file instead."""

import sys

import numpy as np
import torch

from parelagmc_tpu_torch.examples.common import parse_args
from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.utils.io_vtk import save_field_glvis, save_mesh_mfem, save_vtk_cell_field


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    velocity_transfer = "--velocity-transfer" in argv
    if velocity_transfer:
        argv.remove("--velocity-transfer")
    cfg, device = parse_args(argv)
    prob = build_problem(cfg, device=device)
    key = PRNGKey(cfg.seed)
    if velocity_transfer:
        # Vector (RT0/H(div)) mortar transfer demo - the reference's
        # ParMortarAssembler::Transfer with is_vector_fe
        # (ParMortarAssembler.cpp:1146-1255): project the RT0 interpolant
        # of a constant velocity from the embedded mesh to the original
        # mesh per level and report the dof-wise reproduction error
        # (constants are in RT0, so an exact mortar projection reproduces
        # them).
        if not hasattr(prob.sampler, "transfer_velocity"):
            raise SystemExit(
                "--velocity-transfer requires the non-matching projection "
                "sampler (--embedding projection on an unstructured mesh)"
            )
        from parelagmc_tpu_torch.transfer_integrators import rt0_interpolate_constant

        vec = np.array([0.7, -0.3, 1.1])
        for level in range(cfg.nlevels):
            ol = prob.sampler.orig_hierarchy.levels[level]
            el = prob.sampler.hierarchy.levels[level]
            u_embed = rt0_interpolate_constant(el, vec)
            u_exact = rt0_interpolate_constant(ol, vec)
            v, info = prob.sampler.transfer_velocity(
                level, torch.as_tensor(u_embed, dtype=prob.dtype, device=prob.device))
            v = v.detach().cpu().numpy()
            err = float(
                np.max(np.abs(v - u_exact)) / max(np.max(np.abs(u_exact)), 1e-30)
            )
            print(
                f"level {level}: velocity transfer {el.n_u} -> {ol.n_u} "
                f"face dofs, cg iters {int(torch.as_tensor(info.iterations).max())}, "
                f"constant-field rel error {err:.3e}"
            )
        return
    for level in range(cfg.nlevels):
        xi = prob.sampler.sample(level, fold_in(key, level), 1)
        s = prob.sampler.eval(level, xi)[0].detach().cpu().numpy()
        mesh = prob.hierarchy.levels[level].mesh
        save_vtk_cell_field(mesh, s, f"realization_L{level:02d}.vtk")
        save_mesh_mfem(mesh, f"realization_mesh_L{level:02d}.mesh")
        save_field_glvis(mesh, s, f"realization_L{level:02d}.gf")
        print(
            f"level {level}: saved realization ({s.size} cells, "
            f"min={s.min():.4g} max={s.max():.4g})"
        )


if __name__ == "__main__":
    main()
