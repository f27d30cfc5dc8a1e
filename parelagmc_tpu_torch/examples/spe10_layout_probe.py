"""Probe: does the grid-axis ORDER change the SPE10 V-cycle cost on the
card? Twin of examples/spe10_layout_probe.py.

The SPE10 grid (x, y, z) = (60, 220, 85) is stored as arrays (..., 85,
220, 60): x, 60 cells, is the contiguous minor axis. axis_order "auto"
(problems.resolve_axis_order) relabels the mesh so the largest axis is x
and minor, a choice made for the TPU's 128-lane tiles. This probe asks the
same question of the card: on the same 1.12M-cell box under the orders
(60, 220, 85), (220, 85, 60) and (220, 60, 85), the chain marginals
(spe10_struct_profile's timing) of the coefMG's fine S apply and of one
V(2,2) cycle, and each order's speed-up against the first. A synthetic
coefficient dinv0 = exp(0.3 N) on the faces: a layout probe, not a
physics run.

--smoke runs three tiny orders ((6, 22, 9) and its permutations) on the
device --device names.

Usage: python -m parelagmc_tpu_torch.examples.spe10_layout_probe
        [--batch 16] [--smoke] [--device cuda:0]
"""

import sys

import numpy as np
import torch

from parelagmc_tpu_torch.device import device_info, resolve_device
from parelagmc_tpu_torch.examples._evidence import marginal, marginal_line, normal_tensor
from parelagmc_tpu_torch.examples.spe10_mlmc import take_flag, take_option
from parelagmc_tpu_torch.examples.spe10_struct_profile import K, REPS
from parelagmc_tpu_torch.mesh.factories import make_box_mesh
from parelagmc_tpu_torch.ops import coef_multigrid_structured as cms

ORDERS = [(60, 220, 85), (220, 85, 60), (220, 60, 85)]  # (x, y, z): SPE10, then largest minor
SMOKE_ORDERS = [(6, 22, 9), (22, 9, 6), (22, 6, 9)]


def order_problem(order, batch: int, rng, dtype, device):
    """(mg, state, r) of one order: the coefMG ladder of the unit box of
    `order` cells, its setup for dinv0 = exp(0.3 N) on the faces, and a
    standard normal cell vector, drawn in that order from `rng`."""
    mesh = make_box_mesh(order)
    mg = cms.build_struct_coef_mg(mesh)
    dinv0 = normal_tensor(rng, (batch, mesh.num_faces), dtype, device, scale=0.3)
    state = cms.struct_mg_setup(mg, dinv0)
    r = normal_tensor(rng, (batch, mesh.num_cells), dtype, device)
    return mg, state, r


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    batch = int(take_option(argv, "--batch") or 16)
    orders = SMOKE_ORDERS if take_flag(argv, "--smoke") else ORDERS
    device = resolve_device(take_option(argv, "--device"))
    if argv:
        raise SystemExit(f"unknown arguments {argv}")
    info = device_info(device)
    print(f"device: {info}")
    rng = np.random.default_rng(0)
    out = {"device": info, "batch": batch, "K": K, "orders": []}
    for order in orders:
        mg, state, r = order_problem(order, batch, rng, torch.float32, device)
        print(f"order {order}: level shapes {[lvl.shape for lvl in mg.levels]}")
        sa = marginal(lambda x: cms.struct_s_apply(mg, state, x), r, K, REPS, device)
        print(marginal_line(f"s_apply {order}", sa, K, 34))
        vc = marginal(lambda x: cms.struct_v_cycle(mg, state, x), r, K, REPS, device)
        print(marginal_line(f"v_cycle(2,2) {order}", vc, K, 34))
        out["orders"].append(dict(order=list(order), s_apply=sa, v_cycle=vc))
        del mg, state, r
    base = out["orders"][0]
    for row in out["orders"]:
        row["s_apply_speedup"] = base["s_apply"]["ms"] / row["s_apply"]["ms"]
        row["v_cycle_speedup"] = base["v_cycle"]["ms"] / row["v_cycle"]["ms"]
        print(f"order {tuple(row['order'])}: s_apply {row['s_apply_speedup']:.2f}x, "
              f"v_cycle {row['v_cycle_speedup']:.2f}x vs current")
    return out


if __name__ == "__main__":
    main()
