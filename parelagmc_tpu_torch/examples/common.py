"""Shared example-driver plumbing: command line -> (ProblemConfig, device).

The port's twin of examples/common.py: every option under the same flag,
with the same default and the same precedence - the XML ParameterList of
`--xml-file` first (the reference drivers' one option,
examples/MLMC.cpp:54-57), then the driver's own `**defaults`, then the
command-line overrides; `--refinements` clears `nlevels`; `--solver-opt`
coerces to the field's type and exits on an unknown field. With no
arguments the drivers run the built-in golden parameters.

One option more: `--device` (default: cuda:0 through `resolve_device`,
which raises without a card; the CPU only when asked for, as the tests
do).

Under torchrun `parse_args` also joins the process group
(parallel/launch.init_from_env: NCCL with one card a rank, cuda:LOCAL_RANK
by default; gloo with `--device cpu`), so a driver's `--sample-shards -1`
or `--spatial-shards n` spreads over the ranks:

    python -m torch.distributed.run --standalone --nproc-per-node 8 \
        -m parelagmc_tpu_torch.examples.mlmc --sample-shards -1

Every rank then holds the same results; a driver prints them with `report`
and writes its files where `is_main()`, on rank 0 alone.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Tuple

import torch

from parelagmc_tpu_torch.config import ProblemConfig, read_xml_parameterlist
from parelagmc_tpu_torch.parallel.launch import init_from_env, is_main


def _attr_vec(s):
    return tuple(int(x) for x in s.split(",")) if s else None


def _axis_order(s):
    if s is None or s in ("auto", "none"):
        return s
    return tuple(int(x) for x in s.split(","))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("-f", "--xml-file", default=None,
                   help="reference-format XML ParameterList")
    p.add_argument("--mesh", default=None,
                   help="box | spe10 | egg | path/to/file.mesh")
    p.add_argument("--sampler", default=None, choices=["pde", "analytic", "matern"])
    p.add_argument("--embedding", default=None,
                   choices=["none", "matching", "projection"])
    p.add_argument("--projection-order", type=int, default=None,
                   choices=[0, 1],
                   help="mortar master-space order for --embedding "
                        "projection: 0 = P0 L2 projection (default), 1 = "
                        "through the P1 vertex space (higher-order "
                        "L2MortarIntegrator analog)")
    p.add_argument("--refinements", type=int, default=None)
    p.add_argument("--agglomerate", action="store_true",
                   help="treat the mesh file as the FINEST mesh and build "
                        "coarse levels by algebraic agglomeration "
                        "(reference: 'Unstructured coarsening')")
    p.add_argument("--coarsening-factor", type=int, default=None)
    p.add_argument("--corlen", type=float, default=None)
    p.add_argument("--variance", type=float, default=None)
    p.add_argument("--mse", type=float, default=None)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--qoi", default=None,
                   choices=["eff_perm", "p_int", "local_avg_p"])
    p.add_argument("--ess-attr", default=None,
                   help="comma-separated 0/1 per boundary attribute "
                        "(reference 'Essential attributes')")
    p.add_argument("--obs-attr", default=None)
    p.add_argument("--inflow-attr", default=None)
    p.add_argument("--dtype", default=None,
                   choices=["float32", "float64", "bfloat16"],
                   help="device dtype (bfloat16 is not ported: build_problem "
                        "raises)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--no-lognormal", action="store_true")
    p.add_argument("--normalize-marginals", dest="normalize_marginals",
                   action="store_true", default=None,
                   help="exact per-cell marginal-variance normalization of "
                        "the SPDE sampler field (config.normalize_marginals)")
    p.add_argument("--raw-marginals", dest="normalize_marginals",
                   action="store_false",
                   help="disable marginal normalization (reference parity)")
    p.add_argument("--axis-order", default=None,
                   help="grid-axis layout for tensor meshes: 'auto' (the "
                        "largest cell count becomes the x axis), 'none', "
                        "or an explicit permutation like '1,0,2' "
                        "(config.axis_order)")
    p.add_argument("--coarse-ops", default=None,
                   choices=["galerkin", "rediscretize"],
                   help="coarse Darcy coefficient operators "
                        "(config.coarse_operators)")
    p.add_argument("--sample-shards", type=int, default=None,
                   help="shard every estimator batch over this many "
                        "devices (-1 = all visible devices; "
                        "config.sample_shards); mutually exclusive with "
                        "--spatial-shards")
    p.add_argument("--spatial-shards", type=int, default=None,
                   help="shard each finest-level Darcy solve into this "
                        "many y-slabs (config.darcy_solver.spatial_shards; "
                        "parallel/spatial_darcy.py: all slabs in this "
                        "process, or one per rank under torch.distributed "
                        "with that many ranks)")
    p.add_argument("--spatial-sample-shards", type=int, default=None,
                   help="with --spatial-shards: additionally shard the "
                        "sample batch (shards * sample_shards ranks under "
                        "torch.distributed)")
    p.add_argument("--solver-opt", action="append", default=None,
                   metavar="KEY=VALUE",
                   help="set any DarcySolverConfig field by name, e.g. "
                        "--solver-opt coefmg_cheby_order=3 --solver-opt "
                        "coefmg_cheby_lo=0.10 --solver-opt "
                        "coefmg_prec_dtype=bfloat16 (values are coerced "
                        "to the dataclass field's type; the analog of the "
                        "reference's preconditioner ParameterList blocks, "
                        "src/Utilities.cpp)")
    p.add_argument("--output", default=None,
                   help="per-sample .dat log filename for the MC managers "
                        "(config.output_filename; reference 'Output "
                        "filename for MC managers')")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default cuda:0; without a "
                        "card pass --device cpu)")
    return p


def parse_args(argv=None, **defaults) -> Tuple[ProblemConfig, torch.device]:
    """(config, device) of a command line. The device is resolved here (and
    under torchrun the process group joined), so a driver run without a
    card and without --device raises before any work."""
    cfg, args = _parse(argv, defaults)
    return cfg, init_from_env(args.device)


def report(*args, **kwargs) -> None:
    """print, on rank 0 alone under torchrun (every rank holds the same
    results)."""
    if is_main():
        print(*args, **kwargs)


def parse_config(argv=None, **defaults) -> ProblemConfig:
    """The config of a command line, as examples/common.py's parse_config
    gives it (host only: `--device` is accepted and not resolved)."""
    return _parse(argv, defaults)[0]


def _parse(argv, defaults):
    args = build_parser().parse_args(argv)
    if args.xml_file:
        cfg = ProblemConfig.from_parameterlist(read_xml_parameterlist(args.xml_file))
    else:
        cfg = ProblemConfig()
    if defaults:
        cfg = dataclasses.replace(cfg, **defaults)

    override = {
        "mesh": args.mesh,
        "sampler_name": args.sampler,
        "embedding": args.embedding,
        "refinements": args.refinements,
        "correlation_length": args.corlen,
        "variance": args.variance,
        "mse": args.mse,
        "initial_samples": args.samples,
        "batch_size": args.batch,
        "qoi": args.qoi,
        "dtype": args.dtype,
        "seed": args.seed,
        "coarsening_factor": args.coarsening_factor,
        "ess_attr": _attr_vec(args.ess_attr),
        "obs_attr": _attr_vec(args.obs_attr),
        "inflow_attr": _attr_vec(args.inflow_attr),
        "normalize_marginals": args.normalize_marginals,
        "coarse_operators": args.coarse_ops,
        "projection_order": args.projection_order,
        "axis_order": _axis_order(args.axis_order),
        "sample_shards": args.sample_shards,
        "output_filename": args.output,
    }
    override = {k: v for k, v in override.items() if v is not None}
    if args.refinements is not None:
        override["nlevels"] = None
    if args.agglomerate:
        override["unstructured_coarsening"] = True
    if args.no_lognormal:
        override["lognormal"] = False
    if args.verbose:
        override["verbose"] = True
    cfg = dataclasses.replace(cfg, **override)
    if args.spatial_shards is not None:
        cfg.darcy_solver.spatial_shards = args.spatial_shards
    if args.spatial_sample_shards is not None:
        cfg.darcy_solver.spatial_sample_shards = args.spatial_sample_shards
    for kv in args.solver_opt or ():
        apply_solver_opt(cfg.darcy_solver, kv)
    return cfg, args


def apply_solver_opt(scfg, kv: str) -> None:
    """Apply one --solver-opt KEY=VALUE to a DarcySolverConfig, coercing
    VALUE to the field's current type."""
    key, sep, val = kv.partition("=")
    if not sep or not hasattr(scfg, key):
        raise SystemExit(
            f"--solver-opt {kv!r}: unknown DarcySolverConfig field "
            f"{key!r} (see parelagmc_tpu_torch/config.py)"
        )
    cur = getattr(scfg, key)
    coerce = type(cur) if cur is not None else str
    if coerce is bool:
        setattr(scfg, key, val.lower() in ("1", "true", "yes", "on"))
    else:
        setattr(scfg, key, coerce(val))
