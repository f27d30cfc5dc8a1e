"""SPE10-scale performance of the plain, embedded and projection SPDE
samplers. Twin of examples/spe10_sampler_performance.py.

Reference analog: examples/SPE10/SPE10_EmbeddedPDESampler_Performance.cpp
and SPE10_ProjectionPDESampler_Performance.cpp (per-level Sample+Eval
timers), plus the L2-projector apply timer of
src/L2ProjectionPDESampler.cpp:499-525. Writes
SPE10_SAMPLER_EVIDENCE_TORCH.json (never the JAX package's file) with the
device it ran on.

Grid: the embedded hierarchies need per-axis cell counts divisible by
2^refinements, and SPE10's z = 85 is odd, so all three variants run on
60x220x84 cells with the true SPE10 extents (1200x2200x170 ft). The buffer
is 1 coarse layer (= 2^refinements fine layers) per side: the embedded
solve grid is 68x228x92.

Per level and variant, with a distinct key per measured call (the
original's keys, so both packages draw the same samples) and a host copy
of each result (which waits for the card):
  * sample_eval: xi -> field on the ORIGINAL mesh (noise, tensor-spectral
    SPDE solve on the solve mesh, selection / mortar projection back).
    Tensor solves are exact (no Krylov): finiteness and the moments are
    the checks.
  * embed_eval (embedded/projection): the same without the final
    restriction - the difference isolates the selection gather / mortar
    ELL cost.
  * projector_apply (projection only): the G apply and W^-1 scale alone
    (reference "L2 Projector: Apply" timer), on one embedded field.
  * hbm_bytes (level 0, on a card): the peak of torch.cuda's allocator over
    one sample_eval call (max_memory_allocated after
    reset_peak_memory_stats); absent on the CPU.
`compile_sec` is the wall of the first (warm-up) call.

Usage: python -m parelagmc_tpu_torch.examples.spe10_sampler_performance
        [--samples 256] [--batch 256] [--variants plain,matching,projection]
        [--grid 60,220,84] [--out F.json] [--device cuda:0]
"""

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from parelagmc_tpu_torch.device import device_info, synchronize
from parelagmc_tpu_torch.examples._evidence import host
from parelagmc_tpu_torch.examples.common import is_main, parse_args, report
from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
from parelagmc_tpu_torch.problems import build_problem

GRID = (60, 220, 84)  # embed-aligned SPE10 grid (z=85 is odd; see docstring)
EXTENTS = (1200.0, 2200.0, 170.0)  # true SPE10 ft extents
DEFAULT_OUT = "SPE10_SAMPLER_EVIDENCE_TORCH.json"


def timed(fn, key, batch, reps, label):
    """Best-of-3 rounds of `reps` calls with distinct keys + host copy."""
    t0 = time.perf_counter()
    w = host(fn(fold_in(key, 987654))[0])
    compile_s = time.perf_counter() - t0
    if not np.all(np.isfinite(w)):
        raise RuntimeError(f"{label}: warmup produced non-finite values")
    dt = np.inf
    for r in range(3):
        t0 = time.perf_counter()
        outs = [fn(fold_in(key, 100 * r + 10 + i)) for i in range(reps)]
        _ = [host(o[0]) for o in outs]
        d = time.perf_counter() - t0
        dt = min(dt, d)
    n = reps * batch
    report(
        f"  {label:26s} {dt / n * 1e3:10.4f} ms/sample "
        f"{n / dt:12.1f} samples/s (compile {compile_s:.1f}s)"
    )
    return {
        "sec_per_sample": dt / n,
        "samples_per_sec": n / dt,
        "compile_sec": compile_s,
    }


def moments(s: torch.Tensor):
    """Per-sample mean and (population) standard deviation of fields."""
    return torch.mean(s, dim=-1), torch.std(s, dim=-1, correction=0)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)

    def _pop(flag, default, cast):
        if flag in argv:
            i = argv.index(flag)
            v = cast(argv[i + 1])
            del argv[i: i + 2]
            return v
        return default

    variants = _pop("--variants", "plain,matching,projection", str).split(",")
    out_file = _pop("--out", DEFAULT_OUT, str)
    grid = _pop("--grid", None, lambda s: tuple(int(x) for x in s.split(",")))
    grid = grid if grid is not None else GRID

    evidence = {
        "grid": f"{grid[0]}x{grid[1]}x{grid[2]} cells, SPE10 extents "
                "1200x2200x170 ft (z=84 default: embedded hierarchies need "
                "divisibility by 2^refinements; SPE10's z=85 is odd)",
        "buffer": "1 coarse layer per side (embedded solve grid 68x228x92)",
        "variants": {},
    }
    device = None
    for variant in variants:
        embedding = {"plain": "none", "matching": "matching",
                     "projection": "projection"}[variant]
        cfg, device = parse_args(
            list(argv),
            mesh="box",
            refinements=2,
            correlation_length=100.0,
            initial_samples=256,
            batch_size=256,
            normalize_marginals=True,
            axis_order="auto",
            embedding=embedding,
        )
        # Scaled box with the SPE10 extents: ncells is the COARSEST mesh.
        f = 2 ** cfg.refinements
        cfg = dataclasses.replace(
            cfg, ncells=tuple(g // f for g in grid), lengths=EXTENTS
        )
        t0 = time.perf_counter()
        prob = build_problem(cfg, device=device)
        setup_s = time.perf_counter() - t0
        sampler = prob.sampler
        batch = cfg.batch_size
        reps = max(2, cfg.initial_samples // batch)
        key = PRNGKey(cfg.seed)
        rows = []
        report(f"-- variant {variant}: batch {batch}, {cfg.nlevels} levels "
               f"(host setup {setup_s:.1f}s)")
        for level in range(cfg.nlevels):
            row = {
                "level": level,
                "solve_dofs": int(sampler.sample_size(level)),
                "field_dofs": int(sampler.field_size(level))
                if hasattr(sampler, "field_size")
                else int(sampler.sample_size(level)),
                "batch": batch,
            }
            if level == 0:
                row["setup_sec"] = setup_s

            def sample_eval(k, level=level):
                # O(batch) per-sample moments to the host, not the field.
                return moments(sampler.eval(level, sampler.sample(level, k, batch)))

            if level == 0 and device.type == "cuda":
                synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
                host(sample_eval(fold_in(key, 987653))[0])
                row["hbm_bytes"] = int(torch.cuda.max_memory_allocated(device))
                report(f"  level-0 peak device memory (allocator): "
                       f"{row['hbm_bytes'] / 1e9:.2f} GB")
            row["sample_eval"] = timed(sample_eval, key, batch, reps, "Sample+Eval")
            # Moment check on one more draw: the mean of the normalized
            # lognormal field should sit near exp(sigma^2/2).
            mcheck = sample_eval(fold_in(key, 5))
            row["field_mean"] = float(np.mean(host(mcheck[0])))
            row["field_std"] = float(np.mean(host(mcheck[1])))

            if embedding != "none":

                def embed_eval(k, level=level):
                    return moments(sampler.embed_eval(level, sampler.sample(level, k, batch)))

                row["embed_eval"] = timed(embed_eval, key, batch, reps, "EmbedEval")
                row["restriction_overhead_ms"] = (
                    row["sample_eval"]["sec_per_sample"]
                    - row["embed_eval"]["sec_per_sample"]
                ) * 1e3
            if embedding == "projection":
                # Standalone mortar apply (reference "L2 Projector: Apply")
                # on one embedded field; each call applies it again.
                s_embed = sampler.embed_eval(
                    level, sampler.sample(level, fold_in(key, 3), batch)
                )

                def proj(k, level=level, s_embed=s_embed):
                    p = sampler.project(level, s_embed)
                    return torch.mean(p, dim=-1), None

                row["projector_apply"] = timed(proj, key, batch, reps, "Projector apply")
            rows.append(row)
        evidence["variants"][variant] = rows

    evidence["device"] = device_info(device)
    if is_main():
        with open(out_file, "w") as fjson:
            json.dump(evidence, fjson, indent=1)
    report(f"wrote {out_file}")
    return evidence


if __name__ == "__main__":
    main()
