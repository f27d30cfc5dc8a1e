"""Sampler throughput harness: time batched Sample+Eval per level. Twin of
examples/sampler_performance.py.

Reference analog: examples/SPE10/SPE10_{PDESampler,EmbeddedPDESampler,
ProjectionPDESampler}_Performance.cpp:165-185 - time nsamples of
(Sample + Eval) per level and print the per-level timing table, plus dof
counts. Select the variant with --embedding and the mesh with --mesh
(spe10 for the reference configuration). The first batch of each level is
a warm-up and is not timed; the clock stops after the device has finished.
"""

import time

from parelagmc_tpu_torch.examples.common import parse_args
from parelagmc_tpu_torch.ops.prng import PRNGKey, fold_in
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.utils.timing import block_until_ready


def main(argv=None):
    cfg, device = parse_args(argv, initial_samples=256, batch_size=256)
    prob = build_problem(cfg, device=device)
    sampler = prob.sampler
    nsamples = cfg.initial_samples
    batch = cfg.batch_size
    key = PRNGKey(cfg.seed)
    print(
        f"-- Sampler performance: {cfg.sampler_name} embedding={cfg.embedding} "
        f"mesh={cfg.mesh} batch={batch}"
    )
    print("%8s %12s %14s %16s" % ("level", "stoch dofs", "sec/sample", "samples/sec"))
    for level in range(cfg.nlevels):
        def step(k, level=level):
            return sampler.eval(level, sampler.sample(level, k, batch))

        block_until_ready(step(key))  # warm-up
        nb = max(1, nsamples // batch)
        t0 = time.perf_counter()
        out = None
        for i in range(nb):
            out = step(fold_in(key, i))
        block_until_ready(out)
        dt = time.perf_counter() - t0
        n = nb * batch
        print(
            "%8d %12d %14.6g %16.1f"
            % (level, sampler.sample_size(level), dt / n, n / dt)
        )


if __name__ == "__main__":
    main()
