"""What the likelihood's pressure tolerance costs, in %: 100 x the change
of the program's `krylov.extra_iterations` counter (Krylov iterations a
likelihood solve ran after every row had met the configuration's own
tolerance) over the change of `krylov.iterations`, over the profiled
`mlmc.batch` spans (programspans.program_spans). None without a profiled
batch, or where the program counts no Krylov iteration; a program without
the counter reads 0 where it counts iterations."""

import programspans


def read(run):
    extra = iters = 0
    for s in programspans.program_spans(run) or []:
        if s.name == "mlmc.batch":
            delta = s.attrs.get("counters", {})
            extra += delta.get("krylov.extra_iterations", 0)
            iters += delta.get("krylov.iterations", 0)
    if iters == 0:
        return None
    return 100.0 * extra / iters
