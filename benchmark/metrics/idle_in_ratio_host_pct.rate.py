"""Device idle caused by the host work the ratio step adds over the pair
step, in %: of the profiled window's device idle time, the share whose
gaps' midpoints fall where the host's innermost program span was one of
`ratio.moments` (the 20 moment sums), `wait.ratio_copy` (the copies to
the host), `bayes.G` (G read off the pressure, the misfit) or
`bayes.likelihood` (the likelihood around its solve)
(programspans.idle_by_program_span). None where the program has none of
these spans or nothing was idle."""

import programspans

SPANS = ("ratio.moments", "wait.ratio_copy", "bayes.G", "bayes.likelihood")


def read(run):
    idle = programspans.idle_by_program_span(run)
    total = sum(idle.values()) if idle else 0.0
    if total <= 0 or not any(name in idle for name in SPANS):
        return None
    return 100.0 * sum(idle.get(name, 0.0) for name in SPANS) / total
