"""Share of the structured coefMG V-cycles that ran as a replayed CUDA
graph, in %: 100 x the `coefmg.graph_replays` counter's change over the
profiled `mlmc.batch` spans, over that plus the `coefmg.eager_cycles`
counter's change (programspans.program_spans). None without a profiled
batch, or where the program counts neither (one without the counters)."""

import programspans


def read(run):
    replays = eager = 0
    for s in programspans.program_spans(run) or []:
        if s.name == "mlmc.batch":
            delta = s.attrs.get("counters", {})
            replays += delta.get("coefmg.graph_replays", 0)
            eager += delta.get("coefmg.eager_cycles", 0)
    if replays + eager == 0:
        return None
    return 100.0 * replays / (replays + eager)
