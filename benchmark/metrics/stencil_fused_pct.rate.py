"""Share of the structured coefMG V-cycle's grid passes that ran as the
fused CUDA kernels, in %: 100 x the change of the `kernel.coefmg_smooth`,
`kernel.coefmg_restrict` and `kernel.coefmg_prolong` launch counters over
the profiled `mlmc.batch` spans, over that plus the change of
`coefmg.eager_passes` (the passes run as plain PyTorch twins;
programspans.program_spans). A replayed graph adds the launches it
recorded at each replay. None without a profiled batch, or where the
program counts neither (one without the fused passes)."""

import programspans

FUSED = ("kernel.coefmg_smooth", "kernel.coefmg_restrict", "kernel.coefmg_prolong")


def read(run):
    fused = eager = 0
    for s in programspans.program_spans(run) or []:
        if s.name == "mlmc.batch":
            delta = s.attrs.get("counters", {})
            fused += sum(delta.get(k, 0) for k in FUSED)
            eager += delta.get("coefmg.eager_passes", 0)
    if fused + eager == 0:
        return None
    return 100.0 * fused / (fused + eager)
