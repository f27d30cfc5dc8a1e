"""Mean Krylov iterations per solve over the window, from each solve's
`info.iterations` (with the adjoint QoI, primal and adjoint together)."""


def read(run):
    its = [s[2] for s in run.solves]
    return sum(its) / len(its) if its else None
