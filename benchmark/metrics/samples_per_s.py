"""All samples the window completed over the window's whole time (host
clock, from the first unit's start to the last unit's end)."""


def read(run):
    return sum(n for _, _, n in run.units) / run.window_s
