"""Process start to the first timed unit: imports, the problem's build,
the kernels' build or load, and the warm-up of every shape (host clock)."""


def read(run):
    return run.setup_s
