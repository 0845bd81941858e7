"""``setup_s``: the run's whole set-up, from the start of the process to
the window (imports, the inputs, building or loading the kernels, the
warm-up)."""


def read(run, record):
    return run.setup_s
