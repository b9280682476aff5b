"""setup_s: seconds from the start of the process to the window: imports,
the kernels' build where it is not cached, generation, compress, plans
and the warm-up calls (host clock)."""


def read(run):
    return run.setup_s
