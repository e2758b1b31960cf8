"""Everything before the window: imports, the table and traffic made from
the seed, the program started and warmed (a first run also builds the
kernels)."""


def read(run):
    return run.setup_s
