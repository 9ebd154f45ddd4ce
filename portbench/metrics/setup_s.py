"""setup_s: from the process's first statement to the window's start:
imports, the CUDA context, loading (or the first run's building) of the
kernels, the weights, the warm-up and the checked first steps."""


def read(run):
    return run.setup_s
