"""Process start to the window's start: imports, the CUDA context, the
kernels' build or load, the problem's set-up and its warm-up operation."""


def read(run):
    return run.setup_s
