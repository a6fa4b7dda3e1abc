"""Process start to the window's start: imports, the CUDA context, the
build or load of the kernels, the data and the warm-up."""


def read(run):
    return run.setup_s
