"""Host seconds from the start of the run's process to the window's
opening: imports, CUDA start, data generation, the index build, the store
written and opened, kernels built and loaded, the HTTP path warmed with
one deck of the mix's templates."""


def read(rec):
    return rec["setup_s"]
