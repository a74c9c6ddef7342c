"""Device time of the middle extractor (``model.cnn``: SpMiddleFHD, its
sparse stages on kernel B1 and its dense stages) per batch, in ms: the
kernels launched inside the ``cnn`` span."""

SUBMODULES = ["cnn"]
KERNELS = []


def read(run):
    us = run.trace.span_kernel_us(SUBMODULES)
    return us * 1e-3 / run.units if us > 0 else None
