"""Device time of the backward pass (``v3d:backward``) per training step, in
ms: the kernels launched on any thread while the span is open, since
autograd launches them from its own device thread."""

from harness import program_spans

SUBMODULES = []
KERNELS = []


def read(run):
    us = program_spans.kernel_us(run.trace, "backward", any_thread=True)
    return None if us is None else us * 1e-3 / run.units
