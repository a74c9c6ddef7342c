"""The share of the traced stretch in which no kernel, copy or fill ran on
the device, in %."""

SUBMODULES = []
KERNELS = []


def read(run):
    busy = run.trace.busy_us() * 1e-6
    return 100.0 * (1.0 - busy / run.wall_s) if busy > 0 else None
