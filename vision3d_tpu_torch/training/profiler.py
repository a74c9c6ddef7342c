"""Profiling and tracing hooks (counterpart of
``vision3d_tpu/training/profiler.py``).

Usage:
    with trace_if("/tmp/traces", enabled=args.profile):
        for batch in loader:
            with annotate("train_step"):
                state, losses = step_fn(state, batch)

``trace_if`` records a ``torch.profiler`` trace (host ops, and the card's
kernels where a card is visible) and writes it as a Chrome trace, which
Perfetto and TensorBoard's profile plugin read. ``StageTimer`` gives coarse
host wall timings that synchronise the device before a stage's clock stops.
"""

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace_if(logdir: str, enabled: bool = True):
    """A ``torch.profiler`` trace of the block (CPU activity, and CUDA where
    a card is visible), written on exit to
    ``logdir/trace_<pid>_<ns>.pt.trace.json``; a no-op when disabled."""
    if not enabled:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """A named region that shows up on the trace's timeline."""
    return torch.profiler.record_function(name)


def _devices(value, found):
    """The CUDA devices of the tensors in ``value`` (nested dicts, lists,
    tuples)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            found.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _devices(v, found)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _devices(v, found)
    return found


class StageTimer:
    """Host wall timing with device synchronization per stage."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str, sync_value=None):
        """Time the block; with ``sync_value`` (tensors, or dicts / lists /
        tuples of them) every card that holds one of them is synchronised
        before the clock stops."""
        t0 = time.perf_counter()
        yield
        for dev in _devices(sync_value, set()):
            torch.cuda.synchronize(dev)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> str:
        rows = [
            f"{k}: {self.totals[k] / max(self.counts[k], 1) * 1e3:.2f} ms avg"
            f" over {self.counts[k]}"
            for k in sorted(self.totals)
        ]
        return "\n".join(rows)
