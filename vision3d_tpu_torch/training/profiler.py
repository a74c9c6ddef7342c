"""Tracing of the port: the program's spans and a trace writer
(counterpart of ``vision3d_tpu/training/profiler.py``).

Usage:
    with trace_if("/tmp/traces", enabled=args.profile):
        for batch in loader:
            state, losses = step_fn(state, batch)

``annotate(name)`` is the port's one span: a ``torch.profiler``
``record_function`` range ``v3d:<name>`` while a profiler records, so its
events sit on the profiler's clock beside the card's kernels, and a shared
no-op context otherwise, so an untraced run pays one boolean test a span.
Spans nest by call: each batch's spans sit under ``v3d:inference`` and each
training step's under ``v3d:train_step``. ``v3d:sync`` marks each place on
the hot path that waits for the card: NMS's read-back, and every copy of a
host constant to the card (a blocking copy from pageable memory
synchronises the stream). ``trace_if`` records a
``torch.profiler`` trace (host ops, and the card's kernels where a card is
visible) and writes it as a Chrome trace, which Perfetto and TensorBoard's
profile plugin read.
"""

import contextlib
import os
import time

import torch

SPAN_PREFIX = "v3d:"
_OFF = contextlib.nullcontext()


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
    """The span ``v3d:<name>`` on the trace's timeline while a profiler
    records; else a no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _OFF
