"""Training metrics: running averages + pluggable writers (copy of
``vision3d_tpu/training/metrics.py``): stdout lines, JSONL, and
TensorBoard, whose package is imported only when that writer is made.
Metric keys are ``<key>_cur`` / ``<key>_avg``."""

import json
import os
import time
from collections import defaultdict


class AverageMeter:
    """Running per-key totals."""

    def __init__(self):
        self.total = defaultdict(float)
        self.tally = defaultdict(int)
        self.current = defaultdict(float)

    def update(self, key, val):
        self.tally[key] += 1
        self.total[key] += val
        self.current[key] = val

    def average(self, key):
        return self.total[key] / max(self.tally[key], 1)


class JsonlWriter:
    def __init__(self, path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.f = open(path, "a")

    def write(self, step, metrics: dict):
        self.f.write(json.dumps(dict(step=step, time=time.time(), **metrics)) + "\n")
        self.f.flush()


class StdoutWriter:
    def write(self, step, metrics: dict):
        parts = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
        print(f"[step {step}] {parts}", flush=True)


class MetricLogger:
    """Meter + writer fanout, logging every ``interval`` steps."""

    def __init__(self, writers=(), interval=10):
        self.meter = AverageMeter()
        self.writers = list(writers) or [StdoutWriter()]
        self.interval = interval

    def update(self, step, losses: dict):
        for k, v in losses.items():
            self.meter.update(k, float(v))
        if step % self.interval == 0:
            out = {}
            for k in losses:
                out[f"{k}_cur"] = self.meter.current[k]
                out[f"{k}_avg"] = self.meter.average(k)
            for w in self.writers:
                w.write(step, out)


class TensorBoardWriter:
    """TensorBoard event files under ``logdir`` (needs the ``tensorboard``
    package, imported here and nowhere else)."""

    def __init__(self, logdir):
        from torch.utils.tensorboard import SummaryWriter

        self.w = SummaryWriter(logdir)

    def write(self, step, metrics: dict):
        for k, v in metrics.items():
            self.w.add_scalar(k, v, step)
        self.w.flush()
