"""Where the time of one SECOND training step of the PyTorch port goes, on
a GPU.

Full KITTI geometry, configs/second/all_classes.yaml, bf16, batch 8 x 18,000
synthetic points with 32 ground-truth boxes per frame, fresh seeded init
(the chip_smoke.py training workload). Prints:
  * the p50 host-clock time of unprofiled steps and the peak memory;
  * from one torch.profiler trace of --iters steps, every program span
    (``v3d:<name>``, ``training/profiler.annotate``: target assignment,
    the loss's forward and its layers, backward, all-reduce, optimizer) a
    step: calls, device ms of the kernels launched while it is open (on
    any thread: autograd launches the backward's from its own), idle ms
    inside it, self ms (its time less its child spans') and the idle ms of
    that self time (``benchmark/harness/program_spans.py`` reads the trace);
  * the same trace's table of ops and device kernels by device time, the
    device kernel time per step and its share of the unprofiled p50.

    python tools/profile_torch_train.py [--iters 3] [--backend {voxel,column}]
        [--dense-from-stage N] [--bench]

``--backend`` and ``--dense-from-stage`` (``cfg.train_dense_from_stage``,
default 4: every stage sparse) pick the training form. ``--bench`` takes
the workload of ``python -m vision3d_tpu_torch.bench_train`` instead:
``Config()`` with one class, every box a car.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "benchmark")]

from vision3d_tpu_torch.bench import bench_config  # noqa: E402
from vision3d_tpu_torch.config import Config  # noqa: E402
from vision3d_tpu_torch.core.anchors import make_anchors  # noqa: E402
from vision3d_tpu_torch.synthetic import kitti_like_train_batch  # noqa: E402
from vision3d_tpu_torch.training.train import create_train_state, make_train_step  # noqa: E402
from harness import program_spans, trace  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--backend", default="voxel", choices=["voxel", "column"])
    ap.add_argument("--dense-from-stage", type=int, default=4)
    ap.add_argument("--bench", action="store_true",
                    help="bench_train's workload: Config() with one class")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    form = dict(compute_dtype="bfloat16", sparse_backend=args.backend,
                train_dense_from_stage=args.dense_from_stage)
    if args.bench:
        cfg = bench_config().replace(**form)
        data = kitti_like_train_batch(0, 8, 18000)
    else:
        cfg = Config.from_yaml(str(ROOT / "configs/second/all_classes.yaml")).replace(**form)
        data = kitti_like_train_batch(0, 8, 18000, cfg=cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    model, tx, state = create_train_state(cfg, torch.Generator().manual_seed(0),
                                          steps_per_epoch=928, device=dev)
    anchors = torch.as_tensor(make_anchors(cfg), device=dev)
    step = make_train_step(model, tx, cfg, anchors)

    # torch's default precision settings, as chip_smoke.py's training phase
    for _ in range(2):
        step(state, batch)
    torch.cuda.reset_peak_memory_stats()
    wall = []
    for _ in range(args.iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
    p50 = float(np.median(wall))
    print(f"step p50 {p50:.3f} ms over {args.iters} steps, peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    with trace.profiler() as prof:
        for _ in range(args.iters):
            step(state, batch)
        torch.cuda.synchronize()
    print(program_spans.format_table(trace.Trace(prof), args.iters, "step"))
    events = prof.key_averages()
    # kernels only: an aten op's row repeats the device time of its kernels
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    print(events.table(sort_by="self_device_time_total", row_limit=45,
                       max_name_column_width=60))
    per_step = dev_us / 1e3 / args.iters
    print(f"device kernel time per step {per_step:.3f} ms, "
          f"share of the unprofiled p50 {per_step / p50:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
