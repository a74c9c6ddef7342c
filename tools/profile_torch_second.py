"""Where the time of the PyTorch port's SECOND inference goes, on a GPU.

Full KITTI geometry, configs/second/all_classes.yaml with the exported
trained weights, bf16, batch 8 x 18,000 synthetic points (the
chip_smoke.py workload), on the voxel or the column backend. Prints:
  * the p50 host-clock latency of unprofiled forwards;
  * from one torch.profiler trace of --iters forwards, every program span
    (``v3d:<name>``, ``training/profiler.annotate``) a forward: calls,
    device ms of the kernels launched while it is open, idle ms inside it,
    self ms (its time less its child spans') and the idle ms of that self
    time (``benchmark/harness/program_spans.py`` reads the trace);
  * the same trace's table of ops and device kernels by device time, the
    device kernel time per forward, and its share of the unprofiled
    latency (the profiler's own host cost makes the profiled window's
    wall time useless for that).

    python tools/profile_torch_second.py [--iters 5] [--backend {voxel,column}]
        [--dense-from-stage N]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "benchmark")]

from vision3d_tpu_torch import convert  # noqa: E402
from vision3d_tpu_torch.config import Config  # noqa: E402
from vision3d_tpu_torch.models.second import create_second  # noqa: E402
from vision3d_tpu_torch.synthetic import kitti_like_batch  # noqa: E402
from harness import program_spans, trace  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--backend", choices=("voxel", "column"), default="voxel")
    ap.add_argument("--dense-from-stage", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_second: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = Config.from_yaml(str(ROOT / "configs/second/all_classes.yaml")).replace(
        compute_dtype="bfloat16", sparse_backend=args.backend,
        dense_from_stage=args.dense_from_stage)
    print(f"backend {args.backend}, dense_from_stage {args.dense_from_stage}")
    sd = convert.state_dict_from_flax(convert.load_npz(
        ROOT / "vision3d_tpu_torch/weights/second_all_classes_epoch11.npz"))
    model, anchors = create_second(cfg, device=dev, state_dict=sd)
    pts, num = kitti_like_batch(0, 8, 18000)
    points, num = torch.from_numpy(pts).to(dev), torch.from_numpy(num).to(dev)

    # torch's default precision settings, as chip_smoke.py's end-to-end phase
    with torch.no_grad():
        for _ in range(2):
            model.inference(points, num, anchors)
        wall = []
        for _ in range(args.iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.inference(points, num, anchors)
            torch.cuda.synchronize()
            wall.append(1e3 * (time.perf_counter() - t0))
        p50 = float(np.median(wall))
        print(f"latency p50 {p50:.3f} ms over {args.iters} forwards")
        with trace.profiler() as prof:
            for _ in range(args.iters):
                model.inference(points, num, anchors)
            torch.cuda.synchronize()
    print(program_spans.format_table(trace.Trace(prof), args.iters, "forward"))
    events = prof.key_averages()
    # kernels only: an aten op's row repeats the device time of its kernels
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    print(table)
    per_fwd = dev_us / 1e3 / args.iters
    print(f"device kernel time per forward {per_fwd:.3f} ms, "
          f"share of the unprofiled p50 {per_fwd / p50:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
