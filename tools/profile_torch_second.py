"""Where the time of the PyTorch port's SECOND inference goes, on a GPU.

Full KITTI geometry, configs/second/all_classes.yaml with the exported
trained weights, bf16, batch 8 x 18,000 synthetic points (the
chip_smoke.py workload), on the voxel or the column backend. Prints:
  * per-stage times from CUDA events (median of --iters forwards):
    voxelize + VFE + sort, the SpMiddleFHD middle extractor, RPN + head,
    decode + NMS;
  * the p50 host-clock latency of unprofiled forwards;
  * a torch.profiler table of ops and device kernels by device time over
    --iters forwards, the device kernel time per forward, and its share
    of the unprofiled latency (the profiler's own host cost makes the
    profiled window's wall time useless for that).

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
sys.path.insert(0, str(ROOT))

from vision3d_tpu_torch import convert  # noqa: E402
from vision3d_tpu_torch.config import Config  # noqa: E402
from vision3d_tpu_torch.core.voxelize import voxelize_batch  # noqa: E402
from vision3d_tpu_torch.models.head import head_inference  # noqa: E402
from vision3d_tpu_torch.models.second import build_middle_input, create_second  # noqa: E402
from vision3d_tpu_torch.synthetic import kitti_like_batch  # noqa: E402


def stages(model, anchors, points, num):
    """One forward split at stage boundaries, each bracketed by events."""
    cfg = model.cfg
    marks = [("start", torch.cuda.Event(enable_timing=True))]
    marks[-1][1].record()

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    st, _ = build_middle_input(cfg, voxelize_batch(points, num, cfg))
    mark("voxelize+vfe+" + ("columns" if cfg.sparse_backend == "column" else "sort"))
    bev, _ = model.cnn(st)
    mark("middle (plans, sparse convs, densify, dense convs)")
    cls_map, reg_map = model.head(model.rpn(bev.permute(0, 3, 1, 2).float()))
    mark("rpn+head")
    head_inference(cls_map, reg_map, anchors, cfg)
    mark("decode+nms")
    torch.cuda.synchronize()
    return {name: marks[i][1].elapsed_time(ev)
            for i, (name, ev) in enumerate(marks[1:])}


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
        runs = [stages(model, anchors, points, num) for _ in range(args.iters)]
        for name in runs[0]:
            print(f"stage {name}: {np.median([r[name] for r in runs]):.3f} ms")
        print(f"stage total: {np.median([sum(r.values()) for r in runs]):.3f} ms")

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.iters):
                model.inference(points, num, anchors)
            torch.cuda.synchronize()
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
