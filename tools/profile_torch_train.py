"""Where the time of one SECOND training step of the PyTorch port goes, on
a GPU.

Full KITTI geometry, configs/second/all_classes.yaml, bf16, batch 8 x 18,000
synthetic points with 32 ground-truth boxes per frame, fresh seeded init
(the chip_smoke.py training workload). Prints:
  * per-part times from CUDA events (median of --iters steps): target
    assignment, voxelize + VFE + sort, the sparse middle extractor, RPN +
    head, loss, backward, clip + Adam;
  * the p50 host-clock time of unprofiled steps and the peak memory;
  * a torch.profiler table of ops and device kernels by device time over
    --iters steps, the device kernel time per step and its share of the
    unprofiled p50.

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
sys.path.insert(0, str(ROOT))

from vision3d_tpu_torch.bench import bench_config  # noqa: E402
from vision3d_tpu_torch.config import Config  # noqa: E402
from vision3d_tpu_torch.core.anchors import make_anchors  # noqa: E402
from vision3d_tpu_torch.core.targets import assign_targets_batch  # noqa: E402
from vision3d_tpu_torch.core.voxelize import voxelize_batch  # noqa: E402
from vision3d_tpu_torch.models.losses import proposal_loss  # noqa: E402
from vision3d_tpu_torch.models.second import build_middle_input  # noqa: E402
from vision3d_tpu_torch.synthetic import kitti_like_train_batch  # noqa: E402
from vision3d_tpu_torch.training.train import create_train_state, make_train_step  # noqa: E402


def parts(model, tx, state, batch, anchors):
    """One training step split at its parts, each bracketed by events."""
    cfg = model.cfg
    marks = [("start", torch.cuda.Event(enable_timing=True))]
    marks[-1][1].record()

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    with torch.no_grad():
        targets = assign_targets_batch(batch["boxes"], batch["class_idx"],
                                       batch["gt_mask"], batch["box_ignore"],
                                       anchors, cfg)
    mark("target assignment")
    tx.zero_grad()
    vox = voxelize_batch(batch["points"], batch["num_points"], cfg)
    st, _ = build_middle_input(cfg, vox)
    mark("voxelize+vfe+sort")
    bev, _ = model.cnn(st)
    mark("middle forward (plans, sparse convs, densify, dense convs, masked BN, to_bev)")
    cls_map, reg_map = model.head(model.rpn(bev.permute(0, 3, 1, 2).float()))
    mark("rpn+head forward")
    loss = proposal_loss(cls_map, reg_map, targets, cfg)["loss"]
    mark("loss")
    loss.backward()
    mark("backward")
    tx.step(state.step)
    state.step += 1
    mark("clip+adam")
    torch.cuda.synchronize()
    return {name: marks[i][1].elapsed_time(ev)
            for i, (name, ev) in enumerate(marks[1:])}


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
    runs = [parts(model, tx, state, batch, anchors) for _ in range(args.iters)]
    for name in runs[0]:
        print(f"part {name}: {np.median([r[name] for r in runs]):.3f} ms")
    print(f"part total: {np.median([sum(r.values()) for r in runs]):.3f} ms")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.iters):
            step(state, batch)
        torch.cuda.synchronize()
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
