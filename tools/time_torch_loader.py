"""Time the PyTorch port's training loader alone on the host (no card):
the cost of one augmented frame in this process, then, per worker count,
each epoch's wall time, frames/s, the wait for its first batch and the
median / 90th-percentile gap between later batches.

    python tools/time_torch_loader.py --config configs/second/all_classes.yaml \
        --data-root DIR/training --split-dir DIR/splitfiles --cache-dir DIR/cache \
        [--workers 0 6] [--epochs 2] [--batch-size 8]

``train_cli``'s epoch line says how long the trainer waited for batches;
this says what the loader delivers when nothing else runs.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from vision3d_tpu_torch.config import Config
    from vision3d_tpu_torch.data.kitti import KittiDatasetTrain
    from vision3d_tpu_torch.data.loader import DataLoader
    from vision3d_tpu_torch.eval_cli import add_data_args, with_data_overrides

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    add_data_args(ap)
    ap.add_argument("--workers", type=int, nargs="+", default=[0, 6])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=8)
    args = ap.parse_args()

    cfg = with_data_overrides(Config.from_yaml(args.config), args)
    ds = KittiDatasetTrain(cfg, rng=np.random.default_rng(0))
    ds[0]
    per_frame = []
    for i in range(1, min(17, len(ds))):
        t0 = time.perf_counter()
        ds[i]
        per_frame.append(time.perf_counter() - t0)
    print(f"one frame in this process: median {1e3 * np.median(per_frame):.1f} ms "
          f"over {len(per_frame)} frames; {os.cpu_count()} cores", flush=True)
    for workers in args.workers:
        loader = DataLoader(ds, cfg, batch_size=args.batch_size, seed=0,
                            num_workers=workers)
        try:
            for epoch in range(args.epochs):
                t0 = last = time.perf_counter()
                gaps = []
                for _ in loader:
                    now = time.perf_counter()
                    gaps.append(now - last)
                    last = now
                dt = last - t0
                print(f"workers {workers} epoch {epoch}: {len(gaps)} batches in {dt:.2f} s "
                      f"({len(gaps) * args.batch_size / dt:.2f} frames/s); first batch "
                      f"{gaps[0]:.2f} s, later gaps median {np.median(gaps[1:]):.3f} s, "
                      f"p90 {np.percentile(gaps[1:], 90):.3f} s", flush=True)
        finally:
            loader.close()


if __name__ == "__main__":
    main()
