"""SECOND training-step benchmark of the PyTorch port (counterpart of the
repository's ``bench_train.py``).

    python -m vision3d_tpu_torch.bench_train [--batch 8] [--iters 5]
        [--reps 3] [--dense-from 4] [--quick] [--device cpu]

Prints ONE JSON line with ``bench_train.py``'s keys (train-step latency,
frames/s, the projected KITTI epoch time over 3712 frames) plus
``peak_mem_gib``. The workload is ``bench_train.py``'s: ``Config()`` with
one class, ``--dtype`` compute and ``train_dense_from_stage`` from
``--dense-from`` (4: every stage sparse), ``create_train_state`` from a
CPU generator seeded 0 with 928 steps an epoch, and the seed-0 batch of
``synthetic.kitti_like_train_batch`` (the ``kitti_like_points`` clouds of
``bench`` plus 32 car boxes a frame, each valid with probability 0.5).
``--quick`` shrinks the geometry and forces batch 2, 6000 points and 2
iterations.

Timing: a chain is ``--iters`` steps of ``make_train_step`` with the state
carried forward, then a read-back of the last loss (which synchronises),
on the host clock less one round trip (``bench.roundtrip_s``); the
headline is the p50 over ``--reps`` chains. ``compile_s`` is the seconds
of the first chain, including the kernels' build where none is cached. A
chain whose loss is not finite raises. One card: ``bench_train.py`` has no
mesh. Runs on ``cuda`` unless ``--device cpu``; without a card it exits
non-zero.
"""

import argparse
import json
import time

import numpy as np
import torch

from vision3d_tpu_torch.bench import (bench_config, device_name, require_device,
                                      roundtrip_s)

KITTI_TRAIN_FRAMES = 3712


def run(cfg, batch: int = 8, points: int = 18000, iters: int = 5, reps: int = 3,
        device: str = "cuda") -> dict:
    """The benchmark on ``device``. Returns the JSON line's record."""
    from vision3d_tpu_torch.synthetic import kitti_like_train_batch
    from vision3d_tpu_torch.training.train import create_train_state, make_train_step

    dev = torch.device(device)
    data = {k: torch.from_numpy(v).to(dev)
            for k, v in kitti_like_train_batch(0, batch, points).items()}
    if dev.type == "cuda":      # after the first allocation has set the card up
        torch.cuda.reset_peak_memory_stats(dev)
    model, tx, state = create_train_state(cfg, torch.Generator().manual_seed(0),
                                          steps_per_epoch=928, device=dev)
    step = make_train_step(model, tx, cfg)

    def chain():
        nonlocal state
        for _ in range(iters):
            state, losses = step(state, data)
        loss = float(losses["loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss} at step {state.step}")

    t0 = time.perf_counter()
    chain()
    compile_s = time.perf_counter() - t0
    rt = roundtrip_s(dev)
    per_step = []
    for _ in range(reps):
        t0 = time.perf_counter()
        chain()
        per_step.append(max(time.perf_counter() - t0 - rt, 1e-9) / iters)
    p50 = float(np.median(per_step))
    best = float(min(per_step))
    frames_s = batch / p50
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None)
    return {
        "metric": "second_train_step_ms",
        "value": round(p50 * 1e3, 1),
        "unit": "ms/step",
        "step_ms_best": round(best * 1e3, 1),
        "train_frames_per_sec": round(frames_s, 2),
        "epoch_minutes_kitti3712": round(KITTI_TRAIN_FRAMES / frames_s / 60, 2),
        "batch": batch,
        "points_per_frame": points,
        "compile_s": round(compile_s, 1),
        "dtype": cfg.compute_dtype,
        "device": device_name(dev),
        "backward": "rulebook-conv autograd functions: dX a gather_gemm (B2) conv "
                    "over the transpose rulebook, dW a gather_rows (B4) regather "
                    "plus one GEMM (no scatter-add)",
        "peak_mem_gib": None if peak is None else round(peak, 3),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--points", type=int, default=18000)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--dense-from", type=int, default=4,
                    help="train_dense_from_stage: the stages from this one on "
                         "train as dense conv3d volumes; 4 trains every stage "
                         "sparse")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.quick:
        args.batch, args.points, args.iters = 2, 6000, 2
    return args


def main(argv=None):
    """Parse ``argv``, run, print the JSON line and return its record."""
    args = parse_args(argv)
    require_device(args.device)
    cfg = bench_config(args.dtype, quick=args.quick,
                       train_dense_from_stage=args.dense_from)
    record = run(cfg, args.batch, args.points, args.iters, args.reps, args.device)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
