"""Training entry point of the PyTorch port, on one card or several
(counterpart of ``vision3d_tpu/train_cli.py``).

    python -m vision3d_tpu_torch.train_cli --config configs/second/all_classes.yaml \\
        --data-root .../training --split-dir .../splitfiles --cache-dir .../cache

Trains SECOND, or PV-RCNN (``--model pvrcnn``: stage 1 alone;
``pvrcnn2``: both stages), from KITTI-format data: ``KittiDatasetTrain``
(augmentation in ``--workers`` spawned processes) feeding
``make_train_step`` / ``make_pvrcnn_train_step`` on the card, per-step
learning-rate schedule, gradient clip, metrics every 10 steps (stdout
and ``--metrics-jsonl``), one line per epoch with frames/s and the share
of the epoch spent waiting for the loader, and a checkpoint every
``ckpt_interval_epochs`` and after the last epoch; ``--resume``
continues from the newest checkpoint in ``--ckpt-dir``. Runs on ``cuda``
unless ``--device cpu``.

A two-stage step draws its grid points and random background keypoints
from a CPU generator seeded from (``--seed``, step).

``--dense-from 2`` or ``3`` (``cfg.train_dense_from_stage``) trains the
late stages as dense masked volumes (cuDNN conv3d), for every ``--model``;
a yaml with ``SPARSE_BACKEND: column`` trains on the column backend (BEV
columns dense in z), for every ``--model`` and also with ``--dense-from``.

Several cards: one process per card in a ``torch.distributed`` group
(``parallel/mesh.py``). ``cfg.train.batch_size`` is the global batch; each
process loads its shard of it (``DataLoader(num_shards, shard_id)``, with
``--workers`` loader processes each) and the step's sums are the global
batch's. With ``COORDINATOR_ADDRESS`` (host:port), ``NUM_PROCESSES`` and
``PROCESS_ID`` set, this process is that rank (NCCL on the card, gloo with
``--device cpu``); ``VISION3D_MULTIHOST=1`` reads torch's ``env://``
variables. Without them, on ``cuda`` with several visible cards, it starts
one process per card on the largest count that divides the batch (the JAX
CLI's rule) and returns rank 0's records. Only rank 0 logs, prints and
writes checkpoints; its epoch line counts the global batch's frames.
"""

import argparse
import dataclasses
import sys
import time

import numpy as np


def main(argv=None):
    """Returns one record per epoch run: steps, seconds, frames/s, host
    wait, the card's peak memory (None on the CPU), the loss of every step
    and the checkpoint written (or None)."""
    from vision3d_tpu_torch.eval_cli import add_data_args, with_data_overrides

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="reference-format YAML")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    add_data_args(ap)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--metrics-jsonl", default="./metrics.jsonl")
    ap.add_argument("--workers", type=int, default=6,
                    help="data-loader worker processes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", default="second",
                    choices=["second", "pvrcnn", "pvrcnn2"])
    ap.add_argument("--dense-from", type=int, default=None,
                    help="cfg.train_dense_from_stage override: the stages from "
                         "this one on train as dense conv3d volumes; the "
                         "default 4 trains every stage sparse. Checkpoints "
                         "evaluate at any setting")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from vision3d_tpu_torch.config import Config
    from vision3d_tpu_torch.parallel import mesh

    cfg = Config.from_yaml(args.config) if args.config else Config()
    overrides = {k: v for k, v in (("epochs", args.epochs),
                                   ("batch_size", args.batch_size),
                                   ("ckpt_dir", args.ckpt_dir)) if v}
    if overrides:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **overrides))
    cfg = with_data_overrides(cfg, args)
    if args.dense_from is not None:
        cfg = cfg.replace(train_dense_from_stage=args.dense_from)
    joined = mesh.initialize_distributed(args.device)
    device = mesh.local_device(args.device)
    if not joined and device.type == "cuda" and args.device == "cuda":
        world = mesh.devices_for(cfg.train.batch_size, torch.cuda.device_count())
        if world > 1:
            print(f"train_cli: one process on each of {world} of "
                  f"{torch.cuda.device_count()} cards (batch {cfg.train.batch_size})",
                  flush=True)
            return mesh.launch(main, world, argv if argv is not None else sys.argv[1:])
    try:
        return _train(args, cfg, device)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(args, cfg, device):
    """The training loop of this process (a rank of a group, or alone)."""
    import torch

    from vision3d_tpu_torch.data.kitti import KittiDatasetTrain
    from vision3d_tpu_torch.data.loader import DataLoader
    from vision3d_tpu_torch.parallel import mesh
    from vision3d_tpu_torch.training.checkpoint import maybe_resume, save_checkpoint
    from vision3d_tpu_torch.training.metrics import JsonlWriter, MetricLogger, StdoutWriter
    from vision3d_tpu_torch.training.train import (create_pvrcnn_train_state,
                                                   create_train_state,
                                                   make_pvrcnn_train_step,
                                                   make_train_step)

    world, rank = mesh.world_size(), mesh.rank()
    lead = rank == 0
    with mesh.rank0_first():      # rank 0 writes the annotation caches
        dataset = KittiDatasetTrain(cfg, verbose=lead, rng=np.random.default_rng(args.seed))
    loader = DataLoader(dataset, cfg, seed=args.seed,
                        batch_size=mesh.local_batch(cfg.train.batch_size),
                        num_workers=args.workers, num_shards=world, shard_id=rank)
    steps_per_epoch = len(loader)
    generator = torch.Generator().manual_seed(args.seed)
    if args.model == "second":
        model, tx, state = create_train_state(cfg, generator, steps_per_epoch, device)
        step_fn = make_train_step(model, tx, cfg)
    else:
        two_stage = args.model == "pvrcnn2"
        model, tx, state = create_pvrcnn_train_state(
            cfg, generator, steps_per_epoch, device, two_stage=two_stage)
        step_fn = make_pvrcnn_train_step(model, tx, cfg, train_stage2=two_stage,
                                         seed=args.seed)
    start_epoch = 0
    if args.resume:
        state, start_epoch = maybe_resume(cfg.train.ckpt_dir, state)
    logger = (MetricLogger(writers=[StdoutWriter(), JsonlWriter(args.metrics_jsonl)])
              if lead else None)

    records = []
    try:
        for epoch in range(start_epoch, cfg.train.epochs):
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            t_epoch = time.perf_counter()
            t_host = 0.0
            losses_seen = []
            t0 = time.perf_counter()
            for batch in loader:
                t_host += time.perf_counter() - t0
                batch.pop("frame_idx", None)
                batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
                state, losses = step_fn(state, batch)
                losses = {k: float(v) for k, v in losses.items()}
                losses_seen.append(losses["loss"])
                if logger:
                    logger.update(state.step, losses)
                t0 = time.perf_counter()
            peak = None
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                peak = torch.cuda.max_memory_allocated(device)
            dt = time.perf_counter() - t_epoch
            n_frames = steps_per_epoch * cfg.train.batch_size     # the global batch's
            if lead:
                print(f"epoch {epoch}: {dt:.1f}s ({n_frames / dt:.1f} frames/s; "
                      f"host wait {t_host:.1f}s = {t_host / dt:.0%})"
                      + (f"; peak memory {peak / 2**30:.2f} GiB" if peak else "")
                      + (f"; {world} processes" if world > 1 else ""), flush=True)
            path = None
            # save after every ckpt_interval_epochs-th epoch and the last one
            if lead and ((epoch + 1) % cfg.train.ckpt_interval_epochs == 0
                         or epoch == cfg.train.epochs - 1):
                path = save_checkpoint(cfg.train.ckpt_dir, state, epoch)
                print(f"saved {path}")
            records.append(dict(epoch=epoch, steps=len(losses_seen), seconds=dt,
                                frames_per_s=n_frames / dt, host_wait_s=t_host,
                                peak_mem_bytes=peak, losses=losses_seen, checkpoint=path))
    finally:
        loader.close()
    return records


if __name__ == "__main__":
    main()
