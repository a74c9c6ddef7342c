"""SECOND / PV-RCNN inference benchmark of the PyTorch port (counterpart of
the repository's ``bench.py``).

    python -m vision3d_tpu_torch.bench [--model second|pvrcnn|pvrcnn2]
        [--backend voxel|column] [--dense-from N] [--quick] [--device cpu]

Prints ONE JSON line with ``bench.py``'s keys and metric name
(``second_inference_frames_per_sec_per_chip`` or
``{model}_inference_frames_per_sec_per_chip``), less ``vs_baseline`` (a
TPU target), plus ``peak_mem_gib``. The workload is ``bench.py``'s: the
full single-graph pipeline (voxelize -> sparse CNN -> RPN -> head decode ->
rotated NMS; ``pvrcnn2`` adds the point branch, RoI grid pooling and
refinement) at the default ``Config()`` geometry with one class (car) and
``--dtype`` compute, a fresh seeded init (``init_second`` /
``init_pvrcnn`` from a CPU generator seeded 0, batch norms at their
constructors' statistics), on the seed-0 ``kitti_like_points`` clouds cut
or padded to ``--points``. ``--quick`` shrinks the geometry and forces
batch 2, 6000 points and 5 iterations, as ``bench.py`` does.

Timing. One repetition is ``--iters`` forwards enqueued back to back on one
stream, then a read-back of their checksum (which synchronises), on the
host clock. Eager PyTorch does no common-subexpression elimination and one
stream serialises the batches, so the forwards need no perturbation; a
forward that synchronises inside (the NMS fixpoint reads a flag each
round) serialises host and device within the chain. ``host_roundtrip_ms``
is one trivial op and its synchronise, subtracted once per chain. The
headline is the p50 over ``--warmup`` timed repetitions. ``compile_s`` is
the seconds of the first chain, which includes building the CUDA kernels
(``kernels.build``) where no built library is cached yet. The capacity
counters (``stage_dropped``, every ``*dropped`` counter but the
voxelizer's, sorted by name; ``voxelizer_dropped_reference_semantics``)
come from one forward outside the timed chains. A chain whose checksum is
not finite raises.

Runs on ``cuda`` unless ``--device cpu``; without a card it exits non-zero
(no fallback to the CPU). With several visible cards it runs one process
per card (``parallel/mesh.launch``), each on its own ``--batch`` slice of
the seed-0 global batch; the ranks meet at a barrier before each
repetition, a repetition's time is the slowest rank's, and rank 0 prints
the line with ``n_devices`` and ``aggregate_frames_per_sec``. Under the
coordinator variables (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
``PROCESS_ID``) this process is that rank (NCCL on the card, gloo on the
CPU).
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.core.anchors import make_anchors
from vision3d_tpu_torch.parallel import mesh
from vision3d_tpu_torch.synthetic import kitti_like_batch

QUICK = dict(max_voxels=4096, voxel_size=(0.1, 0.1, 0.1),
             grid_bounds=(0.0, -19.2, -3.0, 38.4, 19.2, 1.0))


def bench_config(dtype="bfloat16", backend=None, dense_from=None, quick=False,
                 **overrides):
    """``Config()`` with one class, ``dtype`` compute and the flags'
    overrides (``bench.py:100-116``); ``overrides`` are further fields
    (``bench_train`` sets ``train_dense_from_stage``)."""
    cfg = Config()
    cfg = cfg.replace(num_classes=1, anchors=cfg.anchors[:1], compute_dtype=dtype,
                      **overrides)
    if backend:
        cfg = cfg.replace(sparse_backend=backend)
    if dense_from is not None:
        cfg = cfg.replace(dense_from_stage=dense_from)
    if quick:
        cfg = cfg.replace(**QUICK)
    return cfg


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"
    return out.strip().splitlines()[0]


def roundtrip_s(dev: torch.device) -> float:
    """Seconds of one trivial op and its synchronise (after one warm-up)."""
    one = torch.ones((), device=dev)
    for _ in range(2):
        t0 = time.perf_counter()
        torch.add(one, 1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    return dt


def max_over_ranks(values, dev):
    """Each entry of ``values`` (floats) maximised over the ranks; the
    values themselves without a process group."""
    if not dist.is_initialized():
        return list(values)
    t = torch.tensor(values, dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def _forward(cfg, name: str, dev):
    """``forward(points, num) -> (Detections, diag)`` of a fresh seeded
    model ``name`` in eval mode on ``dev``."""
    generator = torch.Generator().manual_seed(0)
    if name == "second":
        from vision3d_tpu_torch.models.second import Second, init_second

        model = init_second(Second(cfg), generator)
    else:
        from vision3d_tpu_torch.models.pvrcnn import PV_RCNN, init_pvrcnn

        model = init_pvrcnn(PV_RCNN(cfg, two_stage=name == "pvrcnn2"), generator)
    model = model.to(dev).eval()
    anchors = torch.as_tensor(make_anchors(cfg), device=dev)
    if name == "pvrcnn2":
        def forward(points, num):
            return model.inference_two_stage(
                points, num, anchors, generator=torch.Generator().manual_seed(0))
    else:
        def forward(points, num):
            return model.inference(points, num, anchors)
    return forward


def run(cfg, model: str = "second", batch: int = 8, points: int = 18000,
        iters: int = 20, warmup: int = 5, device: str = "cuda") -> dict:
    """The benchmark on this process's card (or the CPU), as a rank of the
    process group if one is joined. Returns the JSON line's record."""
    dev = mesh.local_device(device)
    ndev, rank = mesh.world_size(), mesh.rank()
    total_batch = batch * ndev
    pts, num = kitti_like_batch(0, total_batch, points)
    rows = slice(rank * batch, (rank + 1) * batch)
    pts = torch.from_numpy(pts[rows]).to(dev)
    num = torch.from_numpy(num[rows]).to(dev)
    if dev.type == "cuda":      # after the first allocation has set the card up
        torch.cuda.reset_peak_memory_stats(dev)
    forward = _forward(cfg, model, dev)

    with torch.no_grad():
        _, diag = forward(pts, num)
        flat = {k: int(v) for k, v in mesh.sum_over_ranks(diag).items()}
    stage_dropped = [v for k, v in sorted(flat.items())
                     if "dropped" in k and "voxelizer" not in k]
    vox_dropped = sum(v for k, v in flat.items() if "voxelizer" in k)

    def chain():
        total = torch.zeros((), device=dev)
        with torch.no_grad():
            for _ in range(iters):
                det, _ = forward(pts, num)
                total = total + det.scores.float().sum() + det.boxes.float().sum() * 1e-6
        s = float(total)
        if not np.isfinite(s):
            raise RuntimeError(f"non-finite detections: checksum {s}")

    if dist.is_initialized():
        dist.barrier()
    t0 = time.perf_counter()
    chain()
    compile_s = time.perf_counter() - t0
    rt = roundtrip_s(dev)
    reps = []
    for _ in range(warmup):
        if dist.is_initialized():
            dist.barrier()
        t0 = time.perf_counter()
        chain()
        reps.append(time.perf_counter() - t0)
    per_iter = [max(r - rt, 1e-9) / iters for r in reps]
    *per_iter, compile_s, rt = max_over_ranks(per_iter + [compile_s, rt], dev)
    best, p50 = min(per_iter), float(np.median(per_iter))
    fps_aggregate = total_batch / p50
    fps = fps_aggregate / ndev
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None)
    return {
        "metric": f"{model}_inference_frames_per_sec_per_chip",
        "value": round(float(fps), 2),
        "unit": "frames/s",
        "n_devices": ndev,
        "aggregate_frames_per_sec": round(float(fps_aggregate), 2),
        "batch_latency_ms_p50": round(p50 * 1e3, 3),
        "batch_latency_ms_best": round(best * 1e3, 3),
        "host_roundtrip_ms": round(rt * 1e3, 3),
        "latency_method": "eager forwards chained on one stream, host clock to a "
                          "read-back, one round trip subtracted per chain",
        "batch": batch,
        "points_per_frame": points,
        "compile_s": round(compile_s, 1),
        "device": device_name(dev),
        "dtype": cfg.compute_dtype,
        "stage_capacities": [
            cfg.stage_column_capacity(i) if cfg.sparse_backend == "column"
            else cfg.stage_voxel_capacity(i) for i in range(5)],
        "sparse_backend": cfg.sparse_backend,
        "dense_from_stage": cfg.dense_from_stage,
        "stage_dropped": stage_dropped,
        "voxelizer_dropped_reference_semantics": vox_dropped,
        "peak_mem_gib": None if peak is None else round(peak, 3),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--points", type=int, default=18000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=5,
                    help="timed repetitions; headline is the p50")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--backend", default=None,
                    help="sparse backend override: voxel | column")
    ap.add_argument("--dense-from", type=int, default=None,
                    help="override cfg.dense_from_stage (2=default, 3=run "
                         "stage 2 sparse)")
    ap.add_argument("--model", default="second",
                    choices=["second", "pvrcnn", "pvrcnn2"],
                    help="pvrcnn = stage-1 proposal path; pvrcnn2 = full "
                         "two-stage (RoI grid pool + refinement)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.quick:
        args.batch, args.points, args.iters = 2, 6000, 5
    return args


def require_device(device: str):
    """Exit non-zero where ``device`` names a card and none is visible."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{sys.argv[0]}: no CUDA device; pass --device cpu to "
                         "run on the CPU")


def main(argv=None):
    """Parse ``argv``, run, print the JSON line on rank 0 and return its
    record (None on the other ranks)."""
    args = parse_args(argv)
    require_device(args.device)
    joined = mesh.initialize_distributed(args.device)
    if not joined and args.device == "cuda" and torch.cuda.device_count() > 1:
        return mesh.launch(main, torch.cuda.device_count(),
                           argv if argv is not None else sys.argv[1:])
    cfg = bench_config(args.dtype, args.backend, args.dense_from, args.quick)
    lead = mesh.rank() == 0
    try:
        record = run(cfg, args.model, args.batch, args.points, args.iters,
                     args.warmup, args.device)
    finally:
        if joined:
            torch.distributed.destroy_process_group()
    if not lead:
        return None
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
