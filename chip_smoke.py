"""GPU smoke test of the PyTorch port: builds the CUDA kernels, holds each
against its plain PyTorch version at the shapes SECOND inference gives it,
and runs full-geometry 3-class SECOND inference (configs/second/all_classes.yaml,
trained weights, bf16, batch 8 x 18,000 points) end to end.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, printing no result).
Phases, each printing lines before the last:
  1. build every kernel from csrc/ (one nvcc each, in parallel);
  2. each kernel vs its plain version at the main path's shapes, bf16
     (atol 2e-2 * max|ref|, rtol 2e-2) and float32 (1e-4 of the scale),
     with CUDA-event medians of kernel and plain times;
  3. Second.inference end to end at torch's default precision settings:
     launch counts of the run, capacity counters all 0, finite outputs,
     p50 batch latency, peak memory;
  4. a small-geometry reference check: the same model on the card and on
     the CPU (plain versions), float32 with TF32 off, same detections.
The last line is {"ok": true, "device": {...}}; the one before it lists
the kernels as JSON, and the one before that is the card's name and
power limit from nvidia-smi.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vision3d_tpu_torch import convert, kernels
from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.models.second import create_second
from vision3d_tpu_torch.ops import sparse as sp
from vision3d_tpu_torch.ops import zwin_conv as zw
from vision3d_tpu_torch.synthetic import kitti_like_batch
from vision3d_tpu_torch.core.voxelize import mean_vfe, voxelize_batch
from vision3d_tpu_torch.models.sparse_cnn import from_voxels

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "second" / "all_classes.yaml"
WEIGHTS = ROOT / "vision3d_tpu_torch" / "weights" / "second_all_classes_epoch11.npz"
BATCH, POINTS = 8, 18000
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet peaks
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12        # outside the tensor cores


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps=15, warmup=3):
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def path_layers(cfg, points, num):
    """The z-window convs of the main path with their real rulebooks:
    [(name, launches per forward, C, Cout, N, start, pattern)]."""
    with torch.no_grad():
        vox = voxelize_batch(points, num, cfg)
        st = from_voxels(mean_vfe(vox["features"], vox["occupancy"]),
                         vox["coords"], vox["voxel_mask"], cfg.grid_shape_zyx)
        k3, s2, p1 = (3, 3, 3), (2, 2, 2), (1, 1, 1)
        rbs0, rbd0, k1, m1, _ = sp.plan_stage_batched(
            st.keys, st.mask, st.grid, k3, s2, p1, cfg.stage_voxel_capacity(1),
            subm_kernel=k3)
        g1 = sp.out_grid_shape(st.grid, k3, s2, p1)
        rbs1, rbd1, _, _, _ = sp.plan_stage_batched(
            k1, m1, g1, k3, s2, p1, cfg.stage_voxel_capacity(2), subm_kernel=k3)
    n0, n1 = st.keys.shape[1], k1.shape[1]
    return [("s0_subm_4x16", 1, 4, 16, n0, *rbs0),
            ("s0_subm_16x16", 1, 16, 16, n0, *rbs0),
            ("s0_down_16x32", 1, 16, 32, n0, *rbd0),
            ("s1_subm_32x32", 2, 32, 32, n1, *rbs1),
            ("s1_down_32x64", 1, 32, 64, n1, *rbd1)]


def zwin_bound_ms(b, n, c, cout, start, pattern, dtype):
    """Least time for the work: each input read once, the output written
    once, and 2*C*Cout flops per active tap of this rulebook."""
    rows = sp.zwin_taps(start, pattern, n)
    taps = int((rows >= 0).sum())
    esize = torch.finfo(dtype).bits // 8
    nbytes = (b * n * c * esize + 2 * start.numel() * 4 + 27 * c * cout * esize
              + b * (start.shape[1] // 9) * cout * 4)
    flops = 2 * c * cout * taps
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), taps


def kernel_phase(cfg, points, num, dev):
    """Phase 2: B1 against its plain version at every path shape."""
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = []
    for name, count, c, cout, n, start, pattern in path_layers(cfg, points, num):
        b = start.shape[0]
        feats = torch.randn((b, n, c), generator=gen, device=dev)
        w = torch.randn((27 * c, cout), generator=gen, device=dev) / (27 * c) ** 0.5
        row = {"shape": name, "launches_per_forward": count, "B": b, "N": n,
               "M": start.shape[1] // 9, "C": c, "Cout": cout}
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            got = zw.zwin_conv(feats, start, pattern, w, (3, 3, 3), dtype)
            torch.cuda.synchronize()
            ref = sp.conv_zwin_apply(feats, start, pattern, w, (3, 3, 3), dtype)
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            check(torch.isfinite(got).all().item(), f"{name} {tag}: non-finite")
            ok = bool(((got - ref).abs() <= tol * scale + tol * ref.abs()).all())
            check(ok, f"{name} {tag}: kernel disagrees with plain version "
                      f"(max abs err {err}, scale {scale})")
            ms = cuda_ms(lambda: zw.zwin_conv(feats, start, pattern, w, (3, 3, 3), dtype))
            plain = cuda_ms(lambda: sp.conv_zwin_apply(feats, start, pattern, w,
                                                       (3, 3, 3), dtype), reps=10)
            bound, by, taps = zwin_bound_ms(b, n, c, cout, start, pattern, dtype)
            row.update({f"{tag}_max_abs_err": err, f"{tag}_ref_scale": scale,
                        f"{tag}_ms": ms, f"{tag}_plain_ms": plain,
                        f"{tag}_bound_ms": bound, f"{tag}_bound_by": by,
                        "active_taps": taps})
        print(f"zwin_conv {name}: B={b} N={n} M={row['M']} taps={row['active_taps']} "
              f"bf16 {row['bf16_ms']:.4f} ms (plain {row['bf16_plain_ms']:.3f}, "
              f"bound {row['bf16_bound_ms']:.4f} {row['bf16_bound_by']}, "
              f"err {row['bf16_max_abs_err']:.3g}) | f32 {row['f32_ms']:.4f} ms "
              f"(plain {row['f32_plain_ms']:.3f}, err {row['f32_max_abs_err']:.3g})",
              flush=True)
        shapes.append(row)
    return shapes


def end_to_end_phase(model, anchors, points, num):
    """Phase 3: one counted forward, then timed ones."""
    zw.reset_launches()
    torch.cuda.synchronize()
    with torch.no_grad():
        det, diag = model.inference(points, num, anchors)
    torch.cuda.synchronize()
    launches = dict(zw.LAUNCHES)
    check(launches["zwin_conv"] == 6,
          f"zwin_conv launched {launches['zwin_conv']} times in one forward, not 6")
    counters = {k: int(v) for k, v in diag.items()}
    for k, v in counters.items():
        if k != "voxelizer_dropped":
            check(v == 0, f"capacity counter {k} = {v}")
    for name, t in det._asdict().items():
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()), f"non-finite {name}")
    k = model.cfg.num_classes * model.cfg.proposal.topk
    check(tuple(det.boxes.shape) == (points.shape[0], k, 7), "Detections shape")
    valid = det.valid.sum(dim=1).tolist()
    check(sum(valid) > 0, "no valid detection in the batch")

    torch.cuda.reset_peak_memory_stats()
    times = []
    with torch.no_grad():
        for i in range(13):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.inference(points, num, anchors)
            torch.cuda.synchronize()
            if i >= 3:
                times.append(1e3 * (time.perf_counter() - t0))
    return dict(launches=launches, counters=counters, valid_per_frame=valid,
                latency_ms_p50=float(np.median(times)),
                latency_ms=[float(t) for t in times],
                peak_mem_bytes=int(torch.cuda.max_memory_allocated()))


def reference_phase(sd, dev):
    """Phase 4: small geometry, float32, trained weights: card vs CPU.
    TF32 off, so the card's f32 convs and matmuls are full float32 like the
    CPU's (the end-to-end phase before this one runs at torch's defaults,
    where cuDNN may use TF32 for the f32 RPN convs)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config.from_yaml(str(CONFIG)).replace(
        max_voxels=2048, voxel_size=(0.2, 0.2, 0.1),
        grid_bounds=(0.0, -12.8, -3.0, 25.6, 12.8, 1.0))
    cfg = cfg.replace(capacity=cfg.capacity.__class__(max_points=4096))
    pts, num = kitti_like_batch(1, 2, 60000)
    lo, hi = np.asarray(cfg.grid_bounds[:3]), np.asarray(cfg.grid_bounds[3:])
    inside = ((pts[..., :3] >= lo) & (pts[..., :3] < hi)).all(-1)
    n = int(inside.sum(1).min())
    pts = np.stack([p[m][:n] for p, m in zip(pts, inside)])
    num = np.full((2,), n, np.int32)
    out = {}
    for d in (dev, torch.device("cpu")):
        model, anchors = create_second(cfg, device=d, state_dict=sd)
        with torch.no_grad():
            det, diag = model.inference(torch.from_numpy(pts).to(d),
                                        torch.from_numpy(num).to(d), anchors)
        out[d.type] = (det, {k: int(v) for k, v in diag.items()})
    (gd, gdiag), (cd, cdiag) = out["cuda"], out["cpu"]
    check(gdiag == cdiag, f"counters differ: card {gdiag} vs CPU {cdiag}")
    gv, cv = gd.valid.cpu(), cd.valid
    check(torch.equal(gv, cv), "valid detections differ between card and CPU")
    check(int(cv.sum()) > 0, "no detections in the reference check")
    box = float((gd.boxes.cpu() - cd.boxes)[cv].abs().max())
    score = float((gd.scores.cpu() - cd.scores)[cv].abs().max())
    # the AP cross-check yardstick (AP_r05_crosscheck.json)
    check(box <= 0.0077 and score <= 0.0008, f"box delta {box}, score delta {score}")
    return dict(points=n, detections=int(cv.sum()), box_delta=box,
                score_delta=score, counters=cdiag)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    logs = kernels.build(kernels.KERNELS)
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s for {', '.join(kernels.KERNELS)}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    cfg = Config.from_yaml(str(CONFIG)).replace(compute_dtype="bfloat16")
    pts, num = kitti_like_batch(0, BATCH, POINTS)
    points = torch.from_numpy(pts).to(dev)
    num_t = torch.from_numpy(num).to(dev)
    sd = convert.state_dict_from_flax(convert.load_npz(WEIGHTS))
    model, anchors = create_second(cfg, device=dev, state_dict=sd)

    shapes = kernel_phase(cfg, points, num_t, dev)
    e2e = end_to_end_phase(model, anchors, points, num_t)
    print(f"e2e: batch {BATCH} x {POINTS} points, p50 {e2e['latency_ms_p50']:.2f} ms, "
          f"peak mem {e2e['peak_mem_bytes'] / 2**30:.2f} GiB, "
          f"valid detections per frame {e2e['valid_per_frame']}, "
          f"counters {e2e['counters']}, launches {e2e['launches']}", flush=True)
    ref = reference_phase(sd, dev)
    print(f"reference check (card vs CPU, f32, small geometry): {ref}", flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    per = lambda key: sum(s[key] * s["launches_per_forward"] for s in shapes)  # noqa: E731
    entry = {"name": "zwin_conv", "route": "cuda",
             "source": "vision3d_tpu_torch/csrc/zwin_conv.cu",
             "replaces": "vision3d_tpu/ops/pallas/zwin_conv.py:114",
             "launches": e2e["launches"]["zwin_conv"],
             "max_abs_err": max(s["bf16_max_abs_err"] for s in shapes),
             "ms": per("bf16_ms"), "plain_ms": per("bf16_plain_ms"),
             "bound_ms": per("bf16_bound_ms"),
             "bound_by": ("bytes" if all(s["bf16_bound_by"] == "bytes" for s in shapes)
                          else "operations"),
             # no single PyTorch call computes a z-window conv
             "library_ms": None,
             "shapes": [{k: s[k] for k in ("shape", "launches_per_forward", "M",
                                           "bf16_ms", "bf16_plain_ms", "bf16_bound_ms")}
                        for s in shapes]}
    print(smi)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
