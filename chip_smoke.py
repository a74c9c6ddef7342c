"""GPU smoke test of the PyTorch port: builds the CUDA kernels, holds each
against its plain PyTorch version at the shapes SECOND gives it, runs
full-geometry 3-class SECOND inference (configs/second/all_classes.yaml,
trained weights, bf16, batch 8 x 18,000 points) end to end, and takes
training steps of the same model from a fresh seeded init.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, printing no result).
Phases, each printing lines before the last:
  1. build every kernel from csrc/ (one nvcc each, in parallel);
  2. each kernel vs its plain version at the main path's shapes, bf16
     (atol 2e-2 * max|ref|, rtol 2e-2) and float32 (1e-4 of the scale),
     with CUDA-event medians of kernel and plain times;
  2b. the training path's kernels, gather_gemm (every sparse conv, forward
     and dX) and gather_rows (the dW regather), against their plain
     versions at every shape a training step gives them, on the real
     rulebooks of the batch; gather_rows also beside torch.index_select;
  3. Second.inference end to end at torch's default precision settings:
     launch counts of the run, capacity counters all 0, finite outputs,
     p50 batch latency, peak memory;
  4. a small-geometry reference check: the same model on the card and on
     the CPU (plain versions), float32 with TF32 off, same detections;
  5. training at full geometry, bf16: train steps on one synthetic batch
     from a fresh seeded init: launch counts of a step, capacity counters 0,
     finite loss / gradients / parameters, loss decreasing, p50 step time,
     peak memory;
  6. a small-geometry training reference: one loss.backward() on the card
     (kernels) and on the CPU (plain versions), float32 with TF32 off:
     loss to 1e-5 relative, every gradient to 1e-4 of its tensor's max.
The last line is {"ok": true, "device": {...}}; the one before it lists
the kernels as JSON, and the one before that is the card's name and
power limit from nvidia-smi.
"""

import contextlib
import gc
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
from vision3d_tpu_torch.core.anchors import make_anchors
from vision3d_tpu_torch.core.targets import assign_targets_batch
from vision3d_tpu_torch.core.voxelize import mean_vfe, voxelize_batch
from vision3d_tpu_torch.models.losses import proposal_loss
from vision3d_tpu_torch.models.sparse_cnn import SpMiddleFHD, from_voxels
from vision3d_tpu_torch.ops import sparse as sp
from vision3d_tpu_torch.ops import zwin_conv as zw
from vision3d_tpu_torch.ops.gather_gemm import gather_gemm
from vision3d_tpu_torch.ops.gather_rows import gather_rows, gather_rows_plain
from vision3d_tpu_torch.synthetic import kitti_like_batch, kitti_like_train_batch
from vision3d_tpu_torch.training.train import create_train_state, make_train_step

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "second" / "all_classes.yaml"
WEIGHTS = ROOT / "vision3d_tpu_torch" / "weights" / "second_all_classes_epoch11.npz"
BATCH, POINTS = 8, 18000
STEPS_PER_EPOCH = 928         # 3712 KITTI train frames / 4, as bench_train.py
TRAIN_WARMUP, TRAIN_TIMED = 3, 6
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet peaks
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12        # outside the tensor cores


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def full_float32():
    """TF32 off for matmuls and cuDNN convs, so the card's float32 is the
    CPU's; torch's settings are put back on exit (the end-to-end phases run
    at torch's defaults, where cuDNN may use TF32 for the f32 RPN convs)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


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


def _sorted_input(cfg, points, num):
    vox = voxelize_batch(points, num, cfg)
    return from_voxels(mean_vfe(vox["features"], vox["occupancy"]),
                       vox["coords"], vox["voxel_mask"], cfg.grid_shape_zyx)


def path_layers(cfg, points, num):
    """The z-window convs of the main path with their real rulebooks:
    [(name, launches per forward, C, Cout, N, start, pattern)]."""
    with torch.no_grad():
        st = _sorted_input(cfg, points, num)
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


def small_geometry_cfg():
    """The small geometry of the card-vs-CPU checks (phases 4 and 6): a
    25.6 m x 25.6 m x 4 m crop at 0.2 m voxels, 2048 voxels."""
    cfg = Config.from_yaml(str(CONFIG)).replace(
        max_voxels=2048, voxel_size=(0.2, 0.2, 0.1),
        grid_bounds=(0.0, -12.8, -3.0, 25.6, 12.8, 1.0))
    return cfg.replace(capacity=cfg.capacity.__class__(max_points=4096))


def crop_to_grid(cfg, pts):
    """The points of each cloud inside the grid's bounds, every cloud cut
    to the shortest: (points (B, n, 4), num_points (B,) int32)."""
    lo, hi = np.asarray(cfg.grid_bounds[:3]), np.asarray(cfg.grid_bounds[3:])
    inside = ((pts[..., :3] >= lo) & (pts[..., :3] < hi)).all(-1)
    n = int(inside.sum(1).min())
    return (np.stack([p[m][:n] for p, m in zip(pts, inside)]),
            np.full((len(pts),), n, np.int32))


def reference_phase(sd, dev):
    """Phase 4: small geometry, float32, trained weights: card vs CPU.
    Called under ``full_float32()``: the card's f32 convs and matmuls are
    full float32 like the CPU's."""
    cfg = small_geometry_cfg()
    pts, num = crop_to_grid(cfg, kitti_like_batch(1, 2, 60000)[0])
    n = int(num[0])
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


def train_path_layers(cfg, points, num):
    """The sparse convs of one training step with their real full-tap
    rulebooks. Returns (convs, regathers):
    convs [(name, gather_gemm launches per step, N, C, Cout, K, rb)], the
    forward of each conv and the dX of all but the first (a submanifold
    conv's dX has its forward's shape and rulebook; a strided conv's runs
    Cout -> C over the transpose rulebook);
    regathers [(name, gather_rows launches per step, N, C, rb)], one per
    conv's dW."""
    convs, regathers = [], []
    with torch.no_grad():
        st = _sorted_input(cfg, points, num)
        keys, mask, grid = st.keys, st.mask, st.grid
        cin = cfg.c_in
        needs_dx = False   # the first conv's input (VFE means) needs no dX
        for si, (chans, spec) in enumerate(SpMiddleFHD(cfg).block_specs()):
            rbs, rbd, rbt, ok, om, _ = sp.plan_stage_train_batched(
                keys, mask, grid, spec["kernel"], spec["stride"], spec["pad"],
                spec["out_cap"], subm_kernel=(3, 3, 3))
            n, m = keys.shape[1], ok.shape[1]
            kd = spec["kernel"][0] * spec["kernel"][1] * spec["kernel"][2]
            widths = {}   # (cin, cout) -> [gather_gemm launches, regathers]
            for ch in chans:
                entry = widths.setdefault((cin, ch), [0, 0])
                entry[0] += 2 if needs_dx else 1
                entry[1] += 1
                cin, needs_dx = ch, True
            for (ci, co), (launches, gathers) in widths.items():
                convs.append((f"s{si}_subm_{ci}x{co}", launches, n, ci, co, 27, rbs))
                regathers.append((f"s{si}_subm_c{ci}", gathers, n, ci, rbs))
            cout = spec["features"]
            convs.append((f"s{si}_down_{cin}x{cout}_k{kd}", 1, n, cin, cout, kd, rbd))
            convs.append((f"s{si}_downT_{cout}x{cin}_k{kd}", 1, m, cout, cin, kd, rbt))
            regathers.append((f"s{si}_down_c{cin}_k{kd}", 1, n, cin, rbd))
            keys, mask, cin = ok, om, cout
            grid = sp.out_grid_shape(grid, spec["kernel"], spec["stride"], spec["pad"])
    return convs, regathers


def _bound(nbytes, flops, dtype):
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def train_kernel_phase(cfg, points, num, dev):
    """Phase 2b: B2 and B4/B5 against their plain versions at every shape
    of a training step. Returns (gather_gemm rows, gather_rows rows)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    convs, regathers = train_path_layers(cfg, points, num)
    gg_rows, gr_rows = [], []
    for name, count, n, c, cout, kd, rb in convs:
        b = rb.shape[0]
        m = rb.shape[1] // kd
        feats = torch.randn((b, n, c), generator=gen, device=dev)
        w = torch.randn((kd * c, cout), generator=gen, device=dev) / (kd * c) ** 0.5
        hits = int((rb < n).sum())
        row = {"shape": name, "launches_per_step": count, "B": b, "N": n, "M": m,
               "C": c, "Cout": cout, "K": kd, "hits": hits}
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            got = gather_gemm(feats, rb, w, dtype)
            torch.cuda.synchronize()
            ref = sp.conv_rulebook_apply(feats, rb, w, dtype)
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            check(torch.isfinite(got).all().item(), f"gather_gemm {name} {tag}: non-finite")
            check(scale > 0, f"gather_gemm {name} {tag}: the plain version is all zero")
            ok = bool(((got - ref).abs() <= tol * scale + tol * ref.abs()).all())
            check(ok, f"gather_gemm {name} {tag}: kernel disagrees with plain "
                      f"version (max abs err {err}, scale {scale})")
            del got, ref
            ms = cuda_ms(lambda: gather_gemm(feats, rb, w, dtype), reps=10)
            plain = cuda_ms(lambda: sp.conv_rulebook_apply(feats, rb, w, dtype),
                            reps=5, warmup=1)
            esize = torch.finfo(dtype).bits // 8
            nbytes = (b * n * c * esize + rb.numel() * 4 + kd * c * cout * esize
                      + b * m * cout * 4)
            bound, by = _bound(nbytes, 2 * c * cout * hits, dtype)
            row.update({f"{tag}_max_abs_err": err, f"{tag}_ref_scale": scale,
                        f"{tag}_ms": ms, f"{tag}_plain_ms": plain,
                        f"{tag}_bound_ms": bound, f"{tag}_bound_by": by})
        print(f"gather_gemm {name} x{count}: B={b} N={n} M={m} K={kd} hits={hits} "
              f"bf16 {row['bf16_ms']:.4f} ms (plain {row['bf16_plain_ms']:.3f}, "
              f"bound {row['bf16_bound_ms']:.4f} {row['bf16_bound_by']}, "
              f"err {row['bf16_max_abs_err']:.3g}) | f32 {row['f32_ms']:.4f} ms "
              f"(plain {row['f32_plain_ms']:.3f}, err {row['f32_max_abs_err']:.3g})",
              flush=True)
        gg_rows.append(row)
    for name, count, n, c, rb in regathers:
        b = rb.shape[0]
        feats = torch.randn((b, n, c), generator=gen, device=dev)
        row = {"shape": name, "launches_per_step": count, "R": b * (n + 1),
               "Q": rb.numel(), "C": c}
        for dtype in (torch.bfloat16, torch.float32):
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            table, idx = sp.zero_row_table(feats, rb, dtype)
            got = gather_rows(table, idx)
            torch.cuda.synchronize()
            check(torch.equal(got, gather_rows_plain(table, idx)),
                  f"gather_rows {name} {tag}: kernel differs from plain version")
            del got
            ms = cuda_ms(lambda: gather_rows(table, idx), reps=10)
            plain = cuda_ms(lambda: gather_rows_plain(table, idx), reps=5, warmup=1)
            lib = cuda_ms(lambda: torch.index_select(table, 0, idx), reps=10)
            esize = table.element_size()
            nbytes = table.numel() * esize + idx.numel() * 4 + idx.numel() * c * esize
            bound, by = _bound(nbytes, 0, dtype)
            row.update({f"{tag}_ms": ms, f"{tag}_plain_ms": plain,
                        f"{tag}_library_ms": lib, f"{tag}_bound_ms": bound,
                        f"{tag}_bound_by": by, f"{tag}_max_abs_err": 0.0})
            del table, idx
        print(f"gather_rows {name} x{count}: R={row['R']} Q={row['Q']} C={c} "
              f"bf16 {row['bf16_ms']:.4f} ms (plain {row['bf16_plain_ms']:.3f}, "
              f"index_select {row['bf16_library_ms']:.4f}, bound "
              f"{row['bf16_bound_ms']:.4f}) | f32 {row['f32_ms']:.4f} ms (plain "
              f"{row['f32_plain_ms']:.3f}, index_select {row['f32_library_ms']:.4f}), "
              f"equal", flush=True)
        gr_rows.append(row)
    return gg_rows, gr_rows


def _to_device(batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def training_phase(cfg, dev, expected):
    """Phase 5: train steps at full geometry from a fresh seeded init."""
    batch = _to_device(kitti_like_train_batch(0, BATCH, POINTS, cfg=cfg), dev)
    model, tx, state = create_train_state(
        cfg, torch.Generator().manual_seed(0), steps_per_epoch=STEPS_PER_EPOCH,
        device=dev)
    step = make_train_step(model, tx, cfg)

    zw.reset_launches()
    torch.cuda.synchronize()
    state, out = step(state, batch)
    torch.cuda.synchronize()
    launches = dict(zw.LAUNCHES)
    for name, want in expected.items():
        check(launches[name] == want,
              f"{name} launched {launches[name]} times in one training step, not {want}")
    losses = [float(out["loss"])]
    counters = {k: int(v) for k, v in state.diagnostics.items()}

    times = []
    for i in range(1, TRAIN_WARMUP + TRAIN_TIMED):
        if i == TRAIN_WARMUP:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = step(state, batch)
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(out["loss"]))
        for k, v in state.diagnostics.items():
            counters[k] = max(counters[k], int(v))
    peak = int(torch.cuda.max_memory_allocated())
    for k in ("stage1_dropped", "stage2_dropped", "stage3_dropped", "stage4_dropped"):
        check(counters[k] == 0, f"capacity counter {k} = {counters[k]}")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    for name, p in model.named_parameters():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              f"missing or non-finite gradient of {name}")
        check(bool(torch.isfinite(p).all()), f"non-finite parameter {name}")
    for name, buf in model.named_buffers():
        check(bool(torch.isfinite(buf.float()).all()), f"non-finite buffer {name}")
    check(losses[-1] < losses[0], f"loss did not decrease: {losses}")
    check(state.step == TRAIN_WARMUP + TRAIN_TIMED, "step counter")
    return dict(launches=launches, counters=counters, losses=losses,
                step_ms_p50=float(np.median(times)),
                step_ms=[float(t) for t in times], peak_mem_bytes=peak)


class _GatedRelu(torch.autograd.Function):
    """relu(x) whose backward passes the gradient where ``gate`` is set."""

    @staticmethod
    def forward(ctx, x, gate):
        ctx.save_for_backward(gate)
        return x.clamp(min=0)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.saved_tensors[0], None


@contextlib.contextmanager
def relu_gates(gates, replay):
    """Every ReLU of the model (all go through ``torch.nn.functional.relu``)
    with an explicit gate, in call order: recorded into ``gates`` as
    ``x > 0``, which is relu's own gate, or, with ``replay``, taken from
    ``gates``. Yields a list that collects, per ReLU, how many of its own
    gates differ from the replayed ones."""
    orig, differ, calls = torch.nn.functional.relu, [], iter(list(gates))

    def relu(x, inplace=False):
        own = x > 0
        if replay:
            gate = next(calls).to(x.device)
            differ.append(int((own != gate).sum()))
        else:
            gate = own
            gates.append(own.cpu())
        return _GatedRelu.apply(x, gate)

    torch.nn.functional.relu = relu
    try:
        yield differ
    finally:
        torch.nn.functional.relu = orig


def training_reference_phase(dev):
    """Phase 6: small geometry, float32, TF32 off: loss and gradients of one
    step's forward + backward on the card (kernels) against the CPU (plain
    versions), same weights and batch: loss to 1e-5 relative, every
    gradient to 1e-4 of its tensor's max. The CPU's oneDNN convs are
    switched off too: their float32 backward is a reduced-accuracy
    algorithm.

    The CPU's backward uses the card's ReLU gates. A ReLU input within
    float32 noise of zero (a handful of the 7.5e6 here) can be positive on
    one device and not on the other; such a gate passes its whole upstream
    gradient on one side only, which moves the gradients of its layer and of
    every layer before it by ~1e-3 of their scale (measured against a
    float64 run, both devices are then equally far from it). That is a
    property of ReLU in float32, not of the kernels, so the gates are held
    equal, and the number that differ is counted and bounded (1e-5 of all
    gates). Called under ``full_float32()``."""
    cfg = small_geometry_cfg()
    b = kitti_like_train_batch(1, 2, 60000, max_gt=8, cfg=cfg)
    b["points"], b["num_points"] = crop_to_grid(cfg, b["points"])
    n = int(b["num_points"][0])
    b["boxes"][..., 0] = np.clip(b["boxes"][..., 0], 3.0, 22.0)
    b["boxes"][..., 1] = np.clip(b["boxes"][..., 1], -10.0, 10.0)
    model0, _, _ = create_train_state(cfg, torch.Generator().manual_seed(2), device="cpu")
    sd = model0.state_dict()
    runs, gates = [], []
    with torch.backends.mkldnn.flags(enabled=False):
        for d in (dev, torch.device("cpu")):
            model, _, _ = create_train_state(cfg, device=d, state_dict=sd)
            batch = _to_device(b, d)
            anchors = torch.as_tensor(make_anchors(cfg), device=d)
            with torch.no_grad():
                targets = assign_targets_batch(
                    batch["boxes"], batch["class_idx"], batch["gt_mask"],
                    batch["box_ignore"], anchors, cfg)
            zw.reset_launches()
            with relu_gates(gates, replay=bool(runs)) as differ:
                cls_map, reg_map, diag = model(batch["points"], batch["num_points"])
                loss = proposal_loss(cls_map, reg_map, targets, cfg)["loss"]
                loss.backward()
            runs.append((float(loss.detach()), {k: int(v) for k, v in diag.items()},
                         {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
                         int(targets.M_reg.sum()), dict(zw.LAUNCHES)))
    (gl, gdiag, ggrads, gpos, glaunch), (cl, cdiag, cgrads, cpos, claunch) = runs
    check(glaunch["gather_gemm"] == 27 and glaunch["gather_rows"] == 14,
          f"card launches {glaunch}")
    check(sum(claunch.values()) == 0, f"CPU run launched kernels: {claunch}")
    check(gdiag == cdiag, f"counters differ: card {gdiag} vs CPU {cdiag}")
    check(gpos == cpos and cpos > 0, f"positives: card {gpos}, CPU {cpos}")
    check(abs(gl - cl) <= 1e-5 * abs(cl), f"loss: card {gl} vs CPU {cl}")
    n_gates = sum(g.numel() for g in gates)
    check(len(differ) == len(gates) == 21, f"{len(gates)} ReLUs recorded, "
                                           f"{len(differ)} replayed, not 21")
    check(sum(differ) <= 1e-5 * n_gates, f"{sum(differ)} of {n_gates} ReLU gates differ")
    rels = {name: float((ggrads[name] - cg).abs().max())
            / max(float(cg.abs().max()), 1e-30) for name, cg in cgrads.items()}
    worst = max(rels, key=rels.get)
    check(rels[worst] <= 1e-4, f"gradient of {worst}: card vs CPU differ by "
                               f"{rels[worst]} of its max; all: {rels}")
    return dict(points=n, positives=cpos, loss_card=gl, loss_cpu=cl,
                gradients=len(rels), worst_grad=worst, worst_grad_rel=rels[worst],
                relu_gates=n_gates, gates_that_differed=sum(differ), counters=cdiag)


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
    gg_rows, gr_rows = train_kernel_phase(cfg, points, num_t, dev)
    e2e = end_to_end_phase(model, anchors, points, num_t)
    print(f"e2e: batch {BATCH} x {POINTS} points, p50 {e2e['latency_ms_p50']:.2f} ms, "
          f"peak mem {e2e['peak_mem_bytes'] / 2**30:.2f} GiB, "
          f"valid detections per frame {e2e['valid_per_frame']}, "
          f"counters {e2e['counters']}, launches {e2e['launches']}", flush=True)
    with full_float32():
        ref = reference_phase(sd, dev)
    print(f"reference check (card vs CPU, f32, small geometry): {ref}", flush=True)
    del model, anchors
    gc.collect()
    torch.cuda.empty_cache()      # the training phase starts from a clean pool
    expected = {"zwin_conv": 0,
                "gather_gemm": sum(r["launches_per_step"] for r in gg_rows),
                "gather_rows": sum(r["launches_per_step"] for r in gr_rows)}
    check(expected["gather_gemm"] == 27 and expected["gather_rows"] == 14,
          f"expected launches per training step {expected}")
    train = training_phase(cfg, dev, expected)
    print(f"train: batch {BATCH} x {POINTS} points, {TRAIN_TIMED} timed steps, p50 "
          f"{train['step_ms_p50']:.2f} ms, peak mem "
          f"{train['peak_mem_bytes'] / 2**30:.2f} GiB, losses "
          f"{[round(x, 4) for x in train['losses']]}, counters {train['counters']}, "
          f"launches per step {train['launches']}", flush=True)
    with full_float32():
        tref = training_reference_phase(dev)
    print(f"training reference check (card vs CPU, f32, small geometry): {tref}",
          flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    def per(rows, key, count="launches_per_step"):
        return sum(r[key] * r[count] for r in rows)

    def bound_by(rows):
        return ("bytes" if all(r["bf16_bound_by"] == "bytes" for r in rows)
                else "operations")

    def brief(rows, count, keys):
        return [{k: r[k] for k in ("shape", count) + keys} for r in rows]

    times = ("bf16_ms", "bf16_plain_ms", "bf16_bound_ms")
    entries = [
        {"name": "zwin_conv", "route": "cuda",
         "source": "vision3d_tpu_torch/csrc/zwin_conv.cu",
         "replaces": "vision3d_tpu/ops/pallas/zwin_conv.py:114",
         "launches": e2e["launches"]["zwin_conv"],
         "max_abs_err": max(r["bf16_max_abs_err"] for r in shapes),
         "ms": per(shapes, "bf16_ms", "launches_per_forward"),
         "plain_ms": per(shapes, "bf16_plain_ms", "launches_per_forward"),
         "bound_ms": per(shapes, "bf16_bound_ms", "launches_per_forward"),
         "bound_by": bound_by(shapes),
         # no single PyTorch call computes a z-window conv
         "library_ms": None,
         "shapes": brief(shapes, "launches_per_forward", ("M",) + times)},
        {"name": "gather_gemm", "route": "cuda",
         "source": "vision3d_tpu_torch/csrc/gather_gemm.cu",
         "replaces": "vision3d_tpu/ops/pallas/sparse_conv.py:52",
         "launches": train["launches"]["gather_gemm"],
         "max_abs_err": max(r["bf16_max_abs_err"] for r in gg_rows),
         "ms": per(gg_rows, "bf16_ms"), "plain_ms": per(gg_rows, "bf16_plain_ms"),
         "bound_ms": per(gg_rows, "bf16_bound_ms"), "bound_by": bound_by(gg_rows),
         # no single PyTorch call gathers K rows per output and multiplies
         "library_ms": None,
         "shapes": brief(gg_rows, "launches_per_step", ("M", "K", "hits") + times)},
        {"name": "gather_rows", "route": "cuda",
         "source": "vision3d_tpu_torch/csrc/gather_rows.cu",
         "replaces": "vision3d_tpu/ops/pallas/gather.py:34 and "
                     "vision3d_tpu/ops/pallas/dma_gather.py:29",
         "launches": train["launches"]["gather_rows"],
         "max_abs_err": max(r["bf16_max_abs_err"] for r in gr_rows),
         "ms": per(gr_rows, "bf16_ms"), "plain_ms": per(gr_rows, "bf16_plain_ms"),
         "bound_ms": per(gr_rows, "bf16_bound_ms"), "bound_by": bound_by(gr_rows),
         "library_ms": per(gr_rows, "bf16_library_ms"),   # torch.index_select
         "shapes": brief(gr_rows, "launches_per_step",
                         ("Q", "C", "bf16_library_ms") + times)},
    ]
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
