"""GPU smoke test of the PyTorch port: builds the CUDA kernels, holds each
against its plain PyTorch version at the shapes SECOND gives it, runs
full-geometry 3-class SECOND inference (configs/second/all_classes.yaml,
trained weights, bf16, batch 8 x 18,000 points) end to end on the voxel
and on the column backend, takes training steps of the same model from a
fresh seeded init, trains, evaluates and draws through the
command-line entry points on a synthetic KITTI-format set, runs
PV-RCNN inference, one stage and two, at full width and through eval_cli,
trains PV-RCNN in both modes at full width and through train_cli, trains
SECOND with dense late stages and on the column backend, runs and trains
PV-RCNN on the column backend, trains on several ranks, and runs Voxel
R-CNN inference at full width, and times the conv epilogue kernel.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, printing no result).
Phases, each printing lines before the last:
  1. build every kernel from csrc/ (one nvcc each, in parallel);
  2. zwin_conv vs its plain version at the main path's shapes on each of
     its routes (in bf16 the tensor-core route where the widths allow it
     and the FMA route at every shape, atol 2e-2 * max|ref|, rtol 2e-2; in
     float32 the FMA route, 1e-4 of the scale), each shape's route
     printed, with CUDA-event medians of kernel and plain times; on the
     same layers the two variants on gathered windows, zwin_align_v1 and
     zwin_align_v3, on the same routes, against their plain versions and
     against zwin_conv's output, each check repeated on a broken result of
     the same route (tap (dz 1, k2 4) dropped from the masks) that must
     fail it, with two bounds (the rows the masks select read once, and
     every gathered window read once); then the six layers of a forward
     through conv_zwin_apply_v1 / _v3: 6 launches of each variant, 5 on
     the tensor-core route;
  2b. the training path's kernels, gather_gemm (every sparse conv, forward
     and dX) and gather_rows (the dW regather), against their plain
     versions at every shape a training step gives them, on the real
     rulebooks of the batch: gather_gemm on each of its routes (in bf16 the
     tensor-core route where the widths allow it and the FMA route at
     every shape, in float32 the FMA route), each shape's route printed;
     gather_rows also beside torch.index_select;
  2c. column_conv against its plain version at the nine shapes of the
     column backend, on the real column rulebooks and active sites of the
     batch, on each of its routes (in bf16 the tensor-core route where the
     widths allow it and the FMA route at every shape; in float32 the FMA
     route), each shape's route printed, and per route a broken copy of
     the result that must fail the same check;
  3. Second.inference end to end at torch's default precision settings:
     launch counts of the run (6 zwin_conv, 5 of them on the tensor-core
     route), capacity counters all 0, finite outputs, p50 batch latency,
     peak memory;
  3b. the same on the column backend (dense_from_stage 2: 6 column_conv
     launches, 5 of them on the tensor-core route, no zwin_conv; then one
     forward with dense_from_stage 4: 14, 13 on the tensor-core route), its
     counters held against the plain column plan, its detections against
     the voxel backend's;
  4. a small-geometry reference check, per backend: the same model on the
     card and on the CPU (plain versions), float32 with TF32 off (every
     zwin_conv and column_conv launch on the FMA route), same detections;
  5. training at full geometry, bf16: train steps on one synthetic batch
     from a fresh seeded init: launch counts of a step (27 gather_gemm, 26
     of them on the tensor-core route, 14 gather_rows), capacity counters 0,
     finite loss / gradients / parameters, loss decreasing, p50 step time,
     peak memory;
  6. a small-geometry training reference: one loss.backward() on the card
     (kernels; float32, so every gather_gemm launch on the FMA route) and on
     the CPU (plain versions), float32 with TF32 off: loss to 1e-5
     relative, every gradient to 1e-4 of its tensor's max, running
     statistics to 1e-5;
  7. the command-line entry points at full geometry in the yaml's float32
     (every launch on the FMA route), on a synthetic KITTI-format set from
     tools/make_synthetic_kitti.py (16 train, 48 val frames): train_cli,
     batch 8 with 2 loader processes, one epoch from a fresh init and one
     more by --resume (launches per step, finite losses, checkpoints,
     frames/s and the share spent waiting for the loader); eval_cli on the
     48 val frames on that checkpoint (finite AP) and on the trained
     weights with TF32 off, whose AP@R40 table must be within 1.0 AP of
     the JAX package's on the same frames and weights in all 9 entries
     (tests/goldens/torch_eval_ap_jax_t16v48.json), with launches per
     batch and frames/s; inference_cli's BEV PNG of one frame from the
     checkpoint;
  8. PV-RCNN inference (``models/pvrcnn.py``) on the voxel backend, from a
     fresh seeded init (``init_pvrcnn``, CPU generator seed 0) whose batch
     norms then take one batch's statistics (a train-mode forward with
     momentum 1, so activations sit near unit scale and proposals near
     anchor size, as a trained model's do) and with score thresholds 0
     (the untrained head's scores sit near its 0.01 prior, below the
     yaml's thresholds): (a) at full width, bf16, batch 8 x 18,000
     points: inference (the BEV branch) and inference_two_stage (2048 FPS
     keypoints, set abstraction over 5 sources, BEV gather, keypoint
     weighting, RoI grid pool over 300 proposals x 16 grid points,
     refinement, NMS), each with 6 zwin_conv launches per forward (5 on
     the tensor-core route) and the two-stage one with 12 ball_query
     launches (BALL_QUERIES), capacity counters 0, 2048 distinct keypoints
     per frame, finite 512-wide point features, valid detections; the p50
     of 10 forwards after 3 warm-ups of each, the peak memory, and a
     per-stage split of the two-stage forward (host clock, synchronised
     at each stage's end); then the ball_query kernel at the forward's 12
     shapes (5 sources x 2 radii over the keypoints, the grid pool's 2
     over the grid points): equal to its plain version on the same card
     tensors, and again with one in-ball source masked out, which must
     fail; kernel and plain CUDA-event medians, the bound, per source
     (ball_query_ms); then (d) the fps kernel K3 at the benchmark cell's
     shape (B 8 x 18,000 points, K 2,048; all valid, and again with every
     other frame's tail masked out): equal to its plain version on the
     same card tensors, and run again with one taken point masked out,
     which must differ; kernel and plain CUDA-event medians, the host's
     time to enqueue it, the bound, the route and cluster size
     (fps_phase); (b) at small geometry in float32 with TF32
     off, card against CPU on the same weights and the same CPU-drawn
     grid points: keypoint and ball-query indices (5 sources x 2 radii)
     equal, point features, proposals, refined boxes and scores within
     1e-4 of their scale, detections paired by the column-vs-voxel gate;
     (c) eval_cli --model pvrcnn2 on phase 7's 48 val frames from the
     seeded init in the yaml's float32 (6 zwin_conv per batch, all on the
     FMA route, and 12 ball_query), frames/s, no AP gate (no trained
     PV-RCNN weights exist);
  9. PV-RCNN training (``make_pvrcnn_train_step``), stage 1 alone
     ("pvrcnn": the proposal loss, the point branch run for its batch
     norms) and both stages ("pvrcnn2": + refinement and keypoint
     segmentation losses): (a) at phase 8a's full width, bf16, from a fresh
     seeded init on phase 5's batch: launches of a step (27 gather_gemm, 26
     on the tensor-core route, 14 gather_rows, no zwin_conv; 10 ball_query
     in stage 1 alone, 12 in both stages), capacity
     counters 0, finite losses, the p50 of 6 steps after 3 warm-ups, peak
     memory, every pnets_* running statistic moved, the stage-2
     parameters moved (pvrcnn2) or absent (pvrcnn), and a synchronised
     forward / backward / optimizer split of a two-stage step; (b) at
     small geometry in float32 with TF32 off, one step of each mode on the
     card and on the CPU from one set of weights and batch (gt boxes on the
     first pass's proposals): keypoint and ball-query indices equal (11 and
     13 index sets), losses to 1e-5 relative, gradients to 1e-4 of their
     max on the card's ReLU gates (as phase 6), running statistics and the
     parameters after the step as PV_STAT_TOL's comment says; (c)
     train_cli --model pvrcnn and pvrcnn2 for one epoch of phase 7's 16
     train frames, then eval_cli --ckpt of each checkpoint as its own
     model, in the yaml's float32: launches per step and per batch,
     frames/s, host wait, finite AP tables (no gate);
 10. SECOND training in the other forms of the JAX package's train step
     (TRAIN_FORMS): (a) at phase 5's full geometry, bf16, from
     ``init_second`` seed 0 on phase 5's batch, voxel backend with
     ``train_dense_from_stage`` 2 and 3 (the late stages dense: cuDNN conv3d
     forward and backward, the cutover one gather_rows each way) and column
     backend at 4 and 2 (every column conv's dX on column_conv over the
     transposed BEV rulebook, its dW a gather_rows regather + one GEMM):
     launches of a step by kernel and route, the column convs' dX
     launches of it apart by route and shape (ColumnConvFn's backward),
     every gather_rows launch of it equal to the plain version, capacity
     counters 0, finite loss, gradients and parameters, loss decreasing,
     the p50 of 6 steps after 3 warm-ups, peak memory; (b) column_conv at
     the dX shapes, each held to the dX launches (a) counted there (the
     batch's transposed rulebooks, gradient rows at the active output
     sites interleaved in z) against its plain version on each route, as
     phase 2c, broken copies included; (c) at small geometry in float32
     with TF32 off, one step's loss, gradients and running statistics of
     voxel at 2, column at 4 and column at 2 on the card and on the CPU
     (the card's ReLU gates replayed), as phase 6; (d) train_cli on phase
     7's 16 train frames with --dense-from 2, on a yaml that sets
     SPARSE_BACKEND: column and with --model pvrcnn2 --dense-from 2, then
     eval_cli --ckpt of each checkpoint: launches per step and per batch,
     finite losses, frames/s, finite AP tables (no gate);
 11. PV-RCNN on the column backend and training on several ranks: (a) at
     full width, bf16, batch 8 x 18,000 points, phase 8's weights loaded
     into a column model: inference, one stage and two, at
     dense_from_stage 2 (6 column_conv per forward, 5 on the tensor-core
     route; counters 0, 2048 distinct keypoints per frame, finite point
     features, p50 and peak memory), then training steps of both modes at
     train_dense_from_stage 4 and 2 from a fresh seeded init, as phase 9a
     with launches by kernel and route (PV_COLUMN_TRAIN), the column dX
     launches apart and every gather_rows launch against its plain
     version; (b) at small geometry in float32 with TF32 off, card against
     CPU on columns: two-stage inference as phase 8b and one two-stage
     training step as phase 9b; (c) train_cli --model pvrcnn2 on a yaml
     that sets SPARSE_BACKEND: column for one epoch of phase 7's 16 train
     frames, then eval_cli --ckpt of its checkpoint (no AP gate); (d) two
     ranks on the one card over gloo against one process on the whole
     batch (4 frames, small geometry, float32; SECOND on voxels, on
     columns at 4, PV-RCNN two-stage; DDP_FORMS): losses, summed
     gradients, running statistics and counters, parameters after the step
     bit-equal across the ranks; then train_cli as rank 0 of a world of
     one over NCCL through the coordinator variables, whose first-step
     loss must equal a plain train_cli run's;
 12. the benchmark entry points, in process at full width (BENCH_RUNS):
     ``vision3d_tpu_torch.bench.main`` for SECOND on the voxel backend and
     on the column backend at the defaults (1 class, fresh seeded init,
     bf16, batch 8 x 18,000 points, 20 forwards a chain, 5 timed chains)
     and for PV-RCNN's two stages (2 forwards a chain, 2 timed chains),
     ``bench_train.main`` at its defaults (5 steps a chain, 3 timed
     chains, every stage sparse): each prints exactly one JSON line, shown
     here on a line of its own; its launches per forward or step (the
     run's launches over the forwards or steps its flags make) are the
     path's, every other kernel launched no time; capacity counters 0,
     finite outputs (the entry points raise on a non-finite checksum or
     loss), finite timings.
 13. Voxel R-CNN inference (``models/voxel_rcnn.py``) at the benchmark
     cell voxelrcnn-car-infer-b8's configuration (configs/second/car.yaml
     through ``voxel_rcnn_config``: VoxelBackBone8x all sparse,
     BaseBEVBackbone, 100 RoIs a frame, bf16, batch 8 x 18,000 points) from
     ``init_voxel_rcnn`` seed 0 with one batch's BN statistics: launches of
     a two-stage forward (VOXEL_RCNN_LAUNCHES: 12 zwin_conv, 11 on the
     tensor-core route, and 3 voxel_query), finite detections, no stage
     dropping a site over VOXEL_RCNN_BATCHES batches; on the forward's own
     scales and grid points, the voxel_query kernel (K2) equal to its
     plain version and to the forward's rows, and run again with one taken
     voxel dropped from the scale's map, which must fail; kernel and plain
     CUDA-event medians, the bound and the distance tests per scale; the
     (3, 1, 1) conv_out through ``embed_333`` on its own rulebook against
     the plain version, with a broken copy (centre tap zeroed) that must
     fail; the p50 of 10 forwards and the peak memory.
 14. kernel K4 (``ops/bn_relu``, every conv's inference epilogue) at the
     14 epilogues of one SECOND forward at the benchmark cell
     second-car-infer-b8's configuration (bf16, fresh seeded init), each
     on its own shape, strides and site mask (stages 2 and 3 dense, in
     place): equal to the plain chain bit for bit; kernel and plain
     CUDA-event medians and the bound (the site bytes and the active rows
     read once, every row written once), per epilogue, per forward and
     over the dense stages.
Every inference forward on the card, in every phase, launches K4 once a
conv (epilogue_launches: 14 a SECOND or PV-RCNN forward, 12 a Voxel R-CNN
forward; float32 conv outputs on its "f32" route, the dense stages' bf16
ones on "bf16"); no training step launches it.
Every PV-RCNN forward or step on the card, in every phase, launches
ball_query as BALL_QUERIES says (12 a two-stage forward or step, 10 a
stage-1 step, none for the BEV branch alone or SECOND) and fps once
(point_launches). The last line is
{"ok": true, "device": {...}}; the one before it lists the kernels as
JSON (ball_query, voxel_query and fps with their launches per forward and
their times per query, bn_relu with phase 14's epilogues),
and the one before that is the card's name and power limit from
nvidia-smi.
"""

import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from vision3d_tpu_torch import convert, kernels
from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.models.second import create_second
from vision3d_tpu_torch.core.anchors import make_anchors
from vision3d_tpu_torch.core.targets import assign_targets_batch
from vision3d_tpu_torch.core.voxelize import mean_vfe, voxelize_batch
from vision3d_tpu_torch.models.head import decode_proposals, multiclass_nms
from vision3d_tpu_torch.models.losses import proposal_loss
from vision3d_tpu_torch.models import pointnet as tpointnet
from vision3d_tpu_torch.models import pvrcnn as tpvrcnn
from vision3d_tpu_torch.models.pvrcnn import (STAGE2_MODULES, bev_bilinear_gather,
                                              create_pvrcnn, point_mask)
from vision3d_tpu_torch.models.refinement import apply_refinements, sample_gridpoints
from vision3d_tpu_torch.models.rpn import BatchNorm2d
from vision3d_tpu_torch.models.second import build_middle_input
from vision3d_tpu_torch.models.voxel_rcnn import (VoxelRCNN, create_voxel_rcnn,
                                                  roi_grid_points, voxel_rcnn_config)
from vision3d_tpu_torch.models.sparse_cnn import (CNN_FACTORY, MaskedBatchNorm,
                                                  SpMiddleFHD, from_voxels,
                                                  from_voxels_columns, to_global)
from vision3d_tpu_torch.ops.ball_query import ball_query, ball_query_plain
from vision3d_tpu_torch.ops import voxel_query as vq
from vision3d_tpu_torch.ops.fps import (furthest_point_sample, furthest_point_sample_plain,
                                        sample_keypoints)
from vision3d_tpu_torch.ops.fps import plan as fps_plan
from vision3d_tpu_torch.ops import column_sparse as csp
from vision3d_tpu_torch.ops import sparse as sp
from vision3d_tpu_torch.ops import zwin_conv as zw
from vision3d_tpu_torch.ops.column_conv import column_conv
from vision3d_tpu_torch.ops.gather_gemm import gather_gemm, route_of
from vision3d_tpu_torch.ops.gather_rows import gather_rows, gather_rows_plain
from vision3d_tpu_torch.parallel import mesh
from vision3d_tpu_torch.synthetic import kitti_like_batch, kitti_like_train_batch
from vision3d_tpu_torch.training.train import (create_pvrcnn_train_state,
                                               create_train_state, make_lr_schedule,
                                               make_pvrcnn_train_step, make_train_step)

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "second" / "all_classes.yaml"
WEIGHTS = ROOT / "vision3d_tpu_torch" / "weights" / "second_all_classes_epoch11.npz"
# the JAX package's AP table of WEIGHTS' checkpoint on the synthetic set of
# phase 7 (the file holds the commands that made it)
GOLDEN = ROOT / "tests" / "goldens" / "torch_eval_ap_jax_t16v48.json"
AP_GATE = 1.0     # AP points, every class x difficulty
BATCH, POINTS = 8, 18000
STEPS_PER_EPOCH = 928         # 3712 KITTI train frames / 4, as bench_train.py
TRAIN_WARMUP, TRAIN_TIMED = 3, 6
# Column against voxel backend, bf16, same batch and weights (phase 3b).
# The backends share every op but the sparse convs. Their tensor-core routes
# (B1, B3) sum a conv's taps in one order (hit taps k = dz*K2 + k2, 16
# channels a step), and on the card the detections came out equal; while
# B3 summed by (k2, dz, c) in float32 FMA they differed: 410 detections
# each, 1 unpaired on either side, boxes within 0.0059 m, scores within
# 0.0017 (PERF.md). The gate leaves the room that another sum order takes: the
# column forward at dense_from_stage 4 against 2 (cuDNN sums stages 2-3
# otherwise) moved boxes by 0.069 m, scores by 0.0032 and 3 of 412
# detections.
BACKENDS_MAX_UNMATCHED = 0.02     # share of detections with no partner within 0.5 m
BACKENDS_MAX_BOX, BACKENDS_MAX_SCORE = 0.1, 0.02
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet peaks
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12        # outside the tensor cores
# conversions between float32 and float64: 16 a clock on an SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) x 132 SMs x the 1.98 GHz boost clock (H100 SXM)
CVT_PER_S = 16 * 132 * 1.98e9
# PV-RCNN, card against CPU at small geometry in float32 (phase 8b): sums
# in other orders (cuDNN and cuBLAS against the CPU's) through the trunk
# and the point branch; 10x the port-against-JAX bound of the CPU tests
PV_TOL = 1e-4
PV_REF_POINTS = 8000          # points per cloud of phases 8b and 9b (the CPU's time)
PV_MODES = ("pvrcnn", "pvrcnn2")
# ball_query launches of a PV-RCNN forward or training step: stage 1's five
# sources x two radii ("pvrcnn"), and two more in the RoI grid pool
# ("pvrcnn2"); SECOND and PV-RCNN's one-stage inference (the BEV branch)
# launch none
BALL_QUERIES = {"pvrcnn": 10, "pvrcnn2": 12}


def point_launches(mode, times=1):
    """The point branch's kernel launches in ``times`` PV-RCNN forwards or
    training steps of ``mode``: its ball queries and one fps (the
    keypoints, on the "reg" route at every size this file runs) each."""
    return {"ball_query": BALL_QUERIES[mode] * times, "fps": times, "fps.reg": times}


def epilogue_launches(cfg, times=1):
    """K4's launches (``bn_relu``) in ``times`` inference forwards of
    ``cfg``'s middle extractor: one a conv, on the route of the conv
    output's dtype: float32 from the sparse convs (B1, B3), the compute
    dtype from the dense stages' cuDNN conv3d (``cfg.dense_from_stage`` on).
    Training launches none."""
    counts = {"f32": 0, "bf16": 0}
    for si, (chans, _) in enumerate(CNN_FACTORY[cfg.cnn](cfg).block_specs()):
        bf16 = si >= cfg.dense_from_stage and cfg.compute_dtype == "bfloat16"
        counts["bf16" if bf16 else "f32"] += (len(chans) + 1) * times
    return {"bn_relu": sum(counts.values()),
            **{f"bn_relu.{r}": n for r, n in counts.items() if n}}


# PV-RCNN training, card against CPU at small geometry in float32 (phase
# 9b): running statistics to 1e-5 of 1 + |value| (the CPU tests' bound
# against JAX); the other gates are in pvrcnn_training_reference_phase
PV_STAT_TOL = 1e-5
PV_TRAIN_WARMUP, PV_TRAIN_TIMED = 3, 6
# train_cli --model pvrcnn2 --dense-from 2 in the yaml's float32 (phase 10d)
# ran out of the card's 80 GB at batch 8 (75.08 GiB allocated when a
# 900 MiB request failed, NVIDIA H100 80GB HBM3): it takes batches of 4
PV_DENSE_CLI_BATCH = 4
# phase 5's all-sparse step, voxel backend (phase 6 checks it card vs CPU)
ALL_SPARSE = (dict(), {"gather_gemm": 27, "gather_gemm.mma": 26, "gather_gemm.fma": 1,
                       "gather_rows": 14})
# SECOND training in the forms of phase 10, each with the launches of one
# bf16 step by kernel and route (phase 5's all-sparse voxel step has 27
# gather_gemm + 14 gather_rows): a sparse conv launches once forward, once
# for dX (but the first conv, whose VFE input takes no gradient) and one
# gather_rows for its dW regather; a dense cutover one gather_rows forward
# and one backward. Only the first conv (C = 4) runs on "fma".
TRAIN_FORMS = {
    "voxel_df2": (dict(train_dense_from_stage=2),
                  {"gather_gemm": 11, "gather_gemm.mma": 10, "gather_gemm.fma": 1,
                   "gather_rows": 8}),
    "voxel_df3": (dict(train_dense_from_stage=3),
                  {"gather_gemm": 19, "gather_gemm.mma": 18, "gather_gemm.fma": 1,
                   "gather_rows": 12}),
    "column_df4": (dict(sparse_backend="column"),
                   {"column_conv": 27, "column_conv.mma": 26, "column_conv.fma": 1,
                    "gather_rows": 14}),
    "column_df2": (dict(sparse_backend="column", train_dense_from_stage=2),
                   {"column_conv": 11, "column_conv.mma": 10, "column_conv.fma": 1,
                    "gather_rows": 8}),
}


# of TRAIN_FORMS' column_conv launches per step, those of the column convs'
# dX (the first conv, C = 4, takes none), all on "mma" in bf16
TRAIN_FORMS_DX = {"column_df4": 13, "column_df2": 5}
# PV-RCNN training on columns (phase 11a), both modes at
# train_dense_from_stage 4 and 2: the trunk's launches are SECOND's in the
# same form (the scales' conversions are gathers of plain PyTorch), so
# {name: (mode, config changes, launches of a step, column dX launches,
# frames)}. The two-stage step at 2 takes 4 frames of phase 5's batch: at
# 8 in bf16 it ran out of the card's 80 GB (76.0 GiB allocated when a
# 2.36 GiB request failed, NVIDIA H100 80GB HBM3)
PV_COLUMN_TRAIN = {f"{mode}_{form}": (mode, TRAIN_FORMS[form][0], TRAIN_FORMS[form][1],
                                      TRAIN_FORMS_DX[form],
                                      4 if (mode, form) == ("pvrcnn2", "column_df2") else BATCH)
                   for mode in PV_MODES for form in ("column_df4", "column_df2")}
PV_COLUMN_STEPS = (2, 4)      # warm-up and timed steps of each phase-11a run
# Several ranks against one process on the whole batch (phase 11d and
# tests/test_torch_ddp.py): {form: (model, config changes)}; float32, the
# one process's ReLU gates and max-pool selections replayed in every rank
# (a batch-norm statistic summed in another order moves a ReLU input by a
# float32 hair, and a gate that flips moves earlier gradients by ~1e-3 of
# their max; phase 6); losses to 1e-5 relative, gradients to 1e-4 of their
# max, running statistics to 1e-5 of 1 + |value|
DDP_FORMS = {"second_voxel": ("second", {}),
             "second_column4": ("second", dict(sparse_backend="column")),
             "pvrcnn2": ("pvrcnn2", {})}
DDP_LOSS_TOL, DDP_GRAD_TOL, DDP_STAT_TOL = 1e-5, 1e-4, 1e-5
# Voxel R-CNN (phase 13) on car.yaml's geometry and anchors, the benchmark
# cell voxelrcnn-car-infer-b8's configuration: launches of a two-stage
# forward (VoxelBackBone8x's 8 submanifold and 4 strided convs all sparse,
# the first, C = 4, on "fma", the (3, 1, 1) conv_out through embed_333;
# one voxel query a pooled scale), and the batches (kitti_like_batch
# seeds) over which no stage may drop a site at dense_from_stage 4
CAR_CONFIG = ROOT / "configs" / "second" / "car.yaml"
VOXEL_RCNN_LAUNCHES = {"zwin_conv": 12, "zwin_conv.mma": 11, "zwin_conv.fma": 1,
                       "voxel_query": 3}
VOXEL_RCNN_BATCHES = 8


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


def agrees(got, ref, tol):
    """|got - ref| <= tol * max|ref| + tol * |ref| everywhere."""
    scale = float(ref.abs().max())
    return bool(((got - ref).abs() <= tol * scale + tol * ref.abs()).all())


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


ALIGN = {"v1": (zw.zwin_align_gemm_v1, zw.zwin_align_gemm_v1_plain, zw.pair_masks),
         "v3": (zw.zwin_align_gemm_v3, zw.zwin_align_gemm_v3_plain, zw.shift_masks)}


def align_selected(variant, masks):
    """(rows, routed): the gathered rows that some set mask routes to a tap
    (each read once) and the (row, tap) products the masks ask for: the
    least work of B6 / B7 on these masks. v3 entries with j + s > 2 name no
    tap."""
    on = masks != 0
    if variant == "v1":
        rows = sum(int(on[..., [zw.PAIRS.index((dz, j)) for dz in range(j, 3)]]
                       .any(-1).sum()) for j in range(3))
        return rows, int(on.sum())
    names_tap = torch.tensor([[j + s < 3 for j in range(3)] for s in range(3)],
                             device=masks.device)
    on = on.reshape(3, *on.shape[1:3], 9, 3) & names_tap[:, None, None, None, :]
    return int(on.any(0).sum()), int(on.sum())


def align_bound_ms(variant, g_km, masks, cout, dtype):
    """Bounds of B6 / B7 on these windows and masks, with 2*C*Cout flops
    per routed product: (least, bound_by, every_window, rows). ``least``
    reads the masks, the rows they select and the weight once;
    ``every_window`` every gathered window instead of the selected rows."""
    b, _, m, kzc = g_km.shape
    c = kzc // 3
    rows, routed = align_selected(variant, masks)
    esize = g_km.element_size()
    fixed = (masks.numel() + 27 * c * cout) * esize + b * m * cout * 4
    least, by = _bound(fixed + rows * c * esize, 2 * c * cout * routed, dtype)
    every, _ = _bound(fixed + g_km.numel() * esize, 2 * c * cout * routed, dtype)
    return least, by, every, rows


def drop_tap(variant, masks, dz=1, k2=4):
    """The masks with tap (dz, k2) of every site dropped: the input of a
    deliberately broken result."""
    out = masks.clone()
    for j in range(dz + 1):
        if variant == "v1":
            out[:, k2, :, zw.PAIRS.index((dz, j))] = 0
        else:
            out.view(3, *out.shape[1:3], 9, 3)[dz - j, :, :, k2, j] = 0
    return out


def align_variant(variant, label, feats, start, pattern, w, dtype, tol, zwin_out, route):
    """One of the two kernels on gathered windows (B6 v1, B7 v3) on a
    z-window layer of the path, on ``route`` (None: the one ``route_of``
    picks): against its plain version and against the z-window kernel's
    output on the same layer, the check repeated on a broken result that
    must fail it; the kernel's time and, on the default route, the plain
    time and two bounds: ``bound_ms`` reads the masks, the rows they
    select and the weight once (the least bytes), ``bound_all_ms`` every
    gathered window."""
    fn, plain, make_masks = ALIGN[variant]
    c, m, cout = feats.shape[2], start.shape[1] // 9, w.shape[1]
    label = f"zwin_align_{variant} {label} ({route or route_of(dtype, c, cout)})"
    g_km = zw.gather_windows_km(feats, start, dtype)
    masks = make_masks(pattern, m, dtype)
    got = fn(g_km, masks, w, route=route)
    torch.cuda.synchronize()
    ref = plain(g_km, masks, w)
    err = float((got - ref).abs().max())
    check(torch.isfinite(got).all().item(), f"{label}: non-finite")
    check(agrees(got, ref, tol), f"{label}: kernel disagrees with plain version "
                                 f"(max abs err {err})")
    check(agrees(got, zwin_out, tol), f"{label}: disagrees with zwin_conv "
          f"(max abs err {float((got - zwin_out).abs().max())})")
    broken = fn(g_km, drop_tap(variant, masks), w, route=route)
    broken_err = float((broken - ref).abs().max())
    check(not agrees(broken, ref, tol), f"{label}: a result with a tap dropped passes "
                                        "the check: the check is vacuous")
    del got, ref, broken
    res = {"max_abs_err": err, "broken_err": broken_err,
           "ms": cuda_ms(lambda: fn(g_km, masks, w, route=route), reps=10)}
    if route is None:
        bound, by, bound_all, rows = align_bound_ms(variant, g_km, masks, cout, dtype)
        res.update({"plain_ms": cuda_ms(lambda: plain(g_km, masks, w), reps=3, warmup=1),
                    "bound_ms": bound, "bound_by": by, "bound_all_ms": bound_all,
                    "rows": rows})
    return res


def align_variants_path(layers, dev):
    """B6 and B7 have no model path: their path is the six z-window layers
    of the forward, through ``conv_zwin_apply_v1`` / ``_v3`` (window gather
    and masks in plain PyTorch, then the kernel), in bf16: 6 launches of
    each, 5 on the tensor-core route and s0 subm 4x16 on FMA. Returns the
    launch counts of that run."""
    gen = torch.Generator(device=dev).manual_seed(3)
    zw.reset_launches()
    for name, count, c, cout, n, start, pattern in layers:
        feats = torch.randn((start.shape[0], n, c), generator=gen, device=dev)
        w = torch.randn((27 * c, cout), generator=gen, device=dev) / (27 * c) ** 0.5
        for _ in range(count):
            for fn in (zw.conv_zwin_apply_v1, zw.conv_zwin_apply_v3):
                out = fn(feats, start, pattern, w, (3, 3, 3), torch.bfloat16)
                check(bool(torch.isfinite(out).all()), f"{fn.__name__} {name}: non-finite")
    torch.cuda.synchronize()
    launches = dict(zw.LAUNCHES)
    want = {"zwin_conv": 0}
    for v in ALIGN:
        want.update({f"zwin_align_{v}": 6, f"zwin_align_{v}.mma": 5,
                     f"zwin_align_{v}.fma": 1})
    check(all(launches[k] == n for k, n in want.items()),
          f"variants run launched {launches}, not {want}")
    return launches


def kernel_phase(layers, dev):
    """Phase 2: B1 against its plain version at every path shape, on each
    route the widths allow (in bf16 the tensor-core route where
    ``route_of`` picks it and the FMA route at every shape; in float32
    the FMA route), and B6 and B7 on the same layers and routes."""
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = []
    for name, count, c, cout, n, start, pattern in layers:
        b = start.shape[0]
        feats = torch.randn((b, n, c), generator=gen, device=dev)
        w = torch.randn((27 * c, cout), generator=gen, device=dev) / (27 * c) ** 0.5
        row = {"shape": name, "launches_per_forward": count, "B": b, "N": n,
               "M": start.shape[1] // 9, "C": c, "Cout": cout,
               "route": route_of(torch.bfloat16, c, cout)}
        runs = [("bf16", torch.bfloat16, 2e-2, None), ("f32", torch.float32, 1e-4, None)]
        if row["route"] != "fma":
            runs.insert(1, ("bf16_fma", torch.bfloat16, 2e-2, "fma"))
        for tag, dtype, tol, route in runs:
            label = f"zwin_conv {name} {tag} ({route or route_of(dtype, c, cout)})"
            got = zw.zwin_conv(feats, start, pattern, w, (3, 3, 3), dtype, route=route)
            torch.cuda.synchronize()
            ref = sp.conv_zwin_apply(feats, start, pattern, w, (3, 3, 3), dtype)
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            check(torch.isfinite(got).all().item(), f"{label}: non-finite")
            check(scale > 0, f"{label}: the plain version is all zero")
            check(agrees(got, ref, tol), f"{label}: kernel disagrees with plain "
                                         f"version (max abs err {err}, scale {scale})")
            del ref
            ms = cuda_ms(lambda: zw.zwin_conv(feats, start, pattern, w, (3, 3, 3), dtype,
                                              route=route))
            row.update({f"{tag}_max_abs_err": err, f"{tag}_ref_scale": scale,
                        f"{tag}_ms": ms})
            if route is None:
                plain = cuda_ms(lambda: sp.conv_zwin_apply(feats, start, pattern, w,
                                                           (3, 3, 3), dtype), reps=10)
                bound, by, taps = zwin_bound_ms(b, n, c, cout, start, pattern, dtype)
                row.update({f"{tag}_plain_ms": plain, f"{tag}_bound_ms": bound,
                            f"{tag}_bound_by": by, "active_taps": taps})
            for variant in ALIGN:
                res = align_variant(variant, f"{name} {tag}", feats, start, pattern,
                                    w, dtype, tol, got, route)
                row.update({f"{variant}_{tag}_{k}": v for k, v in res.items()})
            del got
        for key in ["bf16_fma_ms"] + [f"{v}_bf16_fma_ms" for v in ALIGN]:
            row.setdefault(key, row[key.replace("_fma", "")])
        print(f"zwin_conv {name} x{count}: B={b} N={n} M={row['M']} "
              f"taps={row['active_taps']} bf16 {row['route']} {row['bf16_ms']:.4f} ms "
              f"(fma {row['bf16_fma_ms']:.4f}, plain {row['bf16_plain_ms']:.3f}, "
              f"bound {row['bf16_bound_ms']:.4f} {row['bf16_bound_by']}, "
              f"err {row['bf16_max_abs_err']:.3g} of scale {row['bf16_ref_scale']:.3g}) "
              f"| f32 fma {row['f32_ms']:.4f} ms (plain {row['f32_plain_ms']:.3f}, "
              f"err {row['f32_max_abs_err']:.3g})", flush=True)
        for variant in ALIGN:
            v = {k[len(variant) + 1:]: x for k, x in row.items()
                 if k.startswith(variant + "_")}
            print(f"zwin_align_{variant} {name} x{count}: rows={v['bf16_rows']} bf16 "
                  f"{row['route']} {v['bf16_ms']:.4f} ms (fma {v['bf16_fma_ms']:.4f}, "
                  f"plain {v['bf16_plain_ms']:.3f}, bound {v['bf16_bound_ms']:.4f} "
                  f"{v['bf16_bound_by']} [every window read: "
                  f"{v['bf16_bound_all_ms']:.4f}], x{v['bf16_ms'] / v['bf16_bound_ms']:.1f} "
                  f"of the bound, err {v['bf16_max_abs_err']:.3g}, broken copy err "
                  f"{v['bf16_broken_err']:.3g}) | f32 fma {v['f32_ms']:.4f} ms (plain "
                  f"{v['f32_plain_ms']:.3f}, err {v['f32_max_abs_err']:.3g}); equal to "
                  f"zwin_conv within tolerance", flush=True)
        shapes.append(row)
    return shapes


def route_launches(name, rows, count):
    """The launches of kernel ``name`` that ``rows`` give, in all and per
    route: {name: n, name.route: n, ...}."""
    want = {name: sum(r[count] for r in rows)}
    for route in kernels.ROUTES[name]:
        want[f"{name}.{route}"] = sum(r[count] for r in rows if r["route"] == route)
    return want


def column_path_layers(cfg, points, num):
    """The column convs of the column backend with their real rulebooks and
    active sites, from the plain column plan of the batch run through all
    four stages (``dense_from_stage = 4``). Returns (layers, counters):
    layers, one dict per distinct conv shape, with its launches per forward
    at ``dense_from_stage`` 2 and 4, its transposed rulebook ``rbt`` and
    its active output sites ``out_site`` (what the dX of training reads,
    phase 10b); counters, the plan's own drop counts under the names
    ``Second.forward`` gives them."""
    layers = []
    with torch.no_grad():
        vox = voxelize_batch(points, num, cfg)
        ct, ndrop = from_voxels_columns(
            mean_vfe(vox["features"], vox["occupancy"]), vox["coords"],
            vox["voxel_mask"], cfg.grid_shape_zyx, cfg.stage_column_capacity(0))
        counters = {"stage0_columns_dropped": int(ndrop.sum())}
        keys, mask, grid = ct.keys, ct.mask, ct.grid
        site = ct.zmask & mask[..., None]
        cin = cfg.c_in
        for si, (chans, spec) in enumerate(SpMiddleFHD(cfg).block_specs()):
            common = dict(D=grid[0], N=keys.shape[1], site=site)
            rbs = csp.build_bev_rulebook_batched(keys, mask, grid[1:], (3, 3), (1, 1),
                                                 (1, 1))
            widths = {}
            for ch in chans:
                widths[(cin, ch)] = widths.get((cin, ch), 0) + 1
                cin = ch
            for (ci, co), cnt in widths.items():
                layers.append(dict(shape=f"s{si}_subm_{ci}x{co}", launches_df4=cnt,
                                   launches_per_forward=cnt if si < 2 else 0, C=ci,
                                   Cout=co, kernel=(3, 3, 3), stride_z=1, pad_z=1,
                                   rb=rbs, rbt=rbs, out_site=site, **common))
            kernel, stride, pad = spec["kernel"], spec["stride"], spec["pad"]
            out_grid = sp.out_grid_shape(grid, kernel, stride, pad)
            if kernel[1:] == (1, 1) and stride[1:] == (1, 1):
                ok, om, nd = keys, mask, torch.zeros_like(ndrop)
            else:
                ok, om, nd = csp.downsample_bev_columns(
                    keys, mask, grid[1:], kernel[1:], stride[1:], pad[1:],
                    cfg.stage_column_capacity(si + 1), out_grid[1:])
            counters[f"stage{si + 1}_columns_dropped"] = int(nd.sum())
            rbd = csp.build_bev_rulebook_batched(keys, mask, grid[1:], kernel[1:],
                                                 stride[1:], pad[1:], ok, om, out_grid[1:])
            cout = spec["features"]
            rbt = csp.transpose_bev_rulebook_batched(keys, mask, grid[1:], kernel[1:],
                                                     stride[1:], pad[1:], ok, om,
                                                     out_grid[1:])
            out_site = csp.column_occupancy_batched(site, rbd, kernel, stride[0],
                                                    pad[0]) & om[..., None]
            layers.append(dict(shape=f"s{si}_down_{cin}x{cout}_k{kernel[1] * kernel[2]}",
                               launches_df4=1, launches_per_forward=1 if si < 2 else 0,
                               C=cin, Cout=cout, kernel=kernel, stride_z=stride[0],
                               pad_z=pad[0], rb=rbd, rbt=rbt, out_site=out_site,
                               **common))
            site = out_site
            keys, mask, grid, cin = ok, om, out_grid, cout
    return layers, counters


def column_kernel_phase(layers, dev):
    """Phase 2c: B3 against its plain version at every shape of the column
    backend: random values at the layer's real active sites (zeros
    elsewhere, as the model's rows are) in the compute dtype (the model's
    column layers hand bf16 rows on), the layer's real rulebook, on each
    route the widths allow (in bf16 the tensor-core route where
    ``route_of`` picks it and the FMA route at every shape; in float32 the
    FMA route). Each check is repeated on a deliberately broken result of
    the same route (the last BEV offset of every column dropped), which
    must fail it."""
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for layer in layers:
        name, c, cout, d, n = (layer[k] for k in ("shape", "C", "Cout", "D", "N"))
        kernel, sz, pz, rb, site = (layer[k] for k in
                                    ("kernel", "stride_z", "pad_z", "rb", "site"))
        kz, k2 = kernel[0], kernel[1] * kernel[2]
        b, m = rb.shape[0], rb.shape[1] // k2
        d_out = csp.conv_out_depth(d, kz, sz, pz)
        values = (torch.randn((b, n, d, c), generator=gen, device=dev)
                  * site[..., None]).reshape(b, n, d * c)
        w = torch.randn((kz * k2 * c, cout), generator=gen, device=dev) / (kz * k2 * c) ** 0.5
        # what this rulebook and these active sites need: one C x Cout product
        # per (output z, BEV offset, dz) whose input site is active
        zt = F.pad(site, (pz, pz, 0, 1))
        win = torch.gather(zt, 1, rb.long()[..., None].expand(b, m * k2, zt.shape[-1]))
        taps = int(win.unfold(-1, kz, sz).sum())
        out_sites = int(csp.column_occupancy_batched(site, rb, kernel, sz, pz).sum())
        del zt, win
        rb_broken = rb.reshape(b, m, k2).clone()
        rb_broken[..., -1] = n
        rb_broken = rb_broken.reshape(b, m * k2)
        row = {"shape": name, "launches_per_forward": layer["launches_per_forward"],
               "launches_df4": layer["launches_df4"], "B": b, "N": n, "M": m, "D": d,
               "D_out": d_out, "C": c, "Cout": cout, "K2": k2, "active_taps": taps,
               "active_out_sites": out_sites, "route": route_of(torch.bfloat16, c, cout),
               "kz": kz, "pad_z": pz}
        runs = [("bf16", torch.bfloat16, 2e-2, None), ("f32", torch.float32, 1e-4, None)]
        if row["route"] != "fma":
            runs.insert(1, ("bf16_fma", torch.bfloat16, 2e-2, "fma"))
        for tag, dtype, tol, route in runs:
            label = f"column_conv {name} {tag} ({route or route_of(dtype, c, cout)})"
            # in the compute dtype, as the model's column layers pass their rows
            feats = values.to(dtype)
            got = column_conv(feats, rb, w, kernel, d, c, sz, pz, dtype, route=route)
            torch.cuda.synchronize()
            ref = csp.column_conv_dz(feats, rb, w, kernel, d, c, sz, pz, dtype)
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            check(torch.isfinite(got).all().item(), f"{label}: non-finite")
            check(scale > 0, f"{label}: the plain version is all zero")
            check(agrees(got, ref, tol), f"{label}: kernel disagrees with plain "
                                         f"version (max abs err {err}, scale {scale})")
            broken = column_conv(feats, rb_broken, w, kernel, d, c, sz, pz, dtype,
                                 route=route)
            broken_err = float((broken - ref).abs().max())
            check(not agrees(broken, ref, tol), f"{label}: a result with a BEV offset "
                  "dropped passes the check: the check is vacuous")
            del got, ref, broken
            ms = cuda_ms(lambda: column_conv(feats, rb, w, kernel, d, c, sz, pz, dtype,
                                             route=route), reps=10)
            row.update({f"{tag}_max_abs_err": err, f"{tag}_ref_scale": scale,
                        f"{tag}_broken_err": broken_err, f"{tag}_ms": ms})
            if route is None:
                plain = cuda_ms(lambda: csp.column_conv_dz(feats, rb, w, kernel, d, c,
                                                           sz, pz, dtype), reps=3, warmup=1)
                nbytes = ((feats.numel() + w.numel()) * feats.element_size()
                          + rb.numel() * 4 + b * m * d_out * cout * 4)
                bound, by = _bound(nbytes, 2 * c * cout * taps, dtype)
                row.update({f"{tag}_plain_ms": plain, f"{tag}_bound_ms": bound,
                            f"{tag}_bound_by": by})
        row.setdefault("bf16_fma_ms", row["bf16_ms"])
        print(f"column_conv {name} x{row['launches_per_forward']} (x{row['launches_df4']} "
              f"all-column): B={b} N={n} M={m} D={d}->{d_out} taps={taps} "
              f"out sites={out_sites} bf16 {row['route']} {row['bf16_ms']:.4f} ms (fma "
              f"{row['bf16_fma_ms']:.4f}, plain {row['bf16_plain_ms']:.3f}, bound "
              f"{row['bf16_bound_ms']:.4f} {row['bf16_bound_by']}, err "
              f"{row['bf16_max_abs_err']:.3g} of scale {row['bf16_ref_scale']:.3g}, "
              f"broken copy err {row['bf16_broken_err']:.3g}) | f32 fma "
              f"{row['f32_ms']:.4f} ms (plain {row['f32_plain_ms']:.3f}, err "
              f"{row['f32_max_abs_err']:.3g})", flush=True)
        rows.append(row)
    return rows


def counted_forward(model, anchors, points, num, want_launches, want_counters=None):
    """One forward with the launch counts set to 0 just before and read just
    after. The kernels in ``want_launches`` must have launched exactly that
    often, every other kernel not at all; the capacity counters must equal
    ``want_counters``, or without it all but ``voxelizer_dropped`` be 0.
    Returns (Detections, launches, counters)."""
    zw.reset_launches()
    torch.cuda.synchronize()
    with torch.no_grad():
        det, diag = model.inference(points, num, anchors)
    torch.cuda.synchronize()
    launches = dict(zw.LAUNCHES)
    for name, n in launches.items():
        check(n == want_launches.get(name, 0), f"{name} launched {n} times in one "
              f"forward, not {want_launches.get(name, 0)}")
    counters = {k: int(v) for k, v in diag.items()}
    if want_counters is not None:
        check(counters == want_counters, f"capacity counters {counters} differ from "
                                         f"the plain plan's {want_counters}")
    else:
        for k, v in counters.items():
            if k != "voxelizer_dropped":
                check(v == 0, f"capacity counter {k} = {v}")
    for name, t in det._asdict().items():
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()), f"non-finite {name}")
    k = model.cfg.num_classes * model.cfg.proposal.topk
    check(tuple(det.boxes.shape) == (points.shape[0], k, 7), "Detections shape")
    check(int(det.valid.sum()) > 0, "no valid detection in the batch")
    return det, launches, counters


def end_to_end_phase(model, anchors, points, num, want_launches, want_counters=None):
    """Phases 3 and 3b: one counted forward, then timed ones."""
    det, launches, counters = counted_forward(model, anchors, points, num,
                                              want_launches, want_counters)
    valid = det.valid.sum(dim=1).tolist()
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
    return dict(det=det, launches=launches, counters=counters, valid_per_frame=valid,
                latency_ms_p50=float(np.median(times)),
                latency_ms=[float(t) for t in times],
                peak_mem_bytes=int(torch.cuda.max_memory_allocated()))


def compare_backends(det_a, det_b, radius=0.5):
    """Detections of two runs on one batch: every valid detection of one is
    paired with the nearest valid detection of the other that has its class
    (centre distance, at most ``radius`` m). Returns the counts, the
    detections left without a partner on either side, and over the pairs
    the largest |box difference| (yaw modulo pi) and |score difference|."""
    out = dict(n_a=int(det_a.valid.sum()), n_b=int(det_b.valid.sum()), unmatched_a=0,
               unmatched_b=0, box_delta=0.0, score_delta=0.0)
    for f in range(det_a.boxes.shape[0]):
        va, vb = det_a.valid[f], det_b.valid[f]
        ba, bb = det_a.boxes[f][va].float(), det_b.boxes[f][vb].float()
        if len(ba) == 0 or len(bb) == 0:
            out["unmatched_a"] += len(ba)
            out["unmatched_b"] += len(bb)
            continue
        dist = torch.cdist(ba[:, :3], bb[:, :3])
        dist[det_a.class_idx[f][va][:, None] != det_b.class_idx[f][vb][None]] = float("inf")
        near, idx = dist.min(dim=1)
        hit = near <= radius
        out["unmatched_a"] += int((~hit).sum())
        out["unmatched_b"] += int((dist.min(dim=0).values > radius).sum())
        if hit.any():
            diff = (ba[hit] - bb[idx[hit]]).abs()
            diff[:, 6] = ((ba[hit, 6] - bb[idx[hit], 6] + np.pi / 2) % np.pi - np.pi / 2).abs()
            score = (det_a.scores[f][va][hit] - det_b.scores[f][vb][idx[hit]]).abs()
            out["box_delta"] = max(out["box_delta"], float(diff.max()))
            out["score_delta"] = max(out["score_delta"], float(score.max()))
    return out


def column_phase(cfg, sd, anchors, points, num, dev, plan_counters, voxel_run,
                 want_launches, want_launches_df4):
    """Phase 3b: the column backend end to end with the same weights, its
    kernel launches per forward held to ``want_launches`` at
    ``dense_from_stage`` 2 and to ``want_launches_df4`` at 4."""
    want = {"voxelizer_dropped": voxel_run["counters"]["voxelizer_dropped"],
            **{k: plan_counters[k] for k in ("stage0_columns_dropped",
                                             "stage1_columns_dropped",
                                             "stage2_columns_dropped")}}
    cfg_c = cfg.replace(sparse_backend="column")
    model, _ = create_second(cfg_c, device=dev, state_dict=sd)     # strict load
    run = end_to_end_phase(model, anchors, points, num, want_launches, want)
    del model
    model4, _ = create_second(cfg_c.replace(dense_from_stage=4), device=dev, state_dict=sd)
    want4 = {"voxelizer_dropped": want["voxelizer_dropped"], **plan_counters}
    det4, launches4, counters4 = counted_forward(model4, anchors, points, num,
                                                 want_launches_df4, want4)
    run.update(launches_df4=launches4, counters_df4=counters4,
               valid_df4=int(det4.valid.sum()),
               vs_voxel=compare_backends(run["det"], voxel_run["det"]),
               df4_vs_df2=compare_backends(det4, run["det"]))
    cmp = run["vs_voxel"]
    n = max(cmp["n_a"], cmp["n_b"], 1)
    check(max(cmp["unmatched_a"], cmp["unmatched_b"]) <= BACKENDS_MAX_UNMATCHED * n
          and cmp["box_delta"] <= BACKENDS_MAX_BOX
          and cmp["score_delta"] <= BACKENDS_MAX_SCORE,
          f"column and voxel backends disagree: {cmp}")
    return run


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


def reference_phase(sd, dev, backend):
    """Phase 4: small geometry, float32, trained weights: card vs CPU on
    the ``backend`` representation. Called under ``full_float32()``: the
    card's f32 convs and matmuls are full float32 like the CPU's."""
    cfg = small_geometry_cfg().replace(sparse_backend=backend)
    pts, num = crop_to_grid(cfg, kitti_like_batch(1, 2, 60000)[0])
    n = int(num[0])
    out = {}
    for d in (dev, torch.device("cpu")):
        model, anchors = create_second(cfg, device=d, state_dict=sd)
        zw.reset_launches()
        with torch.no_grad():
            det, diag = model.inference(torch.from_numpy(pts).to(d),
                                        torch.from_numpy(num).to(d), anchors)
        out[d.type] = (det, {k: int(v) for k, v in diag.items()})
        # float32: every z-window and column launch on the FMA route
        want = ({} if d.type == "cpu"
                else {"column_conv": 6, "column_conv.fma": 6, **epilogue_launches(cfg)}
                if backend == "column"
                else {"zwin_conv": 6, "zwin_conv.fma": 6, **epilogue_launches(cfg)})
        launched = {k: n for k, n in zw.LAUNCHES.items() if n}
        check(launched == want, f"reference check on {d.type}: launches {launched}, "
                                f"not {want}")
    (gd, gdiag), (cd, cdiag) = out["cuda"], out["cpu"]
    check(gdiag == cdiag, f"counters differ: card {gdiag} vs CPU {cdiag}")
    gv, cv = gd.valid.cpu(), cd.valid
    check(torch.equal(gv, cv), "valid detections differ between card and CPU")
    check(int(cv.sum()) > 0, "no detections in the reference check")
    box = float((gd.boxes.cpu() - cd.boxes)[cv].abs().max())
    score = float((gd.scores.cpu() - cd.scores)[cv].abs().max())
    # the AP cross-check yardstick (AP_r05_crosscheck.json)
    check(box <= 0.0077 and score <= 0.0008, f"box delta {box}, score delta {score}")
    return dict(backend=backend, points=n, detections=int(cv.sum()), box_delta=box,
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
                cfg.stage_voxel_capacity(si + 1), subm_kernel=(3, 3, 3))
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


def gather_gemm_bound_ms(b, n, m, c, cout, kd, hits, dtype):
    """Least time for one gather-GEMM: each input (feats, rulebook, weights)
    read once, the f32 output written once, 2*C*Cout flops per hit."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = (b * n * c * esize + b * m * kd * 4 + kd * c * cout * esize
              + b * m * cout * 4)
    return _bound(nbytes, 2 * c * cout * hits, dtype)


def train_kernel_phase(cfg, points, num, dev):
    """Phase 2b: B2 and B4/B5 against their plain versions at every shape
    of a training step; B2 on each route the widths allow (in bf16 the
    tensor-core route where ``route_of`` picks it, and the FMA route at
    every shape; in float32 the FMA route). Returns (gather_gemm rows,
    gather_rows rows)."""
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
               "C": c, "Cout": cout, "K": kd, "hits": hits,
               "route": route_of(torch.bfloat16, c, cout)}
        runs = [("bf16", torch.bfloat16, 2e-2, None), ("f32", torch.float32, 1e-4, None)]
        if row["route"] != "fma":
            runs.insert(1, ("bf16_fma", torch.bfloat16, 2e-2, "fma"))
        for tag, dtype, tol, route in runs:
            label = f"gather_gemm {name} {tag} ({route or route_of(dtype, c, cout)})"
            got = gather_gemm(feats, rb, w, dtype, route=route)
            torch.cuda.synchronize()
            ref = sp.conv_rulebook_apply(feats, rb, w, dtype)
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            check(torch.isfinite(got).all().item(), f"{label}: non-finite")
            check(scale > 0, f"{label}: the plain version is all zero")
            check(agrees(got, ref, tol), f"{label}: kernel disagrees with plain "
                                         f"version (max abs err {err}, scale {scale})")
            del got, ref
            ms = cuda_ms(lambda: gather_gemm(feats, rb, w, dtype, route=route), reps=10)
            row.update({f"{tag}_max_abs_err": err, f"{tag}_ref_scale": scale,
                        f"{tag}_ms": ms})
            if route is None:
                plain = cuda_ms(lambda: sp.conv_rulebook_apply(feats, rb, w, dtype),
                                reps=5, warmup=1)
                bound, by = gather_gemm_bound_ms(b, n, m, c, cout, kd, hits, dtype)
                row.update({f"{tag}_plain_ms": plain, f"{tag}_bound_ms": bound,
                            f"{tag}_bound_by": by})
        row.setdefault("bf16_fma_ms", row["bf16_ms"])
        print(f"gather_gemm {name} x{count}: B={b} N={n} M={m} K={kd} hits={hits} "
              f"bf16 {row['route']} {row['bf16_ms']:.4f} ms (fma "
              f"{row['bf16_fma_ms']:.4f}, plain {row['bf16_plain_ms']:.3f}, "
              f"bound {row['bf16_bound_ms']:.4f} {row['bf16_bound_by']}, "
              f"err {row['bf16_max_abs_err']:.3g}) | f32 fma {row['f32_ms']:.4f} ms "
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


class _GatedMax(torch.autograd.Function):
    """``x.amax(dim)`` whose backward splits the gradient evenly among the
    positions ``sel`` marks (``amax``'s own rule on its own maxima)."""

    @staticmethod
    def forward(ctx, x, dim, sel):
        ctx.save_for_backward(sel)
        ctx.dim = dim
        return x.amax(dim=dim)

    @staticmethod
    def backward(ctx, g):
        (sel,) = ctx.saved_tensors
        return g.unsqueeze(ctx.dim) * sel / sel.sum(ctx.dim, keepdim=True), None, None


@contextlib.contextmanager
def max_gates(gates, replay):
    """The group max-pools of the set abstraction (every ``Tensor.amax``
    over one dim of a tensor that takes gradient) with their selections
    explicit, in call order: recorded into ``gates`` as ``x == max``, or,
    with ``replay``, taken from ``gates``. A ReLU output that is 0 on one
    device and a float32 hair above it on the other turns a group's tie
    into a single maximum, and the gradient then goes to one point, not
    evenly to all; replaying the ReLU gates alone does not undo that. Yields
    a list that collects, per max-pool, how many selections differ."""
    orig, differ, calls = torch.Tensor.amax, [], iter(list(gates))

    def amax(self, dim=None, keepdim=False):
        if keepdim or not isinstance(dim, int) or not (torch.is_grad_enabled()
                                                      and self.requires_grad):
            return orig(self, dim, keepdim)
        own = self == orig(self, dim, True)
        if replay:
            sel = next(calls).to(self.device)
            differ.append(int((own != sel).sum()))
        else:
            sel = own
            gates.append(own.cpu())
        return _GatedMax.apply(self, dim, sel)

    torch.Tensor.amax = amax
    try:
        yield differ
    finally:
        torch.Tensor.amax = orig


@contextlib.contextmanager
def ball_groups(groups, replay):
    """Every ball query of the set abstraction (the sources' and the RoI
    grid pool's) with its groups explicit, in call order: recorded into
    ``groups`` as (indices, valid), or, with ``replay``, taken from
    ``groups``. A grid point that moves by a float32 hair (its proposal's
    deltas summed in another order) can take a keypoint at its radius in or
    out of a group. Yields a list that collects, per query, how many group
    entries differ from the replayed ones."""
    orig, differ, calls = tpointnet.ball_query, [], iter(list(groups))

    def query(*args, **kwargs):
        idx, valid = orig(*args, **kwargs)
        if replay:
            ridx, rvalid = (t.to(idx.device) for t in next(calls))
            differ.append(int(((idx != ridx) | (valid != rvalid)).sum()))
            return ridx, rvalid
        groups.append((idx.cpu(), valid.cpu()))
        return idx, valid

    tpointnet.ball_query = query
    try:
        yield differ
    finally:
        tpointnet.ball_query = orig


def launches_at(name, rows, count, dtype, times):
    """The launches of kernel ``name`` that ``times`` runs of the ``rows``
    shapes give at ``dtype``, in all and per route (``route_of``'s rule)."""
    want = {f"{name}.{r}": 0 for r in kernels.ROUTES[name]}
    for r in rows:
        want[f"{name}.{route_of(dtype, r['C'], r['Cout'])}"] += r[count] * times
    want[name] = sum(r[count] for r in rows) * times
    return want


def labels_sha256(root, inds):
    digest = hashlib.sha256()
    for i in inds:
        digest.update((root / "training" / "label_2" / f"{i:06d}.txt").read_bytes())
    return digest.hexdigest()


def counted(fn, want):
    """``fn()`` with the launch counts set to 0 just before and read just
    after; every kernel must have launched as ``want`` says (absent: 0).
    Returns (fn's result, the launches)."""
    zw.reset_launches()
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(zw.LAUNCHES)
    for name, n in launches.items():
        check(n == want.get(name, 0), f"{name} launched {n} times, not "
                                      f"{want.get(name, 0)}: all {launches}")
    return out, launches


def synthetic_set(tmp, golden):
    """Phase 7's synthetic KITTI-format set (GOLDEN's command) under
    ``tmp``: (val frame indices, the CLIs' data arguments)."""
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_synthetic_kitti.py"),
                    "--out", str(tmp), *golden["generator_args"]], check=True,
                   capture_output=True)
    val = np.loadtxt(tmp / "splitfiles" / "val.txt", dtype=np.int64).tolist()
    return val, ["--config", str(CONFIG), "--data-root", str(tmp / "training"),
                 "--split-dir", str(tmp / "splitfiles"), "--cache-dir", str(tmp / "cache")]


def cli_phase(cfg, shapes, gg_rows, gr_rows):
    """Phase 7: the command-line entry points on a synthetic KITTI-format
    set written by tools/make_synthetic_kitti.py (GOLDEN's command):
    train_cli for one epoch from a fresh init and one more by --resume,
    eval_cli on that checkpoint and on the trained weights (float32, TF32
    off; AP held against the JAX package's table on the same frames), and
    inference_cli's BEV image of one frame from the checkpoint."""
    from vision3d_tpu_torch import eval_cli, inference_cli, train_cli

    golden = json.loads(GOLDEN.read_text())
    dtype = getattr(torch, cfg.compute_dtype)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        val, data = synthetic_set(tmp, golden)
        check(labels_sha256(tmp, val) == golden["val_labels_sha256"],
              "the synthetic set's val labels differ from those of the golden")
        train = data + ["--batch-size", str(BATCH), "--workers", "2",
                        "--ckpt-dir", str(tmp / "ckpts"),
                        "--metrics-jsonl", str(tmp / "metrics.jsonl")]

        steps = 16 // BATCH
        want_step = {"gather_rows": sum(r["launches_per_step"] for r in gr_rows) * steps,
                     **launches_at("gather_gemm", gg_rows, "launches_per_step", dtype, steps)}
        first, out["train_launches"] = counted(
            lambda: train_cli.main(train + ["--epochs", "1"]), want_step)
        resumed, _ = counted(
            lambda: train_cli.main(train + ["--epochs", "2", "--resume"]), want_step)
        check([r["epoch"] for r in first] == [0] and [r["epoch"] for r in resumed] == [1],
              f"epochs run: {[r['epoch'] for r in first]}, then "
              f"{[r['epoch'] for r in resumed]} after --resume")
        for rec in first + resumed:
            check(rec["steps"] == steps and all(np.isfinite(rec["losses"])),
                  f"train_cli epoch {rec['epoch']}: {rec}")
            check(rec["checkpoint"] and Path(rec["checkpoint"]).is_file(),
                  f"no checkpoint after epoch {rec['epoch']}")
        ckpt = resumed[0]["checkpoint"]
        check(torch.load(ckpt, weights_only=True)["step"] == 2 * steps,
              "the resumed run did not continue the step count")
        out["train"] = [{k: rec[k] for k in ("epoch", "seconds", "frames_per_s",
                                             "host_wait_s", "losses")}
                        for rec in first + resumed]

        batches = -(-len(val) // BATCH)
        want_eval = {**launches_at("zwin_conv", shapes, "launches_per_forward", dtype, batches),
                     **epilogue_launches(cfg, batches)}
        (table_ckpt, timing_ckpt), out["eval_launches"] = counted(
            lambda: eval_cli.main(data + ["--ckpt", ckpt, "--out-json",
                                          str(tmp / "ap_ckpt.json")]), want_eval)
        check(all(np.isfinite(v) for row in table_ckpt.values() for v in row.values()),
              f"eval_cli on the checkpoint: {table_ckpt}")
        with full_float32():
            (table, timing), _ = counted(
                lambda: eval_cli.main(data + ["--weights", str(WEIGHTS)]), want_eval)
        check(timing["frames"] == len(val), f"eval_cli evaluated {timing['frames']} frames")
        gaps = {f"{c}/{k}": abs(table[int(c)][k] - v)
                for c, row in golden["table"].items() for k, v in row.items()}
        check(len(gaps) == 9 and max(gaps.values()) <= AP_GATE,
              f"AP differs from the JAX golden by more than {AP_GATE}: port {table}, "
              f"JAX {golden['table']}")
        out.update(table_ckpt=table_ckpt, eval_ckpt=timing_ckpt, table=table,
                   eval=timing, ap_gaps=gaps)

        png = tmp / "bev.png"
        want_one = {**launches_at("zwin_conv", shapes, "launches_per_forward", dtype, 1),
                    **epilogue_launches(cfg)}
        printed = io.StringIO()     # one line per detection of a 4-step model
        with contextlib.redirect_stdout(printed):
            dets, out["inference_launches"] = counted(
                lambda: inference_cli.main(
                    ["--config", str(CONFIG), "--ckpt", ckpt, "--velo",
                     str(tmp / "training" / "velodyne" / f"{val[0]:06d}.bin"),
                     "--out", str(png)]), want_one)
        check(printed.getvalue().count("class=") == len(dets["boxes"]),
              "inference_cli printed another number of detections than it found")
        check(png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", "no PNG written")
        out["inference_detections"] = len(dets["boxes"])
        out["bev_png_bytes"] = png.stat().st_size
    return out


def pvrcnn_cfg(cfg):
    """Phase 8's config: ``cfg`` with every class's score threshold 0."""
    return cfg.replace(anchors=tuple(dataclasses.replace(a, score_thresh=0.0)
                                     for a in cfg.anchors))


def calibrate_bn(model, points, num, anchors):
    """Every batch norm's running statistics set to those of one two-stage
    forward on (points, num): train mode with momentum 1, no gradients.
    PV-RCNN's grid points are drawn from a CPU generator seeded 0."""
    bns = [m for m in model.modules()
           if isinstance(m, (MaskedBatchNorm, torch.nn.modules.batchnorm._BatchNorm))]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    model.train()
    kw = {} if isinstance(model, VoxelRCNN) else dict(generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.two_stage(points, num, anchors, **kw)
    model.eval()
    for m, mom in zip(bns, saved):
        m.momentum = mom


def pvrcnn_stages(model, anchors, points, num, generator):
    """One two-stage forward of ``model`` run stage by stage as
    ``PV_RCNN.inference_two_stage`` runs it, each stage ended by a
    synchronise on the card: (host-clock ms per stage, intermediates)."""
    cfg = model.cfg
    ms = {}

    def stage(name, fn):
        if points.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if points.is_cuda:
            torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0)
        return out

    mask = point_mask(points, num)
    kp, kp_idx = stage("fps", lambda: sample_keypoints(points[..., :3], mask,
                                                       cfg.num_keypoints))

    def voxelize():
        vox = voxelize_batch(points, num, cfg)
        return (vox, *build_middle_input(cfg, vox))

    vox, st, col_dropped = stage("voxelize", voxelize)
    bev, cnn_diag, scales = stage("cnn", lambda: model.cnn(st, need_scales=True))

    def rpn_head():
        x = model.rpn(bev.permute(0, 3, 1, 2).float())
        return (x,) + tuple(model.head(x))

    x, cls_map, reg_map = stage("rpn_head", rpn_head)
    sources = [(points[..., :3], points[..., 3:4], mask)]
    feats = [stage("sa_source0", lambda: model.pnets[0](*sources[0], kp))]
    for i, (sc, stride) in enumerate(zip(scales, cfg.strides), start=1):
        def sa(i=i, sc=sc, stride=stride):
            sources.append(to_global(sc, cfg, stride))
            return model.pnets[i](*sources[i], kp)
        feats.append(stage(f"sa_source{i}", sa))
    feats.append(stage("bev_gather", lambda: bev_bilinear_gather(
        x.permute(0, 2, 3, 1), kp[..., :2], cfg)))
    pf = torch.cat(feats, dim=-1)
    boxes, scores = stage("proposal_decode", lambda: decode_proposals(
        cls_map, reg_map, anchors, cfg))
    b = boxes.shape[0]
    proposals, prop_scores = boxes.reshape(b, -1, cfg.box_dof), scores.reshape(b, -1)

    def weighting():
        seg = model.keypoint_seg(pf)
        return pf * (1.0 - torch.softmax(seg, dim=-1)[..., -1:])

    weighted = stage("keypoint_seg", weighting)
    kp_mask = torch.ones(kp.shape[:2], dtype=torch.bool, device=kp.device)
    pooled = stage("roi_grid_pool", lambda: model.roi_grid_pool(
        proposals, kp, weighted, kp_mask, generator=generator))
    deltas, logits = stage("refinement", lambda: model.refinement(pooled))

    def nms():
        refined = apply_refinements(deltas, proposals)
        conf = torch.sigmoid(logits) * prop_scores
        k = cfg.proposal.topk
        return refined, conf, multiclass_nms(refined.reshape(b, cfg.num_classes, k, 7),
                                             conf.reshape(b, cfg.num_classes, k), cfg)

    refined, conf, det = stage("nms", nms)
    diag = {k: int(v.sum()) for k, v in cnn_diag.items()}
    diag["voxelizer_dropped"] = int((vox["num_voxels_total"] - vox["num_voxels"]).sum())
    if col_dropped is not None:
        diag["stage0_columns_dropped"] = int(col_dropped.sum())
    return ms, dict(keypoint_idx=kp_idx, keypoints=kp, sources=sources,
                    point_features=pf, proposals=proposals, refined=refined,
                    conf=conf, det=det, diag=diag)


def check_counters(diag, where):
    for k, v in diag.items():
        if k != "voxelizer_dropped":
            check(int(v) == 0, f"{where}: capacity counter {k} = {int(v)}")


def pvrcnn_phase(cfg, dev, want, state_dict=None, profile=True):
    """Phases 8a and 11a: PV-RCNN at full width on the card, every forward
    launching as ``want`` says (the trunk's kernels) and a two-stage one
    also BALL_QUERIES["pvrcnn2"] ball queries. Without ``state_dict`` the
    weights are ``init_pvrcnn`` seed 0 with one batch's BN statistics, and
    the result carries them ("state_dict", on the CPU). ``profile`` adds the
    synchronised stage split and the ball queries at the forward's shapes
    (``ball_query_rows``)."""
    cfg = pvrcnn_cfg(cfg)
    want2 = {**want, **point_launches("pvrcnn2")}
    model, anchors = create_pvrcnn(cfg, device=dev, state_dict=state_dict)
    pts, num = kitti_like_batch(0, BATCH, POINTS)
    points, num_t = torch.from_numpy(pts).to(dev), torch.from_numpy(num).to(dev)
    if state_dict is None:
        calibrate_bn(model, points, num_t, anchors)
    gen = lambda: torch.Generator().manual_seed(0)     # noqa: E731
    with torch.no_grad():
        (det1, diag1), l1 = counted(lambda: model.inference(points, num_t, anchors), want)
        (det2, diag2), l2 = counted(lambda: model.inference_two_stage(
            points, num_t, anchors, generator=gen()), want2)
        (ms, inter), l3 = counted(lambda: pvrcnn_stages(model, anchors, points, num_t,
                                                        gen()), want2)
    check_counters(diag1, "pvrcnn inference")
    check_counters(diag2, "pvrcnn inference_two_stage")
    check_counters(inter["diag"], "pvrcnn stage split")
    k = cfg.num_keypoints
    distinct = [len(torch.unique(r)) for r in inter["keypoint_idx"]]
    check(distinct == [k] * BATCH, f"distinct keypoints per frame {distinct}")
    pf = inter["point_features"]
    check(tuple(pf.shape) == (BATCH, k, 384 + cfg.proposal.c_in)
          and bool(torch.isfinite(pf).all()), f"point features {tuple(pf.shape)}")
    for name, det in (("inference", det1), ("inference_two_stage", det2)):
        for f, t in det._asdict().items():
            if t.is_floating_point():
                check(bool(torch.isfinite(t).all()), f"pvrcnn {name}: non-finite {f}")
        check(int(det.valid.sum()) > 0, f"pvrcnn {name}: no valid detection")
    # the stage split runs the model's own path
    check(torch.equal(inter["det"].valid, det2.valid)
          and agrees(inter["det"].boxes[det2.valid], det2.boxes[det2.valid], 1e-5),
          "the stage split's detections differ from inference_two_stage's")

    def p50(fn):
        times = []
        with torch.no_grad():
            for i in range(13):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if i >= 3:
                    times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times)), times

    one_p50, _ = p50(lambda: model.inference(points, num_t, anchors))
    torch.cuda.reset_peak_memory_stats()
    two_p50, two_times = p50(lambda: model.inference_two_stage(points, num_t, anchors,
                                                               generator=gen()))
    peak = int(torch.cuda.max_memory_allocated())
    out = dict(launches=l2, launches_one_stage=l1,
               valid_one_stage=det1.valid.sum(1).tolist(),
               valid_two_stage=det2.valid.sum(1).tolist(),
               counters={k_: int(v) for k_, v in diag2.items()},
               p50_one_stage_ms=one_p50, p50_two_stage_ms=two_p50,
               two_stage_ms=[float(t) for t in two_times], peak_mem_bytes=peak)
    if state_dict is None:
        out["state_dict"] = {k_: v.cpu() for k_, v in model.state_dict().items()}
    if not profile:
        return out
    with torch.no_grad():
        split = [pvrcnn_stages(model, anchors, points, num_t, gen()) for _ in range(4)]
    split_ms = {k_: float(np.median([s[0][k_] for s in split[1:]])) for k_ in split[0][0]}
    inter = split[-1][1]
    del split
    with torch.no_grad():
        rows = ball_query_phase(model, inter, gen())
    return dict(out, ball_query_rows=rows, stage_ms=split_ms,
                stage_sum_ms=float(sum(split_ms.values())))


def ball_query_bound_ms(src_mask, idx, valid):
    """The least time of one query: the larger of its pair tests at the
    float32 peak (9 operations a pair: three differences, three products,
    two sums, a compare) and its bytes (each source row's 12 + 1 and each
    centre's 12 bytes read once, every group entry's 8 + 1 written once)
    at the card's bandwidth. A centre needs the pairs with the masked-in
    rows up to its nsample-th hit, or all of them when its ball never
    fills (the group's last index repeats its first, unless nsample is 1).
    Returns (ms, pairs, bound by)."""
    b, n = src_mask.shape
    _, m, s = idx.shape
    seen = torch.cat([torch.zeros((b, 1), dtype=torch.int64, device=src_mask.device),
                      src_mask.long().cumsum(1)], dim=1)       # masked-in rows before i
    full = (idx[..., -1] > idx[..., 0]) if s > 1 else valid[..., 0]
    upto = torch.where(full, idx[..., -1] + 1, n)
    pairs = int(torch.gather(seen, 1, upto).sum())
    ops_s = 9 * pairs / F32_FLOP_PER_S
    bytes_s = (b * n * 13 + b * m * 12 + b * m * s * 9) / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), pairs, "operations" if ops_s >= bytes_s else "bytes"


def ball_query_phase(model, inter, generator):
    """Phase 8a's ball queries at the forward's own shapes: the ten of the
    set abstraction (each source's rows and mask, the keypoints, both
    radii) and the RoI grid pool's two (the keypoints, the grid points
    drawn from ``generator`` as the forward drew them). Each kernel result
    must equal the plain version's on the same card tensors, and the
    kernel run again with one in-ball source masked out (the first group
    entry of the first non-empty ball) must not. Per query: CUDA-event
    medians of kernel and plain, the bound, the pairs it needs."""
    cfg = model.cfg
    kp = inter["keypoints"]
    b = kp.shape[0]
    grid = sample_gridpoints(inter["proposals"], cfg.gridpool.num_gridpoints,
                             generator=generator).reshape(b, -1, 3).contiguous()
    queries = [(f"source{i}", xyz.contiguous(), msk.contiguous(), kp, pnet)
               for i, ((xyz, _, msk), pnet) in enumerate(zip(inter["sources"], model.pnets))]
    queries.append(("grid_pool", kp, torch.ones(kp.shape[:2], dtype=torch.bool,
                                                device=kp.device), grid, model.roi_grid_pool.sa))
    rows = []
    for name, xyz, msk, ctr, sa in queries:
        for r, s in zip(sa.radii, sa.nsamples):
            got = ball_query(xyz, msk, ctr, r, s)
            ref = ball_query_plain(xyz, msk, ctr, r, s)
            check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                  f"ball_query {name} r {r}: the kernel differs from the plain version")
            nonempty = ref[1][..., 0].nonzero()
            check(len(nonempty) > 0, f"ball_query {name} r {r}: every ball is empty")
            frame, centre = (int(i) for i in nonempty[0])
            broken_mask = msk.clone()
            broken_mask[frame, ref[0][frame, centre, 0]] = False
            broken = ball_query(xyz, broken_mask, ctr, r, s)
            check(not (torch.equal(broken[0], ref[0]) and torch.equal(broken[1], ref[1])),
                  f"ball_query {name} r {r}: a source dropped from a ball passed the check")
            bound, pairs, by = ball_query_bound_ms(msk, *got)
            rows.append(dict(query=f"{name} r {r}", B=b, N=int(xyz.shape[1]),
                             active=int(msk.sum()), M=int(ctr.shape[1]), S=s,
                             full_share=float((got[0][..., -1] > got[0][..., 0]).float().mean()),
                             pairs=pairs, bound_ms=bound, bound_by=by,
                             ms=cuda_ms(lambda: ball_query(xyz, msk, ctr, r, s)),
                             plain_ms=cuda_ms(lambda: ball_query_plain(xyz, msk, ctr, r, s),
                                              reps=3, warmup=1)))
    return rows


def fps_bound_ms(mask, k):
    """The least time of one sampling: the larger of its distances' six
    conversions between float32 and float64 each (every valid point
    against each of the K - 1 centres) at CVT_PER_S, and its bytes (each
    point's 12 + 1 read once, the indices written once) at the card's
    bandwidth. Returns (ms, bound by)."""
    b, n = mask.shape
    cvt_s = 6 * (k - 1) * int(mask.sum()) / CVT_PER_S
    bytes_s = (b * n * 13 + b * k * 8) / HBM_BYTES_PER_S
    return 1e3 * max(cvt_s, bytes_s), "conversions" if cvt_s >= bytes_s else "bytes"


def fps_phase(dev, k=2048):
    """Phase 8d: K3 (``ops/fps.furthest_point_sample`` on the card) at the
    benchmark cell's shape, phase 8's batch (B 8 x 18,000 points, all
    valid) and K 2,048, then the same clouds with every other frame's last
    tenth masked out: each equal to the plain version on the same card
    tensors, and the kernel run again with one taken point masked out,
    which must differ. Per case: CUDA-event medians of kernel and plain,
    the host's time to enqueue one call, the bound, the route and cluster
    size (``ops/fps.plan``)."""
    pts, _ = kitti_like_batch(0, BATCH, POINTS)
    xyz = torch.from_numpy(np.ascontiguousarray(pts[..., :3])).to(dev)
    full = torch.ones((BATCH, POINTS), dtype=torch.bool, device=dev)
    tails = full.clone()
    tails[1::2, POINTS - POINTS // 10:] = False
    rows = []
    for name, mask in (("all valid", full), ("padded tails", tails)):
        got = furthest_point_sample(xyz, mask, k)
        ref = furthest_point_sample_plain(xyz, mask, k)
        check(torch.equal(got, ref), f"fps {name}: the kernel differs from the plain version")
        broken_mask = mask.clone()
        broken_mask[0, ref[0, k // 2]] = False
        check(not torch.equal(furthest_point_sample(xyz, broken_mask, k), ref),
              f"fps {name}: a taken point masked out passed the check")
        route, cluster = fps_plan(BATCH, POINTS, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            furthest_point_sample(xyz, mask, k)
        host_ms = 1e3 * (time.perf_counter() - t0) / 10
        torch.cuda.synchronize()
        bound, by = fps_bound_ms(mask, k)
        rows.append(dict(case=name, B=BATCH, N=POINTS, valid=int(mask.sum()), K=k,
                         route=route, cluster=cluster, bound_ms=bound, bound_by=by,
                         host_ms=host_ms,
                         ms=cuda_ms(lambda: furthest_point_sample(xyz, mask, k)),
                         plain_ms=cuda_ms(lambda: furthest_point_sample_plain(xyz, mask, k),
                                          reps=3, warmup=1)))
    return rows


def print_fps(rows):
    """Phase 8d's lines."""
    for r in rows:
        print(f"fps {r['case']} (B {r['B']}, N {r['N']}, {r['valid']} valid, K {r['K']}; "
              f"route {r['route']}, cluster {r['cluster']}): equal to the plain version, a "
              f"masked-out point caught; kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
              f"ms, enqueue {r['host_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)


def voxel_query_bound_ms(vmap, grid, points, lo, step, ranges, radius, nsample, voxels):
    """The least time of one voxel query: the larger of its distance tests
    at the float32 peak (8 operations a test: three differences, three
    products, two sums; a scan tests the occupied in-grid cells of its
    window up to its nsample-th hit, all of them when its ball never
    fills) and its bytes (each grid point's xyz and cell, 24 bytes, and
    each occupied voxel's centre, 12, read once; the rows written once) at
    the card's bandwidth. Returns (ms, tests, bound by)."""
    d, h, w = grid
    b, g, _ = points.shape
    dev = points.device
    off = vq.window(ranges, dev)
    cells = vq.grid_cells(points, lo, step, grid)
    dims = torch.tensor([w, h, d], device=dev)
    base = torch.arange(b, device=dev)[:, None, None] * (d * h * w)
    lo_t, step_t = torch.from_numpy(lo).to(dev), torch.from_numpy(step).to(dev)
    tests, chunk = 0, 4096
    for c0 in range(0, g, chunk):
        nb = cells[:, c0:c0 + chunk, None, :] + off                       # (B, C, T, 3)
        inside = ((nb >= 0) & (nb < dims)).all(-1)
        flat = ((nb[..., 2] * h + nb[..., 1]) * w + nb[..., 0]) + base
        occupied = vmap[torch.where(inside, flat, vmap.numel() - 1)] >= 0
        diff = (nb.float() + 0.5) * step_t + lo_t - points[:, c0:c0 + chunk, None, :]
        hit = (occupied & ((diff * diff).sum(-1) <= vq._r2(radius))).int()
        tests += int((occupied & (hit.cumsum(2) - hit < nsample)).sum())
    ops_s = 8 * tests / F32_FLOP_PER_S
    bytes_s = (b * g * (24 + 4 * nsample) + voxels * 12) / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), tests, "operations" if ops_s >= bytes_s else "bytes"


def embed_333_check(model, st):
    """The (3, 1, 1) strided conv of ``VoxelBackBone8x`` (``conv_out``) on
    the card, where ``zwin_conv`` runs it inside a (3, 3, 3) rulebook
    (``embed_333``): on the stage's own rulebook, features and weight, in
    bf16 against the plain version within 2e-2 of its scale (phase 2's
    gate), and a weight with its centre tap zeroed must fail the same
    gate. Returns the row of times and errors."""
    cfg = model.cfg
    si = len(model.cnn.block_specs()) - 1
    spec = model.cnn.block_specs()[si][1]
    w = model.cnn.down[si].weight.detach()
    kernel = spec["kernel"]
    _, rbd, _, _, _ = sp.plan_stage_batched(
        st.keys, st.mask, st.grid, kernel, spec["stride"], spec["pad"],
        cfg.stage_voxel_capacity(si + 1),
        subm_kernel=(3, 3, 3), subm_col_cap=cfg.stage_column_capacity(si),
        down_col_cap=cfg.stage_column_capacity(si + 1))
    start, pattern = rbd
    feats = st.feats.float()
    dt = torch.bfloat16
    got = zw.zwin_conv(feats, start, pattern, w, kernel, dt)
    ref = sp.conv_zwin_apply(feats, start, pattern, w, kernel, dt)
    scale = float(ref.abs().max())
    check(scale > 0 and agrees(got, ref, 2e-2),
          f"zwin_conv (3, 1, 1) through embed_333: kernel disagrees with the plain version "
          f"(max abs err {float((got - ref).abs().max())}, scale {scale})")
    c = feats.shape[-1]
    broken_w = w.clone()
    broken_w[c:2 * c] = 0                                   # the centre tap, dz 0
    broken = zw.zwin_conv(feats, start, pattern, broken_w, kernel, dt)
    check(not agrees(broken, ref, 2e-2),
          "zwin_conv (3, 1, 1) through embed_333: a zeroed tap passed the check")
    b, n = st.keys.shape
    return dict(shape=f"s3_down_{c}x{w.shape[1]} (3, 1, 1)", B=b, N=n,
                M=start.shape[1] // (kernel[1] * kernel[2]),
                max_abs_err=float((got - ref).abs().max()), ref_scale=scale,
                ms=cuda_ms(lambda: zw.zwin_conv(feats, start, pattern, w, kernel, dt)),
                plain_ms=cuda_ms(lambda: sp.conv_zwin_apply(feats, start, pattern, w, kernel,
                                                            dt), reps=5))


def voxel_rcnn_phase(dev):
    """Phase 13: Voxel R-CNN (``models/voxel_rcnn.py``) at the benchmark
    cell's configuration (car.yaml's geometry and anchors, bf16, batch 8 x
    18,000 points, 100 RoIs a frame), from ``init_voxel_rcnn`` seed 0 with
    one batch's BN statistics: a two-stage forward launching as
    VOXEL_RCNN_LAUNCHES says, finite outputs; no stage dropping a site on
    VOXEL_RCNN_BATCHES batches (``dense_from_stage`` 4); on the forward's
    own scales and grid points, the voxel query kernel (K2) equal to its
    plain version on the same card tensors, and again with one taken voxel
    dropped from the map, which must fail; kernel and plain CUDA-event
    medians, the bound, per scale; the (3, 1, 1) conv through
    ``embed_333`` (``embed_333_check``); the p50 of 10 forwards after 3
    warm-ups and the peak memory."""
    cfg = voxel_rcnn_config(Config.from_yaml(str(CAR_CONFIG)).replace(
        compute_dtype="bfloat16"))
    v = cfg.voxel_rcnn
    model, anchors = create_voxel_rcnn(cfg, device=dev)
    batches = [kitti_like_batch(i, BATCH, POINTS) for i in range(VOXEL_RCNN_BATCHES)]
    batches = [(torch.from_numpy(p).to(dev), torch.from_numpy(n).to(dev)) for p, n in batches]
    points, num_t = batches[0]
    calibrate_bn(model, points, num_t, anchors)
    with torch.no_grad():
        want = {**VOXEL_RCNN_LAUNCHES, **epilogue_launches(cfg)}
        (det, diag), launches = counted(
            lambda: model.inference_two_stage(points, num_t, anchors), want)
        (out, _), _ = counted(lambda: model.two_stage(points, num_t, anchors), want)
        *_, scales = model.trunk(points, num_t, need_scales=True)
        dropped = {}
        for i, (p, n) in enumerate(batches):
            _, _, _, d, _ = model.trunk(p, n, need_scales=False)
            dropped[i] = {k: int(c) for k, c in d.items() if k.endswith("dropped")
                          and k != "voxelizer_dropped"}
            check(not any(dropped[i].values()), f"voxel_rcnn batch {i}: dropped {dropped[i]}")
    for f, t in det._asdict().items():
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()), f"voxel_rcnn: non-finite {f}")
    check(tuple(out["rois"].shape) == (BATCH, cfg.proposal.topk, 7),
          f"voxel_rcnn RoIs {tuple(out['rois'].shape)}")
    grid = roi_grid_points(out["rois"], v.grid_size).reshape(BATCH, -1, 3).contiguous()
    rows = []
    with torch.no_grad():
        for k, si in enumerate(v.scales):
            st = scales[si]
            lo, step = vq.geometry(cfg.voxel_size, cfg.grid_bounds, cfg.strides[si])
            vmap = vq.row_map(st.keys, st.mask, st.grid)
            query = (st.grid, grid, lo, step, v.query_range, v.pool_radius[k], v.nsample)
            got = vq.voxel_query(vmap, *query)
            want = vq.voxel_query_plain(vmap, *query)
            check(torch.equal(got, want), f"voxel_query scale {si}: the kernel differs from "
                                          f"the plain version")
            check(torch.equal(got, out["rows"][k]), f"voxel_query scale {si}: the forward's "
                                                    f"rows differ")
            nonempty = (want[..., 0] >= 0).nonzero()
            check(len(nonempty) > 0, f"voxel_query scale {si}: every ball is empty")
            frame, point = (int(i) for i in nonempty[0])
            cells = int(np.prod(st.grid))
            at = (vmap[frame * cells:(frame + 1) * cells] == want[frame, point, 0]).nonzero()
            broken_map = vmap.clone()
            broken_map[frame * cells + int(at[0])] = -1
            check(not torch.equal(vq.voxel_query(broken_map, *query), want),
                  f"voxel_query scale {si}: a voxel dropped from a ball passed the check")
            voxels = int(st.mask.sum())
            bound, tests, by = voxel_query_bound_ms(vmap, *query, voxels)
            rows.append(dict(
                query=f"scale {si} r {v.pool_radius[k]}", stride=cfg.strides[si],
                grid=list(st.grid), voxels=voxels, G=int(grid.shape[1]), S=v.nsample,
                empty_share=float((got[..., 0] < 0).float().mean()),
                full_share=float((got[..., -1] != got[..., 0]).float().mean()),
                tests=tests, bound_ms=bound, bound_by=by,
                ms=cuda_ms(lambda: vq.voxel_query(vmap, *query)),
                plain_ms=cuda_ms(lambda: vq.voxel_query_plain(vmap, *query), reps=3, warmup=1),
                row_map_ms=cuda_ms(lambda: vq.row_map(st.keys, st.mask, st.grid))))
            del vmap, got, want, broken_map
        embed = embed_333_check(model, scales[3])
    del scales
    times = []
    with torch.no_grad():
        for i in range(13):
            if i == 3:
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.inference_two_stage(points, num_t, anchors)
            torch.cuda.synchronize()
            if i >= 3:
                times.append(1e3 * (time.perf_counter() - t0))
    return dict(rois=cfg.proposal.topk, launches=launches,
                counters={k: int(c) for k, c in diag.items()},
                dropped=dropped, valid_per_frame=det.valid.sum(1).tolist(),
                voxel_query_rows=rows, embed_333=embed, p50_ms=float(np.median(times)),
                peak_mem_bytes=int(torch.cuda.max_memory_allocated()))


def bn_relu_bound_ms(rows, active, c, in_bytes, out_bytes):
    """The least time of one epilogue on the H100: the site bytes and the
    active rows read once (K4 reads no row whose site is off), every row
    written once, over 3.35 TB/s; and the same with every row read
    ("full")."""
    written = rows * c * out_bytes
    return (1e3 * (rows + active * c * in_bytes + written) / HBM_BYTES_PER_S,
            1e3 * (rows + rows * c * in_bytes + written) / HBM_BYTES_PER_S)


def bn_relu_phase(dev):
    """Phase 14: kernel K4 (``ops/bn_relu``) at the epilogues of one SECOND
    forward at the benchmark cell second-car-infer-b8's configuration
    (configs/second/car.yaml, bf16, batch 8 x 18,000 points, fresh seeded
    init): each epilogue's input shape, strides and dtypes and the
    forward's own site mask, recorded in the forward (14 epilogues: 6 on
    B1's float32 output, then the dense stages 2 and 3 on cuDNN's bf16
    output, in place); K4 on a seeded input of each against
    ``bn_relu_plain`` on the same card tensors, bit for bit; CUDA-event
    medians of K4 and of the plain chain, and the bound, per epilogue."""
    from vision3d_tpu_torch.ops import bn_relu as ep

    cfg = Config.from_yaml(str(CAR_CONFIG)).replace(compute_dtype="bfloat16")
    model, anchors = create_second(cfg, device=dev)
    pts, num = kitti_like_batch(0, BATCH, POINTS)
    calls, launch = [], ep.bn_relu

    def record(x, site, mean, var, weight, bias, eps, channel_dim=-1, dtype=torch.float32):
        calls.append(dict(shape=tuple(x.shape), stride=x.stride(), dtype=x.dtype,
                          site=site.clone(), channel_dim=channel_dim, out=dtype, eps=eps))
        return launch(x, site, mean, var, weight, bias, eps, channel_dim, dtype)

    ep.bn_relu = record
    try:
        with torch.no_grad():
            model.inference(torch.from_numpy(pts).to(dev), torch.from_numpy(num).to(dev),
                            anchors)
    finally:
        ep.bn_relu = launch
    del model
    blocks = [(si, kind) for si, (chans, _) in enumerate(SpMiddleFHD(cfg).block_specs())
              for kind in ["subm"] * len(chans) + ["down"]]
    check(len(calls) == len(blocks) == 14, f"{len(calls)} epilogues recorded in a forward")
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}
    rows = []
    for i, ((si, kind), cl) in enumerate(zip(blocks, calls)):
        gen = torch.Generator(device=dev).manual_seed(i)
        cd, site = cl["channel_dim"], cl["site"]
        c = cl["shape"][cd]
        x = torch.empty_strided(cl["shape"], cl["stride"], dtype=cl["dtype"], device=dev)
        x.normal_(0.0, 3.0, generator=gen)
        stats = [torch.randn(c, generator=gen, device=dev),
                 torch.rand(c, generator=gen, device=dev) * 4 + 0.05,
                 torch.randn(c, generator=gen, device=dev),
                 torch.randn(c, generator=gen, device=dev)]
        args = (site, *stats, cl["eps"], cd, cl["out"])
        want = ep.bn_relu_plain(x, *args)
        got = ep.bn_relu(x.clone(memory_format=torch.preserve_format), *args)
        bits = torch.int16 if cl["out"] == torch.bfloat16 else torch.int32
        check(torch.equal(got.view(bits), want.view(bits)),
              f"bn_relu epilogue {i}: K4 differs from the plain chain")
        del want, got
        buf = x.clone(memory_format=torch.preserve_format)
        ms = cuda_ms(lambda: ep.bn_relu(buf, *args))
        plain_ms = cuda_ms(lambda: ep.bn_relu_plain(x, *args), reps=5, warmup=1)
        n, active = site.numel(), int(site.sum())
        bound, full = bn_relu_bound_ms(n, active, c, x.element_size(),
                                       torch.finfo(cl["out"]).bits // 8)
        rows.append(dict(epilogue=i, stage=si, conv=kind, shape=list(cl["shape"]),
                         rows=n, active=active, C=c, dtype=names[cl["dtype"]],
                         out=names[cl["out"]], in_place=cl["dtype"] == cl["out"],
                         ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_full_ms=full))
        del x, buf
    return rows


def print_bn_relu(rows):
    for r in rows:
        print(f"bn_relu epilogue {r['epilogue']} (stage {r['stage']} {r['conv']}, "
              f"{r['rows']} rows, {r['active']} active, C {r['C']}, {r['dtype']} -> "
              f"{r['out']}{', in place' if r['in_place'] else ''}): equal to the plain "
              f"chain; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms (every row read {r['bound_full_ms']:.4f})",
              flush=True)
    for label, sel in (("per forward", rows), ("dense stages 2-3",
                                               [r for r in rows if r["stage"] >= 2])):
        print(f"bn_relu {label}: kernel {sum(r['ms'] for r in sel):.3f} ms, plain "
              f"{sum(r['plain_ms'] for r in sel):.3f} ms, bound "
              f"{sum(r['bound_ms'] for r in sel):.3f} ms (every row read "
              f"{sum(r['bound_full_ms'] for r in sel):.3f})", flush=True)


def print_voxel_rcnn(vr):
    """Phase 13's lines."""
    print(f"voxel_rcnn (batch {BATCH} x {POINTS} points, bf16, seeded init + one batch's BN "
          f"statistics, {vr['rois']} RoIs a frame): two stages p50 {vr['p50_ms']:.2f} ms, "
          f"peak mem {vr['peak_mem_bytes'] / 2**30:.2f} GiB, valid detections per frame "
          f"{vr['valid_per_frame']}, counters {vr['counters']}, launches per forward "
          f"{vr['launches']}; dropped sites over {VOXEL_RCNN_BATCHES} batches "
          f"{vr['dropped']}", flush=True)
    for r in vr["voxel_query_rows"]:
        print(f"voxel_query {r['query']} (stride {r['stride']}, grid {r['grid']}, "
              f"{r['voxels']} voxels, G {r['G']}, nsample {r['S']}): equal to the plain "
              f"version and to the forward's rows, a dropped voxel caught; kernel "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {r['tests']} tests), row map {r['row_map_ms']:.3f} ms, empty "
              f"balls {r['empty_share']:.3f}, full {r['full_share']:.3f}", flush=True)
    e = vr["embed_333"]
    print(f"zwin_conv {e['shape']} through embed_333 (B {e['B']}, N {e['N']}, M {e['M']}): "
          f"bf16 {e['ms']:.4f} ms, plain {e['plain_ms']:.3f} ms, err {e['max_abs_err']:.3g} of "
          f"scale {e['ref_scale']:.3g}, a zeroed tap caught", flush=True)


def pvrcnn_reference_phase(dev, backend="voxel"):
    """Phases 8b and 11b: small geometry, float32 (called under
    ``full_float32()``): the card against the CPU on one set of weights and
    grid-point draws, on the ``backend`` representation."""
    cfg = pvrcnn_cfg(small_geometry_cfg()).replace(sparse_backend=backend)
    pts, num = crop_to_grid(cfg, kitti_like_batch(1, 2, 60000)[0])
    pts, num = pts[:, :PV_REF_POINTS], np.minimum(num, PV_REF_POINTS)
    cpu = torch.device("cpu")
    model, anchors = create_pvrcnn(cfg, device=cpu)
    calibrate_bn(model, torch.from_numpy(pts), torch.from_numpy(num), anchors)
    sd = model.state_dict()
    radii = [(r, s) for rr in cfg.psa.radii for r, s in zip(rr, cfg.samples_pn)]
    runs = []
    for d in (dev, cpu):
        m, a = create_pvrcnn(cfg, device=d, state_dict=sd)
        zw.reset_launches()
        with torch.no_grad():
            _, inter = pvrcnn_stages(m, a, torch.from_numpy(pts).to(d),
                                     torch.from_numpy(num).to(d),
                                     torch.Generator().manual_seed(0))
            inter["ball_query"] = [
                ball_query(xyz.contiguous(), msk, inter["keypoints"], r, s)
                for (xyz, _, msk), pair in zip(inter["sources"], zip(radii[::2], radii[1::2]))
                for r, s in pair]
        kernel = "column_conv" if backend == "column" else "zwin_conv"
        # the forward's ball queries and the ten above
        want = {} if d.type == "cpu" else {kernel: 6, f"{kernel}.fma": 6,
                                           **point_launches("pvrcnn2"),
                                           "ball_query": BALL_QUERIES["pvrcnn2"] + 10,
                                           **epilogue_launches(cfg)}
        launched = {k: n for k, n in zw.LAUNCHES.items() if n}
        check(launched == want, f"pvrcnn reference on {d.type}: launches {launched}")
        runs.append({k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                     for k, v in inter.items()})
    g, c = runs
    bq_equal = all(torch.equal(gi.cpu(), ci) and torch.equal(gv.cpu(), cv)
                   for (gi, gv), (ci, cv) in zip(g["ball_query"], c["ball_query"]))
    errs = {}
    for key in ("point_features", "proposals", "refined", "conf"):
        ref = c[key]
        errs[key] = float((g[key] - ref).abs().max() / ref.abs().max())
    gdet = type(g["det"])(*[t.cpu() for t in g["det"]])
    cmp = compare_backends(gdet, c["det"])
    out = dict(backend=backend, points=int(num[0]),
               keypoints_equal=torch.equal(g["keypoint_idx"], c["keypoint_idx"]),
               ball_query_equal=bq_equal, ball_queries=len(c["ball_query"]),
               counters=c["diag"], rel_err=errs, detections=cmp)
    print(f"pvrcnn reference (card vs CPU, f32, small geometry): {out}", flush=True)
    check(out["keypoints_equal"], "keypoint indices differ between card and CPU")
    check(bq_equal, "ball-query indices differ between card and CPU")
    check(g["diag"] == c["diag"], f"counters differ: card {g['diag']} vs CPU {c['diag']}")
    for key in errs:
        check(agrees(g[key], c[key], PV_TOL), f"{key} differs: {errs[key]:.3g} of scale")
    n = max(cmp["n_a"], cmp["n_b"], 1)
    check(cmp["n_a"] > 0 and max(cmp["unmatched_a"], cmp["unmatched_b"])
          <= BACKENDS_MAX_UNMATCHED * n and cmp["box_delta"] <= BACKENDS_MAX_BOX
          and cmp["score_delta"] <= BACKENDS_MAX_SCORE,
          f"card and CPU detections disagree: {cmp}")
    return out


def pvrcnn_cli_phase(shapes):
    """Phase 8c: eval_cli --model pvrcnn2 on the card, the seeded init, on
    phase 7's synthetic val frames, in the yaml's float32."""
    from vision3d_tpu_torch import eval_cli

    golden = json.loads(GOLDEN.read_text())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        val, data = synthetic_set(tmp, golden)
        batches = -(-len(val) // BATCH)
        want = {**launches_at("zwin_conv", shapes, "launches_per_forward", torch.float32,
                              batches), **point_launches("pvrcnn2", batches),
                **epilogue_launches(Config.from_yaml(str(CONFIG)), batches)}
        (table, timing), launches = counted(lambda: eval_cli.main(
            data + ["--model", "pvrcnn2", "--out-json", str(tmp / "ap.json")]), want)
        check(timing["frames"] == len(val) and (tmp / "ap.json").exists(),
              f"eval_cli --model pvrcnn2 evaluated {timing['frames']} frames")
    check(all(np.isfinite(v) for row in table.values() for v in row.values()),
          f"eval_cli --model pvrcnn2: {table}")
    return dict(timing=timing, per_batch={k: v // batches for k, v in launches.items()},
                table=table)


def stage2_parameters(model):
    return {n: p for n, p in model.named_parameters() if n.split(".")[0] in STAGE2_MODULES}


def pnets_statistics(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.startswith("pnets.") and "running_" in k}


@contextlib.contextmanager
def step_marks(tx, marks):
    """Host times, each after a synchronise, at which a training step
    enters its backward pass (``marks["backward"]``) and its optimizer
    update (``"optimizer"``), and leaves the update (``"end"``)."""
    backward, update = torch.Tensor.backward, tx.step

    def timed_backward(self, *args, **kwargs):
        torch.cuda.synchronize()
        marks["backward"] = time.perf_counter()
        return backward(self, *args, **kwargs)

    def timed_update(count):
        torch.cuda.synchronize()
        marks["optimizer"] = time.perf_counter()
        update(count)
        torch.cuda.synchronize()
        marks["end"] = time.perf_counter()

    torch.Tensor.backward, tx.step = timed_backward, timed_update
    try:
        yield marks
    finally:
        torch.Tensor.backward = backward
        del tx.step


def pvrcnn_training_phase(cfg, dev, runs, warmup=PV_TRAIN_WARMUP, timed=PV_TRAIN_TIMED):
    """Phases 9a and 11a: PV-RCNN training at full width, bf16, from a
    fresh seeded init; ``runs`` is {name: (mode, config changes, launches
    of a step, of which column dX launches, frames of phase 5's batch)}:
    launches of the first step
    by kernel and route, its column dX launches apart, every gather_rows
    launch of it against its plain version, capacity counters, losses, the
    p50 of the timed steps, peak memory; for a two-stage step a
    synchronised split into forward (targets, forward, losses), backward
    and optimizer; the point branch's running statistics moved, and the
    stage-2 parameters moved (two stages) or do not exist (one)."""
    cfg = pvrcnn_cfg(cfg)
    full = kitti_like_train_batch(0, BATCH, POINTS, cfg=cfg)
    out = {}
    for name, (mode, kw, expected, n_dx, frames) in runs.items():
        batch = _to_device({k: v[:frames] for k, v in full.items()}, dev)
        two = mode == "pvrcnn2"
        cfg_r = cfg.replace(**kw)
        model, tx, state = create_pvrcnn_train_state(
            cfg_r, torch.Generator().manual_seed(0), STEPS_PER_EPOCH, dev, two_stage=two)
        step = make_pvrcnn_train_step(model, tx, cfg_r, train_stage2=two, seed=0)
        stats0 = pnets_statistics(model)
        stage2_0 = {n: p.detach().clone() for n, p in stage2_parameters(model).items()}
        check(bool(stage2_0) == two, f"{name}: stage-2 parameters {sorted(stage2_0)[:3]}")
        gathers, dx = [], {}
        with checked_gathers(gathers), counted_dx(dx):
            (state, first), launches = counted(
                lambda: step(state, batch), {**expected, **point_launches(mode)})
        check(len(gathers) == expected["gather_rows"],
              f"{name}: {len(gathers)} gathers checked")
        check(dx["launches"] == {"column_conv": n_dx, "column_conv.mma": n_dx,
                                 "column_conv.fma": 0},
              f"{name}: column dX launches {dx['launches']}, not {n_dx} on mma")
        losses = [{k: float(v) for k, v in first.items()}]
        counters = {k: int(v) for k, v in state.diagnostics.items()}
        times = []
        for i in range(1, warmup + timed):
            if i == warmup:
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, o = step(state, batch)
            torch.cuda.synchronize()
            if i >= warmup:
                times.append(1e3 * (time.perf_counter() - t0))
            losses.append({k: float(v) for k, v in o.items()})
            for k, v in state.diagnostics.items():
                counters[k] = max(counters[k], int(v))
        peak = int(torch.cuda.max_memory_allocated())
        split = None
        if two:
            marks = {}
            with step_marks(tx, marks):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, o = step(state, batch)
            losses.append({k: float(v) for k, v in o.items()})
            split = {"forward_ms": 1e3 * (marks["backward"] - t0),
                     "backward_ms": 1e3 * (marks["optimizer"] - marks["backward"]),
                     "optimizer_ms": 1e3 * (marks["end"] - marks["optimizer"])}
        check_counters(counters, f"{name} training")
        check(all(np.isfinite(list(d.values())).all() for d in losses),
              f"{name}: non-finite loss {losses}")
        keys = {"loss", "cls_loss", "reg_loss"} | ({"refine_cls_loss", "refine_reg_loss",
                                                    "refine_loss", "seg_loss"} if two else set())
        check(set(losses[0]) == keys, f"{name}: losses {sorted(losses[0])}")
        for pname, p in model.named_parameters():
            check(bool(torch.isfinite(p).all()), f"{name}: non-finite parameter {pname}")
        moved = {k: float((model.state_dict()[k] - v).abs().max()) for k, v in stats0.items()}
        check(len(moved) == 40 and min(moved.values()) > 0,
              f"{name}: the point branch's running statistics did not all move: {moved}")
        s2 = stage2_parameters(model)
        still = [n for n, p in s2.items() if torch.equal(p.detach(), stage2_0[n])]
        check(not still, f"{name}: stage-2 parameters that did not move: {still}")
        check(state.step == warmup + timed + two, f"{name}: step counter")
        out[name] = dict(frames=frames, launches=launches, dx=dx, counters=counters,
                         losses=losses,
                         step_ms_p50=float(np.median(times)), step_ms=times,
                         peak_mem_bytes=peak, split=split,
                         pnets_stat_moved_min=min(moved.values()),
                         stage2_parameters=len(s2), gathers_checked=len(gathers))
        del model, tx, state, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def point_indices(record):
    """Every keypoint sampling's and ball query's integer outputs of the
    model, in call order, appended to ``record``."""
    sample, query = tpvrcnn.sample_keypoints, tpointnet.ball_query

    def sample_rec(*args, **kwargs):
        kp, idx = sample(*args, **kwargs)
        record.append(idx.cpu())
        return kp, idx

    def query_rec(*args, **kwargs):
        idx, valid = query(*args, **kwargs)
        record.append(torch.cat([idx, valid.long()], dim=-1).cpu())
        return idx, valid

    tpvrcnn.sample_keypoints, tpointnet.ball_query = sample_rec, query_rec
    try:
        yield record
    finally:
        tpvrcnn.sample_keypoints, tpointnet.ball_query = sample, query


def unit_gain_stage2(model, generator):
    """The reduction and refinement MLPs redrawn at std sqrt(2 / fan_in): at
    their normal(0.01) init the gradient that reaches the grid pool's set
    abstraction is ~1e-13, too small for a gate relative to its own max."""
    with torch.no_grad():
        for lin in list(model.roi_grid_pool.mlp.linears) + list(model.refinement.mlp.linears):
            lin.weight.normal_(0.0, (2.0 / lin.weight.shape[1]) ** 0.5, generator=generator)


def pvrcnn_training_reference_phase(dev, backend="voxel", modes=PV_MODES):
    """Phases 9b and 11b: small geometry, float32 (called under
    ``full_float32()``): one step of each of ``modes`` on the ``backend``
    representation on the card (kernels) and on the CPU (plain versions)
    from one set of weights, one batch and the step's own CPU draws. The keypoint and ball-query indices must be equal; then the
    losses, gradients, parameters and running statistics after the step
    must agree: losses to 1e-5 relative, every gradient to 1e-4 of its
    max (phase 6's gates), running statistics as PV_STAT_TOL, and a
    parameter to 2e-7 + 1e-6 of its size, or by up to twice the first rate
    where its gradient is under the gradient gate (Adam's first update is
    lr * g / (|g| + 1e-8), whose sign is there the noise's). The CPU's
    backward takes the card's ReLU gates (as phase 6) and the card's
    max-pool selections: without the latter, 8 selections that differed
    moved the grid pool's and a source's set-abstraction gradients by up
    to 2.6e-4 of their max on an NVIDIA H100 80GB HBM3 (700.00 W)."""
    cfg = pvrcnn_cfg(small_geometry_cfg()).replace(sparse_backend=backend)
    b = kitti_like_train_batch(1, 2, 60000, max_gt=8, cfg=cfg)
    pts, num = crop_to_grid(cfg, b["points"])
    b["points"], b["num_points"] = pts[:, :PV_REF_POINTS], np.minimum(num, PV_REF_POINTS)
    b["boxes"][..., 0] = np.clip(b["boxes"][..., 0], 3.0, 22.0)
    b["boxes"][..., 1] = np.clip(b["boxes"][..., 1], -10.0, 10.0)
    cpu = torch.device("cpu")
    model0, _, _ = create_pvrcnn_train_state(cfg, torch.Generator().manual_seed(2),
                                             device=cpu)
    unit_gain_stage2(model0, torch.Generator().manual_seed(3))
    sd = {k: v.clone() for k, v in model0.state_dict().items()}
    # gt boxes on two of the first pass's proposals per frame, so the
    # refinement regression has foreground
    anchors = torch.as_tensor(make_anchors(cfg))
    with torch.no_grad():
        first, _ = model0.two_stage(torch.from_numpy(b["points"]),
                                    torch.from_numpy(b["num_points"]), anchors,
                                    generator=torch.Generator().manual_seed(0))
    props = first["proposals"].numpy()
    far = np.linalg.norm(props[:, :, :2] - props[:, :1, :2], axis=-1) > 5.0
    for i in range(2):      # the top proposal and the first one 5 m from it
        b["boxes"][i, :2] = props[i, [0, int(far[i].argmax())]]
    b["boxes"][:, :2, :3] += 0.05
    b["boxes"][:, :2, 6] += 0.05      # no yaw residual at the codec's wrap
    b["class_idx"][:, :2] = 0
    b["gt_mask"][:, :2] = True
    spe = 10
    lr = make_lr_schedule(cfg, spe)(0)
    out = {}
    step_launches = TRAIN_FORMS["column_df4"][1] if backend == "column" else ALL_SPARSE[1]
    with torch.backends.mkldnn.flags(enabled=False):
        for mode in modes:
            two = mode == "pvrcnn2"
            runs, relus, maxes = [], [], []
            sd_mode = {k: v for k, v in sd.items()
                       if two or k.split(".")[0] not in STAGE2_MODULES}
            for d in (dev, cpu):
                model, tx, state = create_pvrcnn_train_state(
                    cfg, steps_per_epoch=spe, device=d, state_dict=sd_mode, two_stage=two)
                step = make_pvrcnn_train_step(model, tx, cfg, train_stage2=two, seed=0)
                grads, update = {}, tx.step

                def grab_then_update(count, model=model, grads=grads, update=update):
                    grads.update({n: p.grad.detach().cpu() for n, p in
                                  model.named_parameters() if p.grad is not None})
                    update(count)

                tx.step = grab_then_update
                zw.reset_launches()
                with relu_gates(relus, replay=bool(runs)) as differ, \
                        max_gates(maxes, replay=bool(runs)) as max_differ, \
                        point_indices([]) as indices:
                    state, losses = step(state, _to_device(b, d))
                want = {} if d.type == "cpu" else {**float32_launches(step_launches),
                                                   **point_launches(mode)}
                launched = {k: n for k, n in zw.LAUNCHES.items() if n}
                check(launched == want, f"{mode} reference on {d.type}: launches {launched}")
                runs.append(dict(
                    losses={k: float(v) for k, v in losses.items()}, grads=grads,
                    sd={k: v.detach().cpu() for k, v in model.state_dict().items()},
                    indices=indices, differ=sum(differ), calls=len(differ),
                    max_differ=sum(max_differ), max_calls=len(max_differ),
                    counters={k: int(v) for k, v in state.diagnostics.items()}))
            g, c = runs
            check(len(g["indices"]) == len(c["indices"]) == (13 if two else 11),
                  f"{mode}: {len(g['indices'])} index sets recorded")
            check(all(torch.equal(x, y) for x, y in zip(g["indices"], c["indices"])),
                  f"{mode}: keypoint or ball-query indices differ between card and CPU")
            check(g["counters"] == c["counters"], f"{mode}: counters {g['counters']} "
                                                  f"vs {c['counters']}")
            n_gates = sum(x.numel() for x in relus)
            check(c["calls"] == len(relus) == (49 if two else 41),
                  f"{mode}: {len(relus)} ReLUs recorded, {c['calls']} replayed")
            check(c["differ"] <= 1e-5 * n_gates, f"{mode}: {c['differ']} of {n_gates} "
                                                 f"ReLU gates differ")
            n_sel = sum(x.numel() for x in maxes)
            check(c["max_calls"] == len(maxes) == (12 if two else 0)
                  and c["max_differ"] <= 1e-5 * n_sel,
                  f"{mode}: {len(maxes)} max-pools recorded, {c['max_calls']} replayed, "
                  f"{c['max_differ']} of {n_sel} selections differ")
            loss_rel = {k: abs(g["losses"][k] - v) / max(abs(v), 1e-30)
                        for k, v in c["losses"].items()}
            check(max(loss_rel.values()) <= 1e-5, f"{mode}: losses {g['losses']} vs "
                                                  f"{c['losses']}")
            check(set(g["grads"]) == set(c["grads"]), f"{mode}: gradients of other parameters")
            rels = {n: float((g["grads"][n] - x).abs().max()) / max(float(x.abs().max()), 1e-30)
                    for n, x in c["grads"].items()}
            worst = max(rels, key=rels.get)
            check(rels[worst] <= 1e-4, f"{mode}: gradient of {worst} differs by "
                                       f"{rels[worst]} of its max")
            stat_err = max(float(((g["sd"][k] - x).abs() / (1 + x.abs())).max())
                           for k, x in c["sd"].items() if "running_" in k)
            check(stat_err <= PV_STAT_TOL, f"{mode}: running statistics differ by {stat_err}")
            param_err, floor_hits = 0.0, 0
            for n, x in c["sd"].items():
                if "running_" in n or "num_batches" in n:
                    continue
                gr = c["grads"].get(n)
                noisy = (gr.abs() <= 1e-4 * gr.abs().max() if gr is not None
                         else torch.zeros_like(x, dtype=torch.bool))
                slack = torch.where(noisy, 2 * lr, 0.0)
                err = (g["sd"][n] - x).abs()
                check(bool((err <= 2e-7 + 1e-6 * x.abs() + slack).all()),
                      f"{mode}: parameter {n} differs by {float(err.max())}")
                param_err = max(param_err, float((err - slack).clamp(min=0).max()))
                floor_hits += int(noisy.sum())
            out[mode] = dict(losses_cpu=c["losses"], loss_rel_max=max(loss_rel.values()),
                             index_sets=len(c["indices"]), worst_grad=worst,
                             worst_grad_rel=rels[worst], stat_err=stat_err, param_err=param_err,
                             params_at_noise_floor=floor_hits, relu_gates=n_gates,
                             gates_that_differed=c["differ"],
                             max_selections_that_differed=c["max_differ"],
                             counters=c["counters"])
    return out


def pvrcnn_training_cli_phase(shapes, gg_rows, gr_rows):
    """Phase 9c: train_cli --model pvrcnn and --model pvrcnn2 for one epoch
    on phase 7's 16 synthetic train frames, then eval_cli --ckpt of each
    checkpoint as its own model, in the yaml's float32."""
    from vision3d_tpu_torch import eval_cli, train_cli

    golden = json.loads(GOLDEN.read_text())
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        val, data = synthetic_set(tmp, golden)
        steps = 16 // BATCH
        want_step = {"gather_rows": sum(r["launches_per_step"] for r in gr_rows) * steps,
                     **launches_at("gather_gemm", gg_rows, "launches_per_step",
                                   torch.float32, steps)}
        batches = -(-len(val) // BATCH)
        want_eval = {**launches_at("zwin_conv", shapes, "launches_per_forward",
                                   torch.float32, batches),
                     **epilogue_launches(Config.from_yaml(str(CONFIG)), batches)}
        for mode in PV_MODES:
            recs, launches = counted(lambda: train_cli.main(
                data + ["--model", mode, "--batch-size", str(BATCH), "--workers", "2",
                        "--epochs", "1", "--ckpt-dir", str(tmp / f"ck_{mode}"),
                        "--metrics-jsonl", str(tmp / f"{mode}.jsonl")]),
                {**want_step, **point_launches(mode, steps)})
            check(len(recs) == 1 and recs[0]["steps"] == steps
                  and all(np.isfinite(recs[0]["losses"])), f"train_cli {mode}: {recs}")
            ckpt = recs[0]["checkpoint"]
            check(ckpt and Path(ckpt).is_file(), f"train_cli {mode}: no checkpoint")
            # --model pvrcnn evaluates the BEV branch alone: no ball query
            (table, timing), elaunch = counted(lambda: eval_cli.main(
                data + ["--model", mode, "--ckpt", ckpt,
                        "--out-json", str(tmp / f"ap_{mode}.json")]),
                {**want_eval, **(point_launches("pvrcnn2", batches)
                                 if mode == "pvrcnn2" else {})})
            check(timing["frames"] == len(val), f"eval_cli {mode}: {timing['frames']} frames")
            check(all(np.isfinite(v) for row in table.values() for v in row.values()),
                  f"eval_cli {mode} --ckpt: {table}")
            out[mode] = dict(train={k: recs[0][k] for k in ("seconds", "frames_per_s",
                                                            "host_wait_s", "losses")},
                             train_per_step={k: v // steps for k, v in launches.items()},
                             eval=timing, eval_per_batch={k: v // batches
                                                          for k, v in elaunch.items()},
                             table=table)
    return out


def float32_launches(want):
    """The launches ``want`` gives in bf16 as float32 runs them: every
    launch of a routed kernel on "fma"."""
    out = {k: v for k, v in want.items() if not k.endswith(".mma")}
    for name in ("gather_gemm", "column_conv"):
        if name in want:
            out[f"{name}.fma"] = want[name]
    return out


@contextlib.contextmanager
def checked_gathers(record):
    """Every ``gather_rows`` launch of the model (the dW regathers of both
    backends and the dense cutovers' gathers, forward and backward) held
    against the plain version on the same inputs, which must be equal;
    appends (rows of the table, row width, dtype, gathered rows) to
    ``record``. The plain version launches nothing."""
    from vision3d_tpu_torch.ops import column_conv as tcc
    from vision3d_tpu_torch.ops import gather_rows as tgr

    kernel = tgr.gather_rows

    def gather(table, idx):
        got = kernel(table, idx)
        check(torch.equal(got, gather_rows_plain(table, idx)),
              f"gather_rows on a ({table.shape[0]}, {table.shape[1]}) {table.dtype} "
              f"table differs from its plain version")
        record.append((table.shape[0], table.shape[1], str(table.dtype), idx.numel()))
        return got

    tgr.gather_rows = tcc.gather_rows = gather
    try:
        yield record
    finally:
        tgr.gather_rows = tcc.gather_rows = kernel


def dx_shape_key(c, cout, d, k2, kz, pad_z):
    """The key of one dX shape of the column conv: (C, Cout, D, K2, kz,
    pad_z) of the column_conv launch that computes it."""
    return (int(c), int(cout), int(d), int(k2), int(kz), int(pad_z))


@contextlib.contextmanager
def counted_dx(record):
    """The column_conv launches of every column conv's dX (the backward of
    ``ColumnConvFn``) counted apart from the forward's: ``record`` gets
    "launches" ({"column_conv": n, "column_conv.<route>": n}) and "shapes"
    ({dx_shape_key: n}), summed over the calls made inside."""
    from vision3d_tpu_torch.ops import column_conv as tcc

    dx = tcc.column_conv_dx
    names = ["column_conv"] + [f"column_conv.{r}" for r in kernels.ROUTES["column_conv"]]
    launches = record.setdefault("launches", dict.fromkeys(names, 0))
    shapes = record.setdefault("shapes", {})

    def counted(g, rbt_idx, weight, kernel, d, c, stride_z, pad_z, compute_dtype):
        before = {k: zw.LAUNCHES[k] for k in names}
        out = dx(g, rbt_idx, weight, kernel, d, c, stride_z, pad_z, compute_dtype)
        for k in names:
            launches[k] += zw.LAUNCHES[k] - before[k]
        kz = kernel[0]
        key = dx_shape_key(weight.shape[1], c, d + 2 * pad_z - kz + 1,
                           kernel[1] * kernel[2], kz, kz - 1 - pad_z)
        shapes[key] = shapes.get(key, 0) + zw.LAUNCHES["column_conv"] - before["column_conv"]
        return out

    tcc.column_conv_dx = counted
    try:
        yield record
    finally:
        tcc.column_conv_dx = dx


def train_forms_phase(cfg, dev):
    """Phase 10a: SECOND training at full geometry, bf16, in the forms of
    TRAIN_FORMS, each from ``init_second`` seed 0 on phase 5's batch: the
    launches of the first step by kernel and route, the column convs' dX
    launches of it apart (TRAIN_FORMS_DX), every gather_rows launch of it
    against its plain version, capacity counters 0, finite
    loss, gradients and parameters, loss decreasing, the p50 of the timed
    steps and the peak memory."""
    batch = _to_device(kitti_like_train_batch(0, BATCH, POINTS, cfg=cfg), dev)
    out = {}
    for form, (kw, want) in TRAIN_FORMS.items():
        cfg_f = cfg.replace(**kw)
        model, tx, state = create_train_state(cfg_f, torch.Generator().manual_seed(0),
                                              STEPS_PER_EPOCH, dev)
        step = make_train_step(model, tx, cfg_f)
        gathers, dx = [], {}
        with checked_gathers(gathers), counted_dx(dx):
            (state, first), launches = counted(lambda: step(state, batch), want)
        check(len(gathers) == want["gather_rows"], f"{form}: {len(gathers)} gathers checked")
        n_dx = TRAIN_FORMS_DX.get(form, 0)
        check(dx["launches"] == {"column_conv": n_dx, "column_conv.mma": n_dx,
                                 "column_conv.fma": 0},
              f"{form}: column dX launches {dx['launches']}, not {n_dx} on mma")
        losses = [float(first["loss"])]
        counters = {k: int(v) for k, v in state.diagnostics.items()}
        times = []
        for i in range(1, TRAIN_WARMUP + TRAIN_TIMED):
            if i == TRAIN_WARMUP:
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, o = step(state, batch)
            torch.cuda.synchronize()
            if i >= TRAIN_WARMUP:
                times.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(o["loss"]))
            for k, v in state.diagnostics.items():
                counters[k] = max(counters[k], int(v))
        peak = int(torch.cuda.max_memory_allocated())
        check_counters(counters, f"{form} training")
        check(all(np.isfinite(losses)), f"{form}: non-finite loss {losses}")
        for name, p in model.named_parameters():
            check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                  f"{form}: missing or non-finite gradient of {name}")
            check(bool(torch.isfinite(p).all()), f"{form}: non-finite parameter {name}")
        check(losses[-1] < losses[0], f"{form}: loss did not decrease: {losses}")
        out[form] = dict(launches=launches, dx=dx, counters=counters, losses=losses,
                         step_ms_p50=float(np.median(times)), step_ms=times,
                         peak_mem_bytes=peak, gathers_checked=len(gathers),
                         gather_shapes=sorted(set(gathers)))
        del model, tx, state, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


def column_backward_layers(layers, c_in):
    """The dX of every column conv of ``layers`` (``column_path_layers``)
    but the first (C = ``c_in``: no gradient to the VFE input), as the
    column conv the training backward launches: input the gradient rows
    at the active output sites, interleaved in z for stride_z 2 (D' = D +
    2*pad_z - kz + 1 rows), over the transposed rulebook, C and Cout
    swapped, stride 1, pad_z' = kz-1-pad_z. Launch counts as the
    forward's (per training step at ``train_dense_from_stage`` 2 and 4)."""
    out = []
    for layer in layers:
        if layer["C"] == c_in:
            continue
        kz, sz, pz, d = layer["kernel"][0], layer["stride_z"], layer["pad_z"], layer["D"]
        d_out = csp.conv_out_depth(d, kz, sz, pz)
        d_full = d + 2 * pz - kz + 1
        osite = layer["out_site"]
        site = osite.new_zeros((*osite.shape[:2], d_full))
        site[:, :, :(d_out - 1) * sz + 1:sz] = osite
        out.append(dict(shape=f"{layer['shape']}_dX", C=layer["Cout"], Cout=layer["C"],
                        D=d_full, N=osite.shape[1],
                        kernel=layer["kernel"], stride_z=1, pad_z=kz - 1 - pz,
                        rb=layer["rbt"], site=site,
                        launches_per_forward=layer["launches_per_forward"],
                        launches_df4=layer["launches_df4"]))
    return out


def training_reference_phase(dev, forms):
    """Phases 6 and 10c: small geometry, float32, TF32 off (called under
    ``full_float32()``): one step's forward + backward of SECOND in each of
    ``forms`` ({name: (config changes, bf16 launches per step)}) on the
    card (kernels, every routed launch on "fma") and on the CPU (plain
    versions), from one set of weights and one batch: loss to 1e-5
    relative, every gradient to 1e-4 of its tensor's max, running
    statistics to PV_STAT_TOL of 1 + |value|. The CPU's oneDNN convs are
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
    gates)."""
    cfg = small_geometry_cfg()
    b = kitti_like_train_batch(1, 2, 60000, max_gt=8, cfg=cfg)
    b["points"], b["num_points"] = crop_to_grid(cfg, b["points"])
    b["boxes"][..., 0] = np.clip(b["boxes"][..., 0], 3.0, 22.0)
    b["boxes"][..., 1] = np.clip(b["boxes"][..., 1], -10.0, 10.0)
    model0, _, _ = create_train_state(cfg, torch.Generator().manual_seed(2), device="cpu")
    sd = model0.state_dict()
    out = {}
    with torch.backends.mkldnn.flags(enabled=False):
        for form, (kw, want) in forms.items():
            cfg_f = cfg.replace(**kw)
            runs, gates = [], []
            for d in (dev, torch.device("cpu")):
                model, _, _ = create_train_state(cfg_f, device=d, state_dict=sd)
                batch = _to_device(b, d)
                anchors = torch.as_tensor(make_anchors(cfg_f), device=d)
                with torch.no_grad():
                    targets = assign_targets_batch(
                        batch["boxes"], batch["class_idx"], batch["gt_mask"],
                        batch["box_ignore"], anchors, cfg_f)
                zw.reset_launches()
                with relu_gates(gates, replay=bool(runs)) as differ:
                    cls_map, reg_map, diag = model(batch["points"], batch["num_points"])
                    loss = proposal_loss(cls_map, reg_map, targets, cfg_f)["loss"]
                    loss.backward()
                launched = {k: n for k, n in zw.LAUNCHES.items() if n}
                check(launched == ({} if d.type == "cpu" else float32_launches(want)),
                      f"{form} reference on {d.type}: launches {launched}")
                runs.append(dict(
                    loss=float(loss.detach()), counters={k: int(v) for k, v in diag.items()},
                    positives=int(targets.M_reg.sum()),
                    grads={k: p.grad.detach().cpu() for k, p in model.named_parameters()},
                    stats={k: v.detach().cpu() for k, v in model.state_dict().items()
                           if "running_" in k}))
            g, c = runs
            check(g["counters"] == c["counters"], f"{form}: counters {g['counters']} vs "
                                                  f"{c['counters']}")
            check(g["positives"] == c["positives"] > 0,
                  f"{form}: positives card {g['positives']}, CPU {c['positives']}")
            check(abs(g["loss"] - c["loss"]) <= 1e-5 * abs(c["loss"]),
                  f"{form}: loss card {g['loss']} vs CPU {c['loss']}")
            n_gates = sum(x.numel() for x in gates)
            check(len(differ) == len(gates) == 21, f"{form}: {len(gates)} ReLUs recorded, "
                                                   f"{len(differ)} replayed, not 21")
            check(sum(differ) <= 1e-5 * n_gates,
                  f"{form}: {sum(differ)} of {n_gates} ReLU gates differ")
            rels = {n: float((g["grads"][n] - x).abs().max()) / max(float(x.abs().max()), 1e-30)
                    for n, x in c["grads"].items()}
            worst = max(rels, key=rels.get)
            check(rels[worst] <= 1e-4, f"{form}: gradient of {worst} differs by "
                                       f"{rels[worst]} of its max; all: {rels}")
            stat_err = max(float(((g["stats"][k] - x).abs() / (1 + x.abs())).max())
                           for k, x in c["stats"].items())
            check(len(c["stats"]) == 42 and stat_err <= PV_STAT_TOL,
                  f"{form}: running statistics differ by {stat_err}")
            out[form] = dict(points=int(b["num_points"][0]), positives=c["positives"],
                             loss_card=g["loss"], loss_cpu=c["loss"], gradients=len(rels),
                             worst_grad=worst, worst_grad_rel=rels[worst], stat_err=stat_err,
                             relu_gates=n_gates, gates_that_differed=sum(differ),
                             counters=c["counters"])
    return out


def train_forms_cli_phase(shapes, col_rows, names):
    """Phases 10d and 11c: train_cli for one epoch of phase 7's 16
    synthetic train frames, in the yaml's float32, in the runs ``names``
    of: ``--dense-from 2`` ("second_df2"), on a yaml that sets
    ``SPARSE_BACKEND: column`` ("second_column"), ``--model pvrcnn2
    --dense-from 2`` ("pvrcnn2_df2") and ``--model pvrcnn2`` on the column
    yaml ("pvrcnn2_column"); then eval_cli --ckpt of each checkpoint (the
    column ones on their yaml) on the 48 val frames: launches per step and
    per batch, finite losses, frames/s, peak memory, finite AP tables (no
    gate). The PV-RCNN run at dense from 2 takes batches of
    PV_DENSE_CLI_BATCH frames: at 8 in float32 it needs more than the
    card's 80 GB."""
    from vision3d_tpu_torch import eval_cli, train_cli

    golden = json.loads(GOLDEN.read_text())
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        val, data = synthetic_set(tmp, golden)
        column_yaml = tmp / "all_classes_column.yaml"
        column_yaml.write_text(CONFIG.read_text() + "\nSPARSE_BACKEND: column\n")
        batches = -(-len(val) // BATCH)
        # float32: every epilogue on K4's "f32" route, whichever stages are dense
        epilogues = epilogue_launches(Config.from_yaml(str(CONFIG)), batches)
        zwin_eval = {**launches_at("zwin_conv", shapes, "launches_per_forward", torch.float32,
                                   batches), **epilogues}
        col_eval = {**launches_at("column_conv", col_rows, "launches_per_forward",
                                  torch.float32, batches), **epilogues}
        runs = {"second_df2": (["--dense-from", "2"], data, "voxel_df2", zwin_eval, BATCH),
                "second_column": ([], ["--config", str(column_yaml)] + data[2:],
                                  "column_df4", col_eval, BATCH),
                "pvrcnn2_df2": (["--model", "pvrcnn2", "--dense-from", "2"], data,
                                "voxel_df2", zwin_eval, PV_DENSE_CLI_BATCH),
                "pvrcnn2_column": (["--model", "pvrcnn2"],
                                   ["--config", str(column_yaml)] + data[2:],
                                   "column_df4", col_eval, BATCH)}
        for name in names:
            extra, args, form, want_eval, batch = runs[name]
            steps = 16 // batch
            want = {k: v * steps for k, v in float32_launches(TRAIN_FORMS[form][1]).items()}
            if "pvrcnn2" in extra:
                want.update(point_launches("pvrcnn2", steps))
                want_eval = {**want_eval, **point_launches("pvrcnn2", batches)}
            recs, launches = counted(lambda: train_cli.main(
                args + extra + ["--batch-size", str(batch), "--workers", "2", "--epochs", "1",
                                "--ckpt-dir", str(tmp / f"ck_{name}"),
                                "--metrics-jsonl", str(tmp / f"{name}.jsonl")]), want)
            check(len(recs) == 1 and recs[0]["steps"] == steps
                  and all(np.isfinite(recs[0]["losses"])), f"train_cli {name}: {recs}")
            ckpt = recs[0]["checkpoint"]
            check(ckpt and Path(ckpt).is_file(), f"train_cli {name}: no checkpoint")
            model = ["--model", "pvrcnn2"] if "pvrcnn2" in extra else []
            (table, timing), elaunch = counted(lambda: eval_cli.main(
                args + model + ["--ckpt", ckpt, "--out-json", str(tmp / f"ap_{name}.json")]),
                want_eval)
            check(timing["frames"] == len(val), f"eval_cli {name}: {timing['frames']} frames")
            check(all(np.isfinite(v) for row in table.values() for v in row.values()),
                  f"eval_cli {name} --ckpt: {table}")
            out[name] = dict(batch=batch, train={k: recs[0][k] for k in ("seconds", "frames_per_s",
                                                            "host_wait_s", "peak_mem_bytes",
                                                            "losses")},
                             train_per_step={k: v // steps for k, v in launches.items() if v},
                             eval=timing,
                             eval_per_batch={k: v // batches for k, v in elaunch.items() if v},
                             table=table)
    return out


def ddp_step(cfg, mode, sd, batch, device, relus, maxes, groups, replay):
    """One training step of ``mode`` ("second" or "pvrcnn2", the draws of
    ``pvrcnn_draws`` seed 0) from ``sd`` on ``batch`` (numpy), with every
    ReLU gate, max-pool selection and ball-query group recorded into, or
    with ``replay`` taken from, ``relus`` / ``maxes`` / ``groups``: the
    losses and counters it returns, the gradients the optimizer takes
    (summed over the ranks in a group), the state dict after the update,
    and how many gates, selections and group entries differed from the
    replayed ones."""
    if mode == "second":
        model, tx, state = create_train_state(cfg, device=device, state_dict=sd)
        step = make_train_step(model, tx, cfg)
    else:
        model, tx, state = create_pvrcnn_train_state(cfg, device=device, state_dict=sd)
        step = make_pvrcnn_train_step(model, tx, cfg, train_stage2=True, seed=0)
    grads, update = {}, tx.step

    def grab_then_update(count):
        grads.update({n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        update(count)

    tx.step = grab_then_update
    with torch.backends.mkldnn.flags(enabled=False), \
            relu_gates(relus, replay) as differ, max_gates(maxes, replay) as mdiffer, \
            ball_groups(groups, replay) as gdiffer:
        state, losses = step(state, _to_device(batch, device))
    return dict(losses={k: float(v) for k, v in losses.items()}, grads=grads,
                sd={k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
                counters={k: int(v) for k, v in state.diagnostics.items()},
                relu_differ=sum(differ), max_differ=sum(mdiffer), group_differ=sum(gdiffer))


def ddp_rank(rank, world, port, device, backend, payload, out_dir):
    """One rank of ``ddp_check``: joins the group through the coordinator
    variables, runs every form of the payload on its slice of the batch on
    the replayed slices of the gates (float32, TF32 off), and saves what
    ``ddp_step`` returns."""
    torch.set_num_threads(1)
    os.environ.update(COORDINATOR_ADDRESS=f"localhost:{port}", NUM_PROCESSES=str(world),
                      PROCESS_ID=str(rank))
    mesh.initialize_distributed(device, backend)
    try:
        p = torch.load(payload, weights_only=False)
        dev = mesh.local_device(device)
        out = {}
        with full_float32():
            for form, ref in p["forms"].items():
                b = len(ref["batch"]["points"]) // world
                part = slice(rank * b, (rank + 1) * b)
                out[form] = ddp_step(ref["cfg"], ref["mode"], ref["sd"],
                                     {k: v[part] for k, v in ref["batch"].items()}, dev,
                                     [g[part] for g in ref["relus"]],
                                     [g[part] for g in ref["maxes"]],
                                     [(i[part], v[part]) for i, v in ref["groups"]],
                                     replay=True)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def ddp_check(cfg, device, world, backend, batch_size=4, points=None):
    """Phase 11d and tests/test_torch_ddp.py: every form of DDP_FORMS at
    ``cfg`` (float32), one training step of ``world`` ranks (processes
    spawned here, ``backend`` on ``device``) each on its slice of a batch of
    ``batch_size`` frames, against one process (this one) on the whole
    batch: losses, summed gradients, counters and running statistics
    against the one process's, parameters after the step bit-equal across
    the ranks. Called under ``full_float32()``, which each rank also
    takes. Returns each form's worst errors."""
    import torch.multiprocessing as mp

    cfg = cfg.replace(compute_dtype="float32")
    b = kitti_like_train_batch(3, batch_size, 60000, max_gt=8, cfg=cfg)
    pts, num = crop_to_grid(cfg, b["points"])
    n = min(points or pts.shape[1], pts.shape[1])
    b["points"], b["num_points"] = pts[:, :n], np.minimum(num, n)
    # every box 5 cm off an anchor of its class at yaw 0: each valid box has
    # positives, so the regression loss and its gradients take part
    anchors = make_anchors(cfg)                      # (n_cls, n_yaw, ny, nx, 7)
    rng = np.random.default_rng(4)
    iy = rng.integers(1, anchors.shape[2] - 1, b["boxes"].shape[:2])
    ix = rng.integers(1, anchors.shape[3] - 1, b["boxes"].shape[:2])
    b["boxes"][..., :3] = anchors[b["class_idx"], 0, iy, ix, :3] + 0.05
    b["boxes"][..., 6] = 0.05
    forms, refs = {}, {}
    for form, (mode, kw) in DDP_FORMS.items():
        cfg_f = cfg.replace(**kw)
        if mode == "second":
            model, _, _ = create_train_state(cfg_f, torch.Generator().manual_seed(2),
                                             device="cpu")
        else:
            model, _, _ = create_pvrcnn_train_state(cfg_f, torch.Generator().manual_seed(2),
                                                    device="cpu")
            unit_gain_stage2(model, torch.Generator().manual_seed(3))
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        relus, maxes, groups = [], [], []
        refs[form] = ddp_step(cfg_f, mode, sd, b, torch.device(device), relus, maxes,
                              groups, False)
        check(all(g.shape[0] == batch_size for g in relus + maxes + [i for i, _ in groups]),
              f"{form}: a ReLU gate, max-pool selection or ball group is not batch-first")
        check(refs[form]["losses"]["reg_loss"] > 0, f"{form}: no positive anchor")
        forms[form] = dict(cfg=cfg_f, mode=mode, sd=sd, batch=b, relus=relus, maxes=maxes,
                           groups=groups)
    with tempfile.TemporaryDirectory() as tmp:
        payload = Path(tmp) / "payload.pt"
        torch.save({"forms": forms}, payload)
        mp.start_processes(ddp_rank, args=(world, mesh.free_port(), device, backend,
                                           str(payload), tmp),
                           nprocs=world, join=True, start_method="spawn")
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(world)]
    out = {}
    for form, ref in refs.items():
        runs = [r[form] for r in ranks]
        n_gates = sum(g.numel() for g in forms[form]["relus"])
        n_sel = sum(g.numel() for g in forms[form]["maxes"])
        n_grp = sum(i.numel() for i, _ in forms[form]["groups"])
        differ = sum(r["relu_differ"] for r in runs)
        mdiffer = sum(r["max_differ"] for r in runs)
        gdiffer = sum(r["group_differ"] for r in runs)
        check(differ <= 1e-5 * n_gates and mdiffer <= 1e-5 * max(n_sel, 1)
              and gdiffer <= 1e-5 * max(n_grp, 1),
              f"{form}: {differ} of {n_gates} ReLU gates, {mdiffer} of {n_sel} max-pool "
              f"selections, {gdiffer} of {n_grp} ball-group entries differ from the one "
              f"process's")
        for r in runs[1:]:
            check(r["losses"] == runs[0]["losses"] and r["counters"] == runs[0]["counters"],
                  f"{form}: the ranks report other losses or counters")
            same = [k for k, v in r["sd"].items() if not torch.equal(v, runs[0]["sd"][k])]
            check(not same, f"{form}: parameters or statistics differ across ranks: "
                            f"{same[:4]}")
        got = runs[0]
        check(got["counters"] == ref["counters"],
              f"{form}: counters {got['counters']} vs one process {ref['counters']}")
        loss_rel = {k: abs(got["losses"][k] - v) / max(abs(v), 1e-30)
                    for k, v in ref["losses"].items()}
        check(set(got["losses"]) == set(ref["losses"])
              and max(loss_rel.values()) <= DDP_LOSS_TOL,
              f"{form}: losses {got['losses']} vs one process {ref['losses']}")
        check(set(got["grads"]) == set(ref["grads"]), f"{form}: gradients of other parameters")
        rels = {k: float((got["grads"][k] - x).abs().max()) / max(float(x.abs().max()), 1e-30)
                for k, x in ref["grads"].items()}
        worst = max(rels, key=rels.get)
        check(rels[worst] <= DDP_GRAD_TOL, f"{form}: gradient of {worst} differs by "
                                           f"{rels[worst]:.3g} of its max; the largest: "
                                           f"{sorted(rels.items(), key=lambda kv: -kv[1])[:12]}; "
                                           f"gates {differ}, selections {mdiffer}, groups "
                                           f"{gdiffer}, losses {loss_rel}")
        stat_err = max(float(((got["sd"][k] - x).abs() / (1 + x.abs())).max())
                       for k, x in ref["sd"].items() if "running_" in k)
        check(stat_err <= DDP_STAT_TOL, f"{form}: running statistics differ by {stat_err}")
        out[form] = dict(world=world, frames=batch_size, loss_rel_max=max(loss_rel.values()),
                         worst_grad=worst, worst_grad_rel=rels[worst], stat_err=stat_err,
                         relu_gates=n_gates, gates_that_differed=differ,
                         max_selections_that_differed=mdiffer,
                         group_entries_that_differed=gdiffer, counters=ref["counters"],
                         losses=ref["losses"])
    return out


def ddp_cli_phase():
    """Phase 11d: train_cli for one epoch of phase 7's 16 synthetic train
    frames in the yaml's float32, once plain and once as rank 0 of a
    world of one over NCCL through the coordinator variables: launches per
    step, the group left behind by neither, and the first step's loss
    equal."""
    from vision3d_tpu_torch import train_cli

    golden = json.loads(GOLDEN.read_text())
    steps = 16 // BATCH
    want = {k: v * steps for k, v in float32_launches(ALL_SPARSE[1]).items()}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _, data = synthetic_set(tmp, golden)
        group = {"COORDINATOR_ADDRESS": f"localhost:{mesh.free_port()}",
                 "NUM_PROCESSES": "1", "PROCESS_ID": "0"}
        for name, env in (("plain", {}), ("nccl_world1", group)):
            os.environ.update(env)
            try:
                recs, launches = counted(lambda: train_cli.main(
                    data + ["--batch-size", str(BATCH), "--workers", "2", "--epochs", "1",
                            "--ckpt-dir", str(tmp / f"ck_{name}"),
                            "--metrics-jsonl", str(tmp / f"{name}.jsonl")]), want)
            finally:
                for k in env:
                    del os.environ[k]
            check(not torch.distributed.is_initialized(), f"train_cli {name} left its group")
            check(len(recs) == 1 and recs[0]["steps"] == steps
                  and Path(recs[0]["checkpoint"]).is_file()
                  and all(np.isfinite(recs[0]["losses"])), f"train_cli {name}: {recs}")
            out[name] = {k: recs[0][k] for k in ("seconds", "frames_per_s", "losses")}
    check(out["nccl_world1"]["losses"][0] == out["plain"]["losses"][0],
          f"first-step loss over NCCL {out['nccl_world1']['losses'][0]} differs from the "
          f"plain run's {out['plain']['losses'][0]}")
    return out


# phase 12: {label: (entry point module, argv, the path's launches per
# forward or step: "zwin" / "column" inference, "pvrcnn2" two-stage
# inference, "train" all-sparse step)}
BENCH_RUNS = {
    "bench second": ("bench", [], "zwin"),
    "bench second --backend column": ("bench", ["--backend", "column"], "column"),
    "bench pvrcnn2": ("bench", ["--model", "pvrcnn2", "--iters", "2", "--warmup", "2"],
                      "pvrcnn2"),
    "bench_train": ("bench_train", [], "train"),
}


def bench_phase(per_unit):
    """Phase 12: each of BENCH_RUNS through its entry point's ``main`` in
    this process; ``per_unit`` maps BENCH_RUNS' path names to the launches
    of one forward or step. Returns {label: (the JSON record, the launches
    per forward or step)}."""
    import importlib

    out = {}
    for label, (module, argv, path) in BENCH_RUNS.items():
        entry = importlib.import_module(f"vision3d_tpu_torch.{module}")
        args = entry.parse_args(argv)
        # bench: one counted forward, then a first chain and the timed ones;
        # bench_train: a first chain and the timed ones
        units = (args.iters * (1 + args.reps) if module == "bench_train"
                 else 1 + args.iters * (1 + args.warmup))
        want = {k: v * units for k, v in per_unit[path].items()}
        buf = io.StringIO()
        gc.collect()
        torch.cuda.empty_cache()
        with contextlib.redirect_stdout(buf):
            record, launches = counted(lambda: entry.main(argv), want)
        lines = buf.getvalue().splitlines()
        check(len(lines) == 1 and json.loads(lines[0]) == record,
              f"{label}: expected one JSON line, printed {lines}")
        print(f"{label} ({units} {'steps' if path == 'train' else 'forwards'}):", flush=True)
        print(lines[0], flush=True)
        for k in ("value", "compile_s", "peak_mem_gib"):
            check(np.isfinite(record[k]) and record[k] > 0, f"{label}: {k} {record[k]}")
        if module == "bench":
            check(all(v == 0 for v in record["stage_dropped"]),
                  f"{label}: capacity counters {record['stage_dropped']}")
            check(record["n_devices"] == 1, f"{label}: n_devices {record['n_devices']}")
        out[label] = (record, {k: v // units for k, v in launches.items() if v})
    return out


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

    zwin_layers = path_layers(cfg, points, num_t)
    shapes = kernel_phase(zwin_layers, dev)
    want_zwin = route_launches("zwin_conv", shapes, "launches_per_forward")
    check(want_zwin == {"zwin_conv": 6, "zwin_conv.fma": 1, "zwin_conv.mma": 5},
          f"expected z-window launches per forward {want_zwin}")
    align_launches = align_variants_path(zwin_layers, dev)
    print(f"zwin_align variants on the forward's z-window layers: launches "
          f"{align_launches}", flush=True)
    del zwin_layers
    col_layers, plan_counters = column_path_layers(cfg, points, num_t)
    col_rows = column_kernel_phase(col_layers, dev)
    del col_layers
    want_col = route_launches("column_conv", col_rows, "launches_per_forward")
    want_col4 = route_launches("column_conv", col_rows, "launches_df4")
    check(want_col == {"column_conv": 6, "column_conv.fma": 1, "column_conv.mma": 5}
          and want_col4 == {"column_conv": 14, "column_conv.fma": 1,
                            "column_conv.mma": 13},
          f"expected column launches per forward {want_col}, {want_col4}")
    # every inference forward also ends each of its 14 convs in K4
    want_zwin = {**want_zwin, **epilogue_launches(cfg)}
    want_col = {**want_col, **epilogue_launches(cfg.replace(sparse_backend="column"))}
    want_col4 = {**want_col4, **epilogue_launches(cfg.replace(dense_from_stage=4))}
    gg_rows, gr_rows = train_kernel_phase(cfg, points, num_t, dev)
    torch.cuda.empty_cache()
    e2e = end_to_end_phase(model, anchors, points, num_t, want_zwin)
    print(f"e2e: batch {BATCH} x {POINTS} points, p50 {e2e['latency_ms_p50']:.2f} ms, "
          f"peak mem {e2e['peak_mem_bytes'] / 2**30:.2f} GiB, "
          f"valid detections per frame {e2e['valid_per_frame']}, "
          f"counters {e2e['counters']}, launches {e2e['launches']}", flush=True)
    del model
    torch.cuda.empty_cache()
    col = column_phase(cfg, sd, anchors, points, num_t, dev, plan_counters, e2e,
                       want_col, want_col4)
    print(f"e2e column backend: p50 {col['latency_ms_p50']:.2f} ms, peak mem "
          f"{col['peak_mem_bytes'] / 2**30:.2f} GiB, valid detections per frame "
          f"{col['valid_per_frame']}, counters {col['counters']} (equal to the plain "
          f"plan's), launches {col['launches']}; dense_from_stage 4: launches "
          f"{col['launches_df4']}, counters {col['counters_df4']}, "
          f"{col['valid_df4']} valid detections", flush=True)
    print(f"column vs voxel backend detections (bf16): {col['vs_voxel']}; column "
          f"dense_from_stage 4 vs 2: {col['df4_vs_df2']}", flush=True)
    with full_float32():
        for backend in ("voxel", "column"):
            ref = reference_phase(sd, dev, backend)
            print(f"reference check (card vs CPU, f32, small geometry): {ref}",
                  flush=True)
    del anchors
    gc.collect()
    torch.cuda.empty_cache()      # the training phase starts from a clean pool
    expected = {"zwin_conv": 0,
                "gather_rows": sum(r["launches_per_step"] for r in gr_rows),
                **route_launches("gather_gemm", gg_rows, "launches_per_step")}
    check(expected["gather_gemm"] == 27 and expected["gather_rows"] == 14
          and expected["gather_gemm.mma"] == 26,
          f"expected launches per training step {expected}")
    train = training_phase(cfg, dev, expected)
    print(f"train: batch {BATCH} x {POINTS} points, {TRAIN_TIMED} timed steps, p50 "
          f"{train['step_ms_p50']:.2f} ms, peak mem "
          f"{train['peak_mem_bytes'] / 2**30:.2f} GiB, losses "
          f"{[round(x, 4) for x in train['losses']]}, counters {train['counters']}, "
          f"launches per step {train['launches']}", flush=True)
    with full_float32():
        tref = training_reference_phase(dev, {"voxel_df4": ALL_SPARSE})
    print(f"training reference check (card vs CPU, f32, small geometry): {tref}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    cli = cli_phase(Config.from_yaml(str(CONFIG)), shapes, gg_rows, gr_rows)
    steps = len(cli["train"][0]["losses"])
    per_step = {k: v // steps for k, v in cli["train_launches"].items()}
    for rec in cli["train"]:
        print(f"train_cli epoch {rec['epoch']}: {steps} steps of {BATCH} frames, "
              f"{rec['seconds']:.2f} s, {rec['frames_per_s']:.2f} frames/s, host wait "
              f"{rec['host_wait_s']:.2f} s ({rec['host_wait_s'] / rec['seconds']:.1%}), "
              f"losses {[round(x, 4) for x in rec['losses']]}", flush=True)
    print(f"train_cli launches per step: {per_step}", flush=True)
    batches = -(-cli["eval"]["frames"] // BATCH)
    per_batch = {k: v // batches for k, v in cli["eval_launches"].items()}
    print(f"eval_cli launches per batch of {BATCH}: {per_batch}; inference_cli "
          f"(one frame): {cli['inference_launches']}, {cli['inference_detections']} detections, "
          f"BEV png {cli['bev_png_bytes']} bytes",
          flush=True)
    for tag, timing in (("checkpoint", cli["eval_ckpt"]), ("trained weights, TF32 off",
                                                           cli["eval"])):
        print(f"eval_cli on the {tag}: {timing['frames']} frames in "
              f"{timing['seconds']:.2f} s ({timing['frames'] / timing['seconds']:.2f} "
              f"frames/s)", flush=True)
    print(f"eval_cli AP@R40 on the checkpoint: {cli['table_ckpt']}", flush=True)
    print(f"eval_cli AP@R40, trained weights: {cli['table']}", flush=True)
    print(f"JAX golden AP@R40: {json.loads(GOLDEN.read_text())['table']}; largest gap "
          f"{max(cli['ap_gaps'].values()):.4f} ({max(cli['ap_gaps'], key=cli['ap_gaps'].get)})",
          flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    pv = pvrcnn_phase(cfg, dev, want_zwin)
    print(f"pvrcnn (batch {BATCH} x {POINTS} points, bf16, seeded init + one batch's BN "
          f"statistics): one stage p50 {pv['p50_one_stage_ms']:.2f} ms, two stages p50 "
          f"{pv['p50_two_stage_ms']:.2f} ms, peak mem {pv['peak_mem_bytes'] / 2**30:.2f} "
          f"GiB, valid detections per frame {pv['valid_two_stage']} (one stage "
          f"{pv['valid_one_stage']}), counters {pv['counters']}, launches per forward "
          f"{pv['launches']} (one stage {pv['launches_one_stage']})", flush=True)
    print("pvrcnn two-stage split (ms, host clock, synchronised per stage): "
          + ", ".join(f"{k} {v:.3f}" for k, v in pv["stage_ms"].items())
          + f"; sum {pv['stage_sum_ms']:.2f}", flush=True)
    bq_rows = pv["ball_query_rows"]
    for r in bq_rows:
        print(f"ball_query {r['query']} (B {r['B']}, N {r['N']}, {r['active']} rows masked "
              f"in, M {r['M']}, nsample {r['S']}): equal to the plain version, a dropped "
              f"source caught; kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['pairs']} pairs), full balls "
              f"{r['full_share']:.3f}", flush=True)
    bq_ms = {}
    for r in bq_rows:
        ms = bq_ms.setdefault(r["query"].split()[0], {"kernel": 0.0, "plain": 0.0})
        ms["kernel"] += r["ms"]
        ms["plain"] += r["plain_ms"]
    print(f"ball_query_ms per source (both radii, CUDA events): {bq_ms}; per two-stage "
          f"forward: kernel {sum(r['ms'] for r in bq_rows):.3f} ms, plain "
          f"{sum(r['plain_ms'] for r in bq_rows):.3f} ms", flush=True)
    fps_rows = fps_phase(dev)
    print_fps(fps_rows)
    with full_float32():
        pvref = pvrcnn_reference_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    pvcli = pvrcnn_cli_phase(shapes)
    print(f"eval_cli --model pvrcnn2 (float32, seeded init): {pvcli['timing']['frames']} "
          f"frames in {pvcli['timing']['seconds']:.2f} s "
          f"({pvcli['timing']['frames'] / pvcli['timing']['seconds']:.2f} frames/s), "
          f"launches per batch {pvcli['per_batch']}, AP (untrained, no gate) "
          f"{pvcli['table']}", flush=True)
    del pvref

    gc.collect()
    torch.cuda.empty_cache()
    pvt = pvrcnn_training_phase(cfg, dev, {m: (m, {}, expected, 0, BATCH) for m in PV_MODES})
    for mode, r in pvt.items():
        print(f"{mode} training (batch {BATCH} x {POINTS} points, bf16, seeded init): "
              f"{PV_TRAIN_TIMED} timed steps, p50 {r['step_ms_p50']:.2f} ms "
              f"({[round(t, 2) for t in r['step_ms']]}), peak mem "
              f"{r['peak_mem_bytes'] / 2**30:.2f} GiB, launches per step {r['launches']}, "
              f"counters {r['counters']}, smallest move of a pnets_* statistic "
              f"{r['pnets_stat_moved_min']:.3g}, stage-2 parameters {r['stage2_parameters']}",
              flush=True)
        print(f"{mode} training losses: "
              + "; ".join(", ".join(f"{k} {v:.4f}" for k, v in d.items()) for d in r["losses"]),
              flush=True)
    print("pvrcnn2 training step split (ms, host clock, synchronised): "
          + ", ".join(f"{k} {v:.2f}" for k, v in pvt["pvrcnn2"]["split"].items()), flush=True)
    with full_float32():
        pvtref = pvrcnn_training_reference_phase(dev)
    for mode, r in pvtref.items():
        print(f"{mode} training reference (card vs CPU, f32, small geometry): {r}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    pvtcli = pvrcnn_training_cli_phase(shapes, gg_rows, gr_rows)
    for mode, r in pvtcli.items():
        t = r["train"]
        print(f"train_cli --model {mode} (float32, 16 frames, batch {BATCH}, 2 loader "
              f"processes): {t['seconds']:.2f} s, {t['frames_per_s']:.2f} frames/s, host "
              f"wait {t['host_wait_s']:.2f} s ({t['host_wait_s'] / t['seconds']:.1%}), "
              f"losses {[round(x, 4) for x in t['losses']]}, launches per step "
              f"{r['train_per_step']}; eval_cli --model {mode} --ckpt: "
              f"{r['eval']['frames']} frames in {r['eval']['seconds']:.2f} s "
              f"({r['eval']['frames'] / r['eval']['seconds']:.2f} frames/s), launches per "
              f"batch {r['eval_per_batch']}, AP (untrained, no gate) {r['table']}", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    forms = train_forms_phase(cfg, dev)
    for form, r in forms.items():
        print(f"train {form} (batch {BATCH} x {POINTS} points, bf16, seeded init): "
              f"{TRAIN_TIMED} timed steps, p50 {r['step_ms_p50']:.2f} ms "
              f"({[round(t, 2) for t in r['step_ms']]}), peak mem "
              f"{r['peak_mem_bytes'] / 2**30:.2f} GiB, launches per step {r['launches']}, "
              f"counters {r['counters']}, losses {[round(x, 4) for x in r['losses']]}; "
              f"column dX launches {r['dx'].get('launches')}; "
              f"{r['gathers_checked']} gather_rows launches equal to the plain version "
              f"(rows, width, dtype, gathered: {r['gather_shapes']})", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        layers, _ = column_path_layers(cfg, points, num_t)
    bw_layers = column_backward_layers(layers, cfg.c_in)
    del layers
    bw_rows = column_kernel_phase(bw_layers, dev)
    del bw_layers
    # the dX launches phase 10a's first steps made, by 10b's shape: each
    # must be one of 10b's shapes, as often as the layer list says
    for form, count in (("column_df4", "launches_df4"), ("column_df2",
                                                          "launches_per_forward")):
        measured = dict(forms[form]["dx"]["shapes"])
        for r in bw_rows:
            key = dx_shape_key(r["C"], r["Cout"], r["D"], r["K2"], r["kz"], r["pad_z"])
            r[f"launches_dx_{form}"] = measured.pop(key, 0)
            check(r[f"launches_dx_{form}"] == r[count],
                  f"{form}: {r['shape']} launched {r[f'launches_dx_{form}']} times in a "
                  f"step, not {r[count]}")
        check(not measured, f"{form}: dX launches of shapes 10b did not check: {measured}")
        check(route_launches("column_conv", bw_rows, f"launches_dx_{form}")
              == forms[form]["dx"]["launches"],
              f"{form}: dX launches by route {forms[form]['dx']['launches']} differ from "
              f"10b's routes")
    with full_float32():
        fref = training_reference_phase(dev, {f: TRAIN_FORMS[f] for f in (
            "voxel_df2", "column_df4", "column_df2")})
    for form, r in fref.items():
        print(f"train {form} reference (card vs CPU, f32, small geometry): {r}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    fcli = train_forms_cli_phase(shapes, col_rows, ("second_df2", "second_column",
                                                     "pvrcnn2_df2"))
    for name, r in fcli.items():
        t = r["train"]
        print(f"train_cli {name} (float32, 16 frames, batch {r['batch']}, 2 loader processes): "
              f"{t['seconds']:.2f} s, {t['frames_per_s']:.2f} frames/s, host wait "
              f"{t['host_wait_s']:.2f} s ({t['host_wait_s'] / t['seconds']:.1%}), peak mem "
              f"{t['peak_mem_bytes'] / 2**30:.2f} GiB, losses "
              f"{[round(x, 4) for x in t['losses']]}, launches per step "
              f"{r['train_per_step']}; eval_cli --ckpt: {r['eval']['frames']} frames in "
              f"{r['eval']['seconds']:.2f} s ({r['eval']['frames'] / r['eval']['seconds']:.2f} "
              f"frames/s), launches per batch {r['eval_per_batch']}, AP (no gate) "
              f"{r['table']}", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    pvc = pvrcnn_phase(cfg.replace(sparse_backend="column"), dev, want_col,
                       state_dict=pv.pop("state_dict"), profile=False)
    print(f"pvrcnn on columns (phase 8's weights, dense_from_stage 2): one stage p50 "
          f"{pvc['p50_one_stage_ms']:.2f} ms, two stages p50 "
          f"{pvc['p50_two_stage_ms']:.2f} ms ({[round(t, 2) for t in pvc['two_stage_ms']]}), "
          f"peak mem {pvc['peak_mem_bytes'] / 2**30:.2f} GiB, valid detections per frame "
          f"{pvc['valid_two_stage']}, counters {pvc['counters']}, launches per forward "
          f"{pvc['launches']} (one stage {pvc['launches_one_stage']})", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    pvct = pvrcnn_training_phase(cfg, dev, PV_COLUMN_TRAIN, *PV_COLUMN_STEPS)
    for name, r in pvct.items():
        print(f"{name} training (batch {r['frames']} x {POINTS} points, bf16, seeded init): "
              f"{PV_COLUMN_STEPS[1]} timed steps, p50 {r['step_ms_p50']:.2f} ms "
              f"({[round(t, 2) for t in r['step_ms']]}), peak mem "
              f"{r['peak_mem_bytes'] / 2**30:.2f} GiB, launches per step {r['launches']}, "
              f"column dX launches {r['dx']['launches']}, {r['gathers_checked']} gather_rows "
              f"launches equal to the plain version, counters {r['counters']}, split "
              f"{r['split']}, losses " + "; ".join(
                  ", ".join(f"{k} {v:.4f}" for k, v in d.items()) for d in r["losses"][:2]),
              flush=True)
    with full_float32():
        pvcref = pvrcnn_reference_phase(dev, "column")
        pvctref = pvrcnn_training_reference_phase(dev, "column", ("pvrcnn2",))
    print(f"pvrcnn column inference reference (card vs CPU, f32, small geometry): "
          f"{pvcref}", flush=True)
    print(f"pvrcnn2 column training reference (card vs CPU, f32, small geometry): "
          f"{pvctref['pvrcnn2']}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    pvccli = train_forms_cli_phase(shapes, col_rows, ("pvrcnn2_column",))
    r = pvccli["pvrcnn2_column"]
    t = r["train"]
    print(f"train_cli --model pvrcnn2 on columns (float32, 16 frames, batch {r['batch']}, 2 "
          f"loader processes): {t['seconds']:.2f} s, {t['frames_per_s']:.2f} frames/s, host "
          f"wait {t['host_wait_s']:.2f} s ({t['host_wait_s'] / t['seconds']:.1%}), peak mem "
          f"{t['peak_mem_bytes'] / 2**30:.2f} GiB, losses {[round(x, 4) for x in t['losses']]}, "
          f"launches per step {r['train_per_step']}; eval_cli --model pvrcnn2 --ckpt: "
          f"{r['eval']['frames']} frames in {r['eval']['seconds']:.2f} s "
          f"({r['eval']['frames'] / r['eval']['seconds']:.2f} frames/s), launches per batch "
          f"{r['eval_per_batch']}, AP (untrained, no gate) {r['table']}", flush=True)
    del pvcref

    gc.collect()
    torch.cuda.empty_cache()
    with full_float32():
        ddp = ddp_check(small_geometry_cfg(), "cuda", 2, "gloo", batch_size=4,
                        points=PV_REF_POINTS)
    for form, r in ddp.items():
        print(f"2 gloo ranks on one card vs one process, {form} (f32, small geometry, "
              f"4 frames): {r}", flush=True)
    ddpcli = ddp_cli_phase()
    print(f"train_cli as rank 0 of a world of one over NCCL vs plain (float32, 16 frames): "
          f"{ddpcli}", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    benches = bench_phase({"zwin": want_zwin, "column": want_col, "train": expected,
                           "pvrcnn2": {**want_zwin, **point_launches("pvrcnn2")}})
    for label, (_, per) in benches.items():
        print(f"{label}: launches per {'step' if 'train' in label else 'forward'} {per}",
              flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    vr = voxel_rcnn_phase(dev)
    print_voxel_rcnn(vr)

    gc.collect()
    torch.cuda.empty_cache()
    ep_rows = bn_relu_phase(dev)
    print_bn_relu(ep_rows)

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
         "launches_by_route": {r: e2e["launches"][f"zwin_conv.{r}"]
                               for r in kernels.ROUTES["zwin_conv"]},
         # the command-line paths, at the yaml's compute dtype
         "launches_eval_cli_per_batch": per_batch,
         "launches_inference_cli": cli["inference_launches"],
         # PV-RCNN's trunk (phase 8): per two-stage forward and per eval_cli batch
         "launches_pvrcnn_per_forward": pv["launches"],
         "launches_eval_cli_pvrcnn2_per_batch": pvcli["per_batch"],
         # the benchmark entry point (phase 12): per forward of SECOND and of
         # PV-RCNN's two stages
         "launches_bench_second_per_forward": benches["bench second"][1],
         "launches_bench_pvrcnn2_per_forward": benches["bench pvrcnn2"][1],
         # Voxel R-CNN (phase 13): every stage sparse, the (3, 1, 1) conv
         # through embed_333, held to the plain version at its shape
         "launches_voxel_rcnn_per_forward": {k: n for k, n in vr["launches"].items()
                                             if k.startswith("zwin_conv")},
         "embed_333": vr["embed_333"],
         "ms": per(shapes, "bf16_ms", "launches_per_forward"),
         "plain_ms": per(shapes, "bf16_plain_ms", "launches_per_forward"),
         "bound_ms": per(shapes, "bf16_bound_ms", "launches_per_forward"),
         "bound_by": bound_by(shapes),
         # no single PyTorch call computes a z-window conv
         "library_ms": None,
         # every launch on the float32-FMA route (the design before the mma route)
         "ms_fma_route_only": per(shapes, "bf16_fma_ms", "launches_per_forward"),
         "shapes": brief(shapes, "launches_per_forward",
                         ("route", "M", "active_taps", "bf16_fma_ms") + times)},
        {"name": "gather_gemm", "route": "cuda",
         "source": "vision3d_tpu_torch/csrc/gather_gemm.cu",
         "replaces": "vision3d_tpu/ops/pallas/sparse_conv.py:52",
         "launches": train["launches"]["gather_gemm"],
         "max_abs_err": max(r["bf16_max_abs_err"] for r in gg_rows),
         "launches_by_route": {r: train["launches"][f"gather_gemm.{r}"]
                               for r in kernels.ROUTES["gather_gemm"]},
         "launches_train_cli_per_step": {k: v for k, v in per_step.items()
                                         if k.startswith("gather_gemm")},
         # PV-RCNN training (phase 9): per step of each mode, bf16 and the CLI's float32
         "launches_pvrcnn_train_per_step": {
             m: {k: v for k, v in r["launches"].items() if k.startswith("gather_gemm")}
             for m, r in pvt.items()},
         "launches_train_cli_pvrcnn_per_step": {
             m: {k: v for k, v in r["train_per_step"].items() if k.startswith("gather_gemm")}
             for m, r in pvtcli.items()},
         # SECOND training with dense late stages (phase 10a, bf16; 10d, float32)
         "launches_train_forms_per_step": {
             f: {k: v for k, v in r["launches"].items() if k.startswith("gather_gemm")}
             for f, r in forms.items() if f.startswith("voxel")},
         "launches_train_cli_forms_per_step": {
             n: {k: v for k, v in r["train_per_step"].items() if k.startswith("gather_gemm")}
             for n, r in fcli.items() if n != "second_column"},
         # the training-step benchmark entry point (phase 12), per step
         "launches_bench_train_per_step": {
             k: v for k, v in benches["bench_train"][1].items() if k.startswith("gather_gemm")},
         "ms": per(gg_rows, "bf16_ms"), "plain_ms": per(gg_rows, "bf16_plain_ms"),
         "bound_ms": per(gg_rows, "bf16_bound_ms"), "bound_by": bound_by(gg_rows),
         # no single PyTorch call gathers K rows per output and multiplies
         "library_ms": None,
         # every launch on the float32-FMA route (the design before the mma route)
         "ms_fma_route_only": per(gg_rows, "bf16_fma_ms"),
         "shapes": brief(gg_rows, "launches_per_step",
                         ("route", "M", "K", "hits", "bf16_fma_ms") + times)},
        {"name": "gather_rows", "route": "cuda",
         "source": "vision3d_tpu_torch/csrc/gather_rows.cu",
         "replaces": "vision3d_tpu/ops/pallas/gather.py:34 and "
                     "vision3d_tpu/ops/pallas/dma_gather.py:29",
         "launches": train["launches"]["gather_rows"],
         "launches_train_cli_per_step": per_step["gather_rows"],
         "launches_pvrcnn_train_per_step": {m: r["launches"]["gather_rows"]
                                            for m, r in pvt.items()},
         "launches_train_cli_pvrcnn_per_step": {m: r["train_per_step"]["gather_rows"]
                                                for m, r in pvtcli.items()},
         # phase 10: the dW regathers and the dense cutovers of the new forms,
         # each launch of the first step equal to the plain version
         "launches_train_forms_per_step": {f: r["launches"]["gather_rows"]
                                           for f, r in forms.items()},
         "launches_train_cli_forms_per_step": {n: r["train_per_step"]["gather_rows"]
                                               for n, r in fcli.items()},
         # PV-RCNN on columns (phase 11a, 11c), each launch of 11a's first
         # step equal to the plain version
         "launches_pvrcnn_column_train_per_step": {n: r["launches"]["gather_rows"]
                                                   for n, r in pvct.items()},
         "launches_train_cli_pvrcnn_column_per_step":
             pvccli["pvrcnn2_column"]["train_per_step"]["gather_rows"],
         "launches_bench_train_per_step": benches["bench_train"][1]["gather_rows"],
         "max_abs_err": max(r["bf16_max_abs_err"] for r in gr_rows),
         "ms": per(gr_rows, "bf16_ms"), "plain_ms": per(gr_rows, "bf16_plain_ms"),
         "bound_ms": per(gr_rows, "bf16_bound_ms"), "bound_by": bound_by(gr_rows),
         "library_ms": per(gr_rows, "bf16_library_ms"),   # torch.index_select
         "shapes": brief(gr_rows, "launches_per_step",
                         ("Q", "C", "bf16_library_ms") + times)},
        {"name": "column_conv", "route": "cuda",
         "source": "vision3d_tpu_torch/csrc/column_conv.cu",
         "replaces": "vision3d_tpu/ops/pallas/column_conv.py:86",
         "launches": col["launches"]["column_conv"],
         "max_abs_err": max(r["bf16_max_abs_err"] for r in col_rows),
         "launches_by_route": {r: col["launches"][f"column_conv.{r}"]
                               for r in kernels.ROUTES["column_conv"]},
         "ms": per(col_rows, "bf16_ms", "launches_per_forward"),
         "plain_ms": per(col_rows, "bf16_plain_ms", "launches_per_forward"),
         "bound_ms": per(col_rows, "bf16_bound_ms", "launches_per_forward"),
         "bound_by": bound_by([r for r in col_rows if r["launches_per_forward"]]),
         # no single PyTorch call gathers neighbour columns and convolves in z
         "library_ms": None,
         # every launch on the float32-FMA route (the design before the mma route)
         "ms_fma_route_only": per(col_rows, "bf16_fma_ms", "launches_per_forward"),
         "launches_dense_from_stage_4": col["launches_df4"]["column_conv"],
         "launches_by_route_dense_from_stage_4": {
             r: col["launches_df4"][f"column_conv.{r}"]
             for r in kernels.ROUTES["column_conv"]},
         "ms_dense_from_stage_4": per(col_rows, "bf16_ms", "launches_df4"),
         "ms_fma_route_only_dense_from_stage_4": per(col_rows, "bf16_fma_ms",
                                                     "launches_df4"),
         "bound_ms_dense_from_stage_4": per(col_rows, "bf16_bound_ms", "launches_df4"),
         "shapes": brief(col_rows, "launches_per_forward",
                         ("launches_df4", "route", "M", "D", "active_taps",
                          "active_out_sites", "bf16_fma_ms") + times),
         # column training (phase 10a, bf16; 10d, float32): forward + dX
         "launches_train_forms_per_step": {
             f: {k: v for k, v in r["launches"].items() if k.startswith("column_conv")}
             for f, r in forms.items() if f.startswith("column")},
         "launches_train_cli_column_per_step": {
             k: v for k, v in fcli["second_column"]["train_per_step"].items()
             if k.startswith("column_conv")},
         # PV-RCNN on columns (phase 11): per two-stage forward at
         # dense_from_stage 2, per training step of each mode at 4 and 2
         # (bf16), per train_cli --model pvrcnn2 step (float32)
         "launches_pvrcnn_column_per_forward": pvc["launches"],
         # the benchmark entry point on columns (phase 12), per forward
         "launches_bench_column_per_forward": benches["bench second --backend column"][1],
         "launches_pvrcnn_column_train_per_step": {
             n: {k: v for k, v in r["launches"].items() if k.startswith("column_conv")}
             for n, r in pvct.items()},
         "launches_dx_pvrcnn_column_train_per_step": {
             n: r["dx"]["launches"]["column_conv"] for n, r in pvct.items()},
         "launches_train_cli_pvrcnn_column_per_step": {
             k: v for k, v in pvccli["pvrcnn2_column"]["train_per_step"].items()
             if k.startswith("column_conv")},
         # the dX launches of phase 10a's step at train_dense_from_stage 4
         # (and 2), counted apart from the forward's; times per launch from
         # phase 10b at those shapes
         "launches_dx_per_step": forms["column_df4"]["dx"]["launches"]["column_conv"],
         "launches_dx_by_route_per_step": {
             r: forms["column_df4"]["dx"]["launches"][f"column_conv.{r}"]
             for r in kernels.ROUTES["column_conv"]},
         "launches_dx_per_step_dense_from_stage_2":
             forms["column_df2"]["dx"]["launches"]["column_conv"],
         "max_abs_err_dx": max(r["bf16_max_abs_err"] for r in bw_rows),
         "ms_dx_per_step": per(bw_rows, "bf16_ms", "launches_dx_column_df4"),
         "plain_ms_dx_per_step": per(bw_rows, "bf16_plain_ms", "launches_dx_column_df4"),
         "bound_ms_dx_per_step": per(bw_rows, "bf16_bound_ms", "launches_dx_column_df4"),
         "ms_fma_route_only_dx_per_step": per(bw_rows, "bf16_fma_ms",
                                              "launches_dx_column_df4"),
         "dx_shapes": brief(bw_rows, "launches_dx_column_df4",
                            ("route", "M", "D", "active_taps", "active_out_sites",
                             "bf16_fma_ms") + times)},
        {"name": "voxel_query", "route": "cuda",
         "source": "vision3d_tpu_torch/csrc/voxel_query.cu",
         # the JAX package has no Voxel R-CNN
         "replaces": None,
         "launches_voxel_rcnn_per_forward": vr["launches"]["voxel_query"],
         "ms": sum(r["ms"] for r in vr["voxel_query_rows"]),
         "plain_ms": sum(r["plain_ms"] for r in vr["voxel_query_rows"]),
         "bound_ms": sum(r["bound_ms"] for r in vr["voxel_query_rows"]),
         "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in vr["voxel_query_rows"])
                      else "operations"),
         # no PyTorch call takes the first nsample occupied window cells in scan order
         "library_ms": None,
         "shapes": vr["voxel_query_rows"]},
        {"name": "ball_query", "route": "cuda",
         "source": "vision3d_tpu_torch/csrc/ball_query.cu",
         # XLA code in the JAX package (vision3d_tpu/ops/ball_query.py)
         "replaces": None,
         "launches": pv["launches"]["ball_query"],
         "launches_pvrcnn_column_per_forward": pvc["launches"]["ball_query"],
         "launches_eval_cli_pvrcnn2_per_batch": pvcli["per_batch"]["ball_query"],
         "launches_pvrcnn_train_per_step": {m: r["launches"]["ball_query"]
                                            for m, r in pvt.items()},
         "launches_train_cli_pvrcnn_per_step": {m: r["train_per_step"]["ball_query"]
                                                for m, r in pvtcli.items()},
         "launches_bench_pvrcnn2_per_forward":
             benches["bench pvrcnn2"][1]["ball_query"],
         "launches_bench_second_per_forward":
             benches["bench second"][1].get("ball_query", 0),
         "ms": sum(r["ms"] for r in bq_rows),
         "plain_ms": sum(r["plain_ms"] for r in bq_rows),
         "bound_ms": sum(r["bound_ms"] for r in bq_rows),
         "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in bq_rows)
                      else "operations"),
         # no PyTorch call takes the first nsample in-ball points by index
         "library_ms": None,
         "shapes": bq_rows},
        {"name": "fps", "route": "cuda",
         "source": "vision3d_tpu_torch/csrc/fps.cu",
         # XLA code in the JAX package (vision3d_tpu/ops/fps.py)
         "replaces": None,
         "launches": pv["launches"]["fps"],
         "launches_by_route": {r: pv["launches"][f"fps.{r}"] for r in kernels.ROUTES["fps"]},
         "launches_pvrcnn_column_per_forward": pvc["launches"]["fps"],
         "launches_eval_cli_pvrcnn2_per_batch": pvcli["per_batch"]["fps"],
         "launches_pvrcnn_train_per_step": {m: r["launches"]["fps"] for m, r in pvt.items()},
         "launches_train_cli_pvrcnn_per_step": {m: r["train_per_step"]["fps"]
                                                for m, r in pvtcli.items()},
         "launches_bench_pvrcnn2_per_forward": benches["bench pvrcnn2"][1]["fps"],
         "launches_bench_second_per_forward": benches["bench second"][1].get("fps", 0),
         # the cell's shape, all valid
         "ms": fps_rows[0]["ms"], "plain_ms": fps_rows[0]["plain_ms"],
         "bound_ms": fps_rows[0]["bound_ms"], "bound_by": fps_rows[0]["bound_by"],
         # no PyTorch call samples furthest points
         "library_ms": None,
         "shapes": fps_rows},
        {"name": "bn_relu", "route": "cuda",
         "source": "vision3d_tpu_torch/csrc/bn_relu.cu",
         # XLA fuses the JAX package's epilogue
         "replaces": None,
         "launches": e2e["launches"]["bn_relu"],
         "launches_by_route": {r: e2e["launches"][f"bn_relu.{r}"]
                               for r in kernels.ROUTES["bn_relu"]},
         "launches_column_per_forward": col["launches"]["bn_relu"],
         "launches_eval_cli_per_batch": per_batch["bn_relu"],
         "launches_pvrcnn_per_forward": pv["launches"]["bn_relu"],
         "launches_voxel_rcnn_per_forward": vr["launches"]["bn_relu"],
         "launches_bench_second_per_forward": benches["bench second"][1]["bn_relu"],
         "launches_train_per_step": train["launches"]["bn_relu"],
         # phase 14: the cell's 14 epilogues of a forward
         "ms": sum(r["ms"] for r in ep_rows), "plain_ms": sum(r["plain_ms"] for r in ep_rows),
         "bound_ms": sum(r["bound_ms"] for r in ep_rows), "bound_by": "bytes",
         # no single PyTorch call computes a masked batch norm with ReLU
         "library_ms": None,
         "shapes": ep_rows},
    ] + [
        {"name": f"zwin_align_{v}", "route": "cuda",
         "source": "vision3d_tpu_torch/csrc/zwin_align_gemm.cu",
         "replaces": f"vision3d_tpu/ops/pallas/zwin_conv.py:{line}",
         "launches": align_launches[f"zwin_align_{v}"],
         "max_abs_err": max(r[f"{v}_bf16_max_abs_err"] for r in shapes),
         "launches_by_route": {r: align_launches[f"zwin_align_{v}.{r}"]
                               for r in kernels.ROUTES[f"zwin_align_{v}"]},
         "ms": per(shapes, f"{v}_bf16_ms", "launches_per_forward"),
         "plain_ms": per(shapes, f"{v}_bf16_plain_ms", "launches_per_forward"),
         # the masks, the rows they select and the weight read once
         "bound_ms": per(shapes, f"{v}_bf16_bound_ms", "launches_per_forward"),
         "bound_by": ("bytes" if all(r[f"{v}_bf16_bound_by"] == "bytes" for r in shapes)
                      else "operations"),
         # no single PyTorch call aligns gathered windows by masks and multiplies
         "library_ms": None,
         # every launch on the float32-FMA route (the design before the mma route)
         "ms_fma_route_only": per(shapes, f"{v}_bf16_fma_ms", "launches_per_forward"),
         # every gathered window read once (the bound before the least-bytes one)
         "bound_ms_every_window": per(shapes, f"{v}_bf16_bound_all_ms",
                                      "launches_per_forward"),
         "shapes": brief(shapes, "launches_per_forward",
                         ("route",) + tuple(f"{v}_{t}" for t in
                                            ("bf16_rows", "bf16_fma_ms",
                                             "bf16_bound_all_ms") + times))}
        for v, line in (("v1", 55), ("v3", 238))
    ]
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
