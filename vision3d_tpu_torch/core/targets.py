"""Proposal target assignment, anchors vs ground truth (port of
``vision3d_tpu/core/targets.py:40-117``).

Per class: rotated BEV IoU of that class's gt boxes against the class's
anchor grid; anchors stratified into {background 0, ignore -1, positive
+1} by the class's (low, high) thresholds; optionally the best anchor(s)
per gt rescued (``allow_low_quality_matches``); the per-box ignore mask
applied; then classification targets (ignore -> mask) and VoxelNet-encoded
regression targets at positive sites. With no gt of a class every anchor is
background. ``subsample_labels`` (unused by the models) is not ported.
"""

from typing import NamedTuple

import torch

from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.core.boxes import encode
from vision3d_tpu_torch.core.iou import pairwise_rotated_iou_chunked

_BEV_COLS = [0, 1, 3, 4, 6]


class Targets(NamedTuple):
    """All laid out like the anchor grid (n_cls, n_yaw, ny, nx), with a
    leading batch dim from ``assign_targets_batch``."""

    G_cls: torch.Tensor  # float {0, 1} classification target
    M_cls: torch.Tensor  # bool, False at ignore sites
    G_reg: torch.Tensor  # (..., 7) encoded box targets (zeros off-positive)
    M_reg: torch.Tensor  # bool, True at positive sites


def assign_targets_batch(boxes, class_idx, gt_mask, box_ignore, anchors,
                         cfg: Config, iou_chunk: int = 8192) -> Targets:
    """boxes (B, G, 7) padded gt; class_idx (B, G) int; gt_mask (B, G)
    bool; box_ignore (B, G) bool: anchors matched to these become ignore;
    anchors (n_cls, n_yaw, ny, nx, 7). The batch is one more leading dim
    of the same arithmetic (the JAX package vmaps the single-sample
    function)."""
    n_cls = cfg.num_classes
    dof = cfg.box_dof
    grid_shape = tuple(anchors.shape[:-1])
    anchors_flat = anchors.reshape(n_cls, -1, dof)            # (n_cls, A, 7)
    a = anchors_flat.shape[1]
    bsz, g = boxes.shape[:2]
    dev = boxes.device

    # Each gt is matched only within its own class, so its IoU is taken
    # against its own class's anchors alone (the JAX package computes every
    # class's and zeroes the others: the same values at a third of the work
    # for three classes).
    own = anchors_flat[..., _BEV_COLS][class_idx.clamp(0, n_cls - 1).long()]
    iou_own = pairwise_rotated_iou_chunked(
        boxes[..., None, _BEV_COLS], own, angle_mode=cfg.iou_angle_mode,
        chunk=iou_chunk)[:, :, 0]                             # (B, G, A)

    thr = torch.tensor([c.iou_thresh for c in cfg.anchors[:n_cls]],
                       dtype=iou_own.dtype, device=dev)
    lows, highs = thr[:, 0:1], thr[:, 1:2]                    # (n_cls, 1)

    # gt row g takes part in class c's matching iff valid and of class c
    participates = gt_mask[..., None] & (
        class_idx[..., None] == torch.arange(n_cls, device=dev))  # (B, G, n_cls)
    iou = torch.where(participates[..., None], iou_own[:, :, None], 0.0)

    matched_vals = iou.amax(dim=1)                            # (B, n_cls, A)
    # the lowest gt index among ties, as jnp.argmax: the first maximum
    is_max = iou == matched_vals[:, None]
    gidx = torch.arange(g, device=dev)[None, :, None, None]
    matches = torch.where(is_max, gidx, g).amin(dim=1)        # (B, n_cls, A)

    labels = torch.where(matched_vals < lows, 0, 1)
    labels = torch.where((matched_vals >= lows) & (matched_vals < highs),
                         -1, labels)

    if cfg.allow_low_quality_matches:
        # the best anchor(s) of each participating gt (ties included) get 1
        best_per_gt = torch.where(participates, iou.amax(dim=3), -1.0)
        rescue = (iou == best_per_gt[..., None]) & participates[..., None]
        labels = torch.where(rescue.any(dim=1), 1, labels)

    flat = matches.reshape(bsz, -1)
    ignored = torch.gather(box_ignore, 1, flat).reshape(matches.shape)
    labels = torch.where(ignored & (labels != -1), -1, labels)

    m_cls = labels != -1
    g_cls = labels.clamp(min=0).to(torch.float32)
    m_reg = labels == 1

    matched_boxes = torch.gather(
        boxes, 1, flat[..., None].expand(bsz, flat.shape[1], dof)
    ).reshape(bsz, n_cls, a, dof)
    g_reg = encode(matched_boxes, anchors_flat)
    g_reg = torch.where(m_reg[..., None], g_reg, 0.0)

    shape = (bsz,) + grid_shape
    return Targets(G_cls=g_cls.reshape(shape), M_cls=m_cls.reshape(shape),
                   G_reg=g_reg.reshape(shape + (dof,)),
                   M_reg=m_reg.reshape(shape))


def assign_targets(boxes, class_idx, gt_mask, box_ignore, anchors,
                   cfg: Config, iou_chunk: int = 8192) -> Targets:
    """Single-sample assignment: boxes (G, 7), class_idx / gt_mask /
    box_ignore (G,)."""
    t = assign_targets_batch(boxes[None], class_idx[None], gt_mask[None],
                             box_ignore[None], anchors, cfg, iou_chunk)
    return Targets(*(x[0] for x in t))
