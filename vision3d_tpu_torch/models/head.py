"""Proposal head, decode and multiclass NMS (port of
``vision3d_tpu/models/head.py:34-119``).

Two 1x1 convs give per-anchor class logits (B, n_cls, n_yaw, ny, nx) and
box deltas (..., 7) in the JAX package's layout. Inference takes sigmoid
scores, the top K per (batch, class), decodes against the anchors and runs
one rotated NMS over the pooled n_cls*K candidates per sample with class
groups and per-class score thresholds, into fixed-capacity ``Detections``.
"""

from typing import NamedTuple

import torch
from torch import nn

from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.core.boxes import decode
from vision3d_tpu_torch.core.nms import nms_rotated
from vision3d_tpu_torch.training.profiler import annotate


class Detections(NamedTuple):
    """Fixed-capacity detection set; rows with ``valid=False`` are padding."""

    boxes: torch.Tensor      # (B, n_cls * topk, 7)
    scores: torch.Tensor     # (B, n_cls * topk)
    class_idx: torch.Tensor  # (B, n_cls * topk) int32
    valid: torch.Tensor      # (B, n_cls * topk) bool


class ProposalHead(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        c = cfg.proposal.c_in
        self.conv_cls = nn.Conv2d(c, cfg.num_classes * cfg.num_yaw, 1)
        self.conv_reg = nn.Conv2d(c, cfg.num_classes * cfg.num_yaw * cfg.box_dof, 1)

    def forward(self, x):
        """x (B, C, ny, nx) -> cls (B, n_cls, n_yaw, ny, nx),
        reg (B, n_cls, n_yaw, ny, nx, 7)."""
        c = self.cfg
        b, _, ny, nx = x.shape
        cls = self.conv_cls(x).reshape(b, c.num_classes, c.num_yaw, ny, nx)
        reg = self.conv_reg(x).reshape(b, c.num_classes, c.num_yaw, c.box_dof,
                                       ny, nx).permute(0, 1, 2, 4, 5, 3)
        return cls, reg


def decode_proposals(cls_map, reg_map, anchors, cfg: Config):
    """Top-K per (batch, class) + decode. anchors (n_cls, n_yaw, ny, nx, 7).
    Returns boxes (B, n_cls, K, 7), scores (B, n_cls, K).

    Ties in score (empty BEV cells give identical logits) go to the lower
    anchor index, as ``jax.lax.top_k`` breaks them: a stable descending
    sort, sliced, since ``torch.topk`` promises no order among ties."""
    with annotate("decode"):
        b, n_cls = cls_map.shape[:2]
        k = cfg.proposal.topk
        scores_flat = torch.sigmoid(cls_map.reshape(b, n_cls, -1).float())
        scores, idx = torch.sort(scores_flat, dim=-1, descending=True, stable=True)
        scores, idx = scores[..., :k], idx[..., :k]
        dof = cfg.box_dof
        deltas = torch.gather(reg_map.reshape(b, n_cls, -1, dof).float(), 2,
                              idx[..., None].expand(b, n_cls, k, dof))
        anchors_flat = anchors.reshape(1, n_cls, -1, dof).expand(b, -1, -1, -1)
        sel = torch.gather(anchors_flat, 2, idx[..., None].expand(b, n_cls, k, dof))
        return decode(deltas, sel), scores


def multiclass_nms(boxes, scores, cfg: Config) -> Detections:
    """Pooled rotated NMS with class groups + per-class score thresholds."""
    b, n_cls, k, _ = boxes.shape
    flat_boxes = boxes.reshape(b, n_cls * k, 7)
    flat_scores = scores.reshape(b, n_cls * k)
    class_idx = torch.arange(n_cls, dtype=torch.int32, device=boxes.device)
    class_idx = class_idx[None, :, None].expand(b, n_cls, k).reshape(b, n_cls * k)
    with annotate("sync"):
        thresh = torch.tensor([a.score_thresh for a in cfg.anchors[: cfg.num_classes]],
                              dtype=scores.dtype, device=scores.device)
        bev = flat_boxes[..., [0, 1, 3, 4, 6]]
    keep = nms_rotated(bev, flat_scores, group_idx=class_idx,
                       iou_threshold=cfg.proposal.nms_iou_threshold,
                       angle_mode=cfg.iou_angle_mode)
    valid = keep & (flat_scores > thresh[class_idx.long()])
    return Detections(flat_boxes, flat_scores, class_idx, valid)


def head_inference(cls_map, reg_map, anchors, cfg: Config) -> Detections:
    boxes, scores = decode_proposals(cls_map, reg_map, anchors, cfg)
    return multiclass_nms(boxes, scores, cfg)


def extract_detections(det: Detections):
    """Fixed-capacity Detections -> per-sample numpy dicts of the valid rows."""
    out = []
    for b in range(det.boxes.shape[0]):
        v = det.valid[b].cpu().numpy()
        out.append(dict(
            boxes=det.boxes[b].cpu().numpy()[v],
            scores=det.scores[b].cpu().numpy()[v],
            class_idx=det.class_idx[b].cpu().numpy()[v],
        ))
    return out
