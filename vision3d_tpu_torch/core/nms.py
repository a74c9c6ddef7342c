"""Greedy rotated NMS with fixed capacity (port of
``vision3d_tpu/core/nms.py``).

``nms_rotated`` is batched over a leading dim; ``batched_nms_rotated``,
``nms`` and ``batched_nms`` take one set of boxes, as the JAX package's
do, and the axis-aligned two run the rotated machinery at angle 0. The
full same-group (K, K) IoU matrix is built once; the greedy scan runs as a
fixpoint iteration (keep'[i] = no kept higher-ranked box suppresses i),
which converges to the unique greedy solution in chain-depth steps.
Suppression is strict ``>`` as in the reference's nms_rotated_cpu.cpp.
"""

import torch

from vision3d_tpu_torch.core.iou import rotated_iou
from vision3d_tpu_torch.training.profiler import annotate

NEG_INF = -1e10


def nms_rotated(boxes, scores, group_idx=None, valid=None, iou_threshold=0.01,
                angle_mode="degrees"):
    """boxes (B, K, 5) rotated BEV boxes, scores (B, K); optional
    group_idx (B, K) (suppression only within a group) and valid (B, K).
    Returns keep (B, K) bool over the ORIGINAL box order. Each fixpoint
    step reads back whether keep changed (the span ``v3d:sync``)."""
    with annotate("nms"):
        b, k = scores.shape
        if valid is None:
            valid = torch.ones_like(scores, dtype=torch.bool)
        masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
        # descending, ties by lower index (jnp.argsort(-x) is stable)
        order = torch.sort(-masked, dim=1, stable=True).indices
        bx = torch.gather(boxes, 1, order[..., None].expand(b, k, 5))
        v = torch.gather(valid, 1, order)
        iou = rotated_iou(bx[:, :, None, :], bx[:, None, :, :], angle_mode)
        suppress = iou > iou_threshold
        if group_idx is not None:
            g = torch.gather(group_idx, 1, order)
            suppress &= g[:, :, None] == g[:, None, :]
        suppress &= v[:, :, None] & v[:, None, :]
        rank = torch.arange(k, device=scores.device)
        suppress &= rank[:, None] < rank[None, :]

        keep = v
        for _ in range(k):
            new = v & ~(suppress & keep[:, :, None]).any(dim=1)
            with annotate("sync"):
                converged = torch.equal(new, keep)
            if converged:
                break
            keep = new
        out = torch.zeros_like(keep)
        out.scatter_(1, order, keep)
        return out


def batched_nms_rotated(boxes, scores, idxs, valid=None, iou_threshold=0.01,
                        angle_mode="degrees"):
    """Per-group rotated NMS of one set: boxes (K, 5), scores (K,), idxs
    (K,) groups (None: one group), optional valid (K,) -> keep (K,) bool."""
    def one(x):
        return None if x is None else x[None]

    return nms_rotated(boxes[None], scores[None], one(idxs), one(valid),
                       iou_threshold, angle_mode)[0]


def _center_form(boxes_xyxy):
    """(K, 4) corner boxes -> (K, 5) centre boxes at angle 0."""
    x1, y1, x2, y2 = boxes_xyxy.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1,
                        torch.zeros_like(x1)], dim=-1)


def nms(boxes_xyxy, scores, valid=None, iou_threshold=0.5):
    """Axis-aligned NMS over (K, 4) corner boxes -> keep (K,) bool."""
    return batched_nms_rotated(_center_form(boxes_xyxy), scores, None, valid,
                               iou_threshold, "radians")


def batched_nms(boxes_xyxy, scores, idxs, valid=None, iou_threshold=0.5):
    """Per-group axis-aligned NMS over (K, 4) corner boxes -> keep (K,) bool."""
    return batched_nms_rotated(_center_form(boxes_xyxy), scores, idxs, valid,
                               iou_threshold, "radians")
