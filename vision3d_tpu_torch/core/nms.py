"""Greedy rotated NMS with fixed capacity (port of
``vision3d_tpu/core/nms.py:25-80``).

Batched over a leading dim. The full same-group (K, K) IoU matrix is built
once; the greedy scan runs as a fixpoint iteration (keep'[i] = no kept
higher-ranked box suppresses i), which converges to the unique greedy
solution in chain-depth steps. Suppression is strict ``>`` as in the
reference's nms_rotated_cpu.cpp.
"""

import torch

from vision3d_tpu_torch.core.iou import rotated_iou

NEG_INF = -1e10


def nms_rotated(boxes, scores, group_idx=None, valid=None, iou_threshold=0.01,
                angle_mode="degrees"):
    """boxes (B, K, 5) rotated BEV boxes, scores (B, K); optional
    group_idx (B, K) (suppression only within a group) and valid (B, K).
    Returns keep (B, K) bool over the ORIGINAL box order."""
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
        if torch.equal(new, keep):
            break
        keep = new
    out = torch.zeros_like(keep)
    out.scatter_(1, order, keep)
    return out
