"""Detection losses: sigmoid focal loss + smooth-L1 proposal loss (port of
``vision3d_tpu/models/losses.py``).

Focal loss in the fvcore formulation (alpha 0.25, gamma 2) at all
non-ignore sites, smooth-L1 at positive sites, both normalised by the
batch-global positive count clamped to 1 (under a process group, the
global batch's: each rank's loss is then its share of the global loss);
total = cls + LAMBDA * reg.
"""

import math

import torch
import torch.nn.functional as F

from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.core.targets import Targets
from vision3d_tpu_torch.parallel.mesh import global_sum
from vision3d_tpu_torch.training.profiler import annotate


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    """Elementwise focal loss on logits."""
    p = torch.sigmoid(logits)
    # the stable form max(x, 0) - x*t + log(1 + exp(-|x|))
    ce = F.binary_cross_entropy_with_logits(logits, targets, reduction="none")
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def smooth_l1(pred, target, beta: float = 1.0):
    """Huber / smooth-L1 with beta = 1."""
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def proposal_loss(cls_map, reg_map, targets: Targets, cfg: Config):
    """dict(loss, cls_loss, reg_loss). cls_map (B, n_cls, n_yaw, ny, nx)
    logits; reg_map (..., 7) deltas."""
    m_reg = targets.M_reg.to(cls_map.dtype)
    normalizer = global_sum(m_reg.sum()).clamp(min=1.0)

    cls = sigmoid_focal_loss(cls_map, targets.G_cls)
    cls_loss = (cls * targets.M_cls.to(cls.dtype)).sum() / normalizer

    per = smooth_l1(reg_map, targets.G_reg)
    # Reference parity quirk, kept (vision3d_tpu/models/losses.py:54-59):
    # the reference sums loss_xyz (3) + loss_wlh (3) + loss_yaw (1)/pi with
    # the yaw term BROADCAST against the 3-wide sum, so it counts three
    # times: total = sum(xyz) + sum(wlh) + 3*yaw/pi.
    scale = per.new_ones(per.shape[-1])
    with annotate("sync"):
        scale[6] = 3.0 / math.pi
    reg_loss = ((per * scale).sum(-1) * m_reg).sum() / normalizer

    loss = cls_loss + cfg.train.lam * reg_loss
    return dict(loss=loss, cls_loss=cls_loss, reg_loss=reg_loss)
