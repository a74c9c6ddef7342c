"""PV-RCNN stage 2: RoI grid pooling, box refinement and its loss (port
of ``vision3d_tpu/models/refinement.py``).

``RoiGridPool`` draws ``num_gridpoints`` uniform points inside each
proposal box (in the box frame, rotated by its yaw), gathers keypoint
features around each with a set-abstraction layer, and reduces the
concatenated grid-point features with an MLP. ``RefinementLayer`` is an
MLP then a Linear to box deltas + a confidence logit; the deltas decode
against the proposal as the anchor (``apply_refinements``).
``refine_topk`` ranks refined boxes by confidence without NMS.
``refinement_loss`` is the confidence BCE plus smooth-L1 on the encoded
residuals of foreground proposals.
"""

import torch
import torch.nn.functional as F
from torch import nn

from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.core.boxes import decode, encode
from vision3d_tpu_torch.core.iou import pairwise_rotated_iou
from vision3d_tpu_torch.models.losses import smooth_l1
from vision3d_tpu_torch.models.pointnet import SetAbstractionMSG
from vision3d_tpu_torch.parallel.mesh import global_sum
from vision3d_tpu_torch.training.profiler import annotate

_BEV_COLS = [0, 1, 3, 4, 6]


class MLP(nn.Module):
    """Linear + ReLU stack (``MLP``, refinement.py:35, as every caller
    builds it: a ReLU after the last layer too, and without the optional
    batch norm, which no configuration enables)."""

    def __init__(self, cin: int, widths, use_bias: bool = False):
        super().__init__()
        self.linears = nn.ModuleList()
        for w in widths:
            self.linears.append(nn.Linear(cin, w, bias=use_bias))
            cin = w

    def forward(self, x):
        for lin in self.linears:
            x = F.relu(lin(x))
        return x


def sample_gridpoints(boxes, m: int, u=None, generator=None):
    """(B, N, 7) boxes -> (B, N, m, 3) points inside each box. ``u`` are
    the uniform draws in [0, 1) (B, N, m, 3), e.g. JAX's; without them
    they are drawn on the CPU from ``generator`` (torch's default one when
    None), so a CPU run and a card run with one seed draw the same."""
    b, n, _ = boxes.shape
    if u is None:
        u = torch.rand((b, n, m, 3), generator=generator)
    with annotate("sync"):
        u = u.to(device=boxes.device, dtype=boxes.dtype)
    u = u - 0.5
    local = boxes[:, :, None, 3:6] * u
    yaw = boxes[..., 6][:, :, None]
    c, s = torch.cos(yaw), torch.sin(yaw)
    x = local[..., 0] * c - local[..., 1] * s
    y = local[..., 0] * s + local[..., 1] * c
    return boxes[:, :, None, 0:3] + torch.stack([x, y, local[..., 2]], dim=-1)


class RoiGridPool(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        g = cfg.gridpool
        self.m = g.num_gridpoints
        self.sa = SetAbstractionMSG(g.mlps_pn[0][0], g.radii_pn, cfg.samples_pn,
                                    [w[1:] for w in g.mlps_pn])
        self.mlp = MLP(g.mlps_reduction[0], g.mlps_reduction[1:])

    def forward(self, proposals, keypoints, keypoint_features, keypoint_mask,
                u=None, generator=None):
        """proposals (B, N, 7), keypoints (B, K, 3), features (B, K, C) ->
        pooled (B, N, mlps_reduction[-1])."""
        b, n, _ = proposals.shape
        grid = sample_gridpoints(proposals, self.m, u, generator).reshape(
            b, n * self.m, 3)
        feats = self.sa(keypoints, keypoint_features, keypoint_mask, grid)
        return self.mlp(feats.reshape(b, n, -1))


class RefinementLayer(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.box_dof = cfg.box_dof
        self.mlp = MLP(cfg.gridpool.mlps_reduction[-1], cfg.refinement.mlps,
                       use_bias=True)
        self.out = nn.Linear(cfg.refinement.mlps[-1], cfg.box_dof + 1)

    def forward(self, pooled):
        """pooled (B, N, C) -> (box_deltas (B, N, 7), score_logits (B, N))."""
        out = self.out(self.mlp(pooled))
        return out[..., :self.box_dof], out[..., self.box_dof]


def apply_refinements(box_deltas, proposals):
    """Residuals decode against the proposal as the anchor (stage 1's codec)."""
    return decode(box_deltas, proposals)


def refine_topk(boxes, scores, k: int):
    """The top k refined boxes by confidence, no NMS: boxes (B, N, 7),
    scores (B, N) -> ((B, k, 7), (B, k), indices (B, k)). Ties go to the
    lower index, as ``jax.lax.top_k`` breaks them: a stable descending
    sort, sliced."""
    sc, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    sc, idx = sc[:, :k], idx[:, :k]
    return torch.gather(boxes, 1, idx[..., None].expand(-1, -1, boxes.shape[-1])), sc, idx


def refinement_loss(box_deltas, score_logits, proposals, proposal_valid,
                    gt_boxes, gt_mask, cfg: Config, fg_iou: float = 0.55):
    """Confidence BCE over the valid proposals plus smooth-L1 on
    ``encode(matched gt, proposal)`` over the foreground ones, as
    ``vision3d_tpu/models/refinement.py:129``: each proposal matches its
    highest rotated-BEV-IoU gt (``cfg.iou_angle_mode``, the lowest index
    among ties, as ``jnp.argmax``) and is foreground at IoU >= ``fg_iou``;
    each term is normalised by its count over the (global) batch clamped
    to 1. box_deltas (B, N,
    7), score_logits (B, N), proposals (B, N, 7), proposal_valid (B, N),
    gt_boxes (B, G, 7), gt_mask (B, G) -> dict(refine_cls_loss,
    refine_reg_loss, refine_loss).

    The match takes no gradient (a comparison in JAX too); the target
    carries it into the proposals. One difference, where JAX's gradient
    is not finite: a background proposal's residual is taken against the
    proposal itself, not its matched gt. The term is masked out either
    way, so the loss and its gradients are JAX's wherever those are
    finite; but in a frame with no gt JAX matches a zero-size padding box,
    whose log-size residual is -inf, and the gradient of the masked term
    is NaN in every parameter."""
    g = gt_boxes.shape[1]
    with torch.no_grad():
        with annotate("sync"):
            props_bev, gt_bev = proposals[..., _BEV_COLS], gt_boxes[..., _BEV_COLS]
        iou = pairwise_rotated_iou(props_bev, gt_bev, cfg.iou_angle_mode)  # (B, N, G)
        iou = torch.where(gt_mask[:, None, :], iou, 0.0)
        best = iou.amax(dim=2)
        gidx = torch.arange(g, device=iou.device)
        match = torch.where(iou == best[..., None], gidx, g).amin(dim=2)
        fg = (best >= fg_iou) & proposal_valid
    matched = torch.gather(gt_boxes, 1, match[..., None].expand(-1, -1, gt_boxes.shape[-1]))
    target = encode(torch.where(fg[..., None], matched, proposals), proposals)
    valid = proposal_valid.to(score_logits.dtype)
    lbl = fg.to(score_logits.dtype)
    x = score_logits
    bce = x.clamp(min=0) - x * lbl + torch.log1p(torch.exp(-x.abs()))
    counts = global_sum(torch.stack([valid.sum(), lbl.sum()])).clamp(min=1.0)
    cls_loss = (bce * valid).sum() / counts[0]
    reg = smooth_l1(box_deltas, target).sum(-1)
    reg_loss = (reg * lbl).sum() / counts[1]
    return dict(refine_cls_loss=cls_loss, refine_reg_loss=reg_loss,
                refine_loss=cls_loss + reg_loss)
