"""Proposal target assignment, anchors vs ground truth (port of
``vision3d_tpu/core/targets.py:40-117``), and PV-RCNN's keypoint-radius
targets (``:149-225``).

Per class: rotated BEV IoU of that class's gt boxes against the class's
anchor grid; anchors stratified into {background 0, ignore -1, positive
+1} by the class's (low, high) thresholds; optionally the best anchor(s)
per gt rescued (``allow_low_quality_matches``); the per-box ignore mask
applied; then classification targets (ignore -> mask) and VoxelNet-encoded
regression targets at positive sites. With no gt of a class every anchor is
background. ``subsample_labels`` (``:120``, unused by the models; part of
the public ops surface) draws a balanced positive / negative subsample.

Keypoint targets: a keypoint within its class's ``radius`` of a gt centre
is a positive of that class; one-hot class targets carry a background and
an ignore channel.
"""

from typing import NamedTuple

import torch

from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.core.boxes import encode
from vision3d_tpu_torch.core.iou import pairwise_rotated_iou_chunked
from vision3d_tpu_torch.ops.fps import squared_distance
from vision3d_tpu_torch.training.profiler import annotate

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
    with annotate("sync"):
        own, boxes_bev = anchors_flat[..., _BEV_COLS], boxes[..., None, _BEV_COLS]
    iou_own = pairwise_rotated_iou_chunked(
        boxes_bev, own[class_idx.clamp(0, n_cls - 1).long()],
        angle_mode=cfg.iou_angle_mode, chunk=iou_chunk)[:, :, 0]   # (B, G, A)

    with annotate("sync"):
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


def subsample_choice(labels, u_pos, u_neg, num_samples, positive_fraction,
                     bg_label=0):
    """The choice of ``subsample_labels`` given its uniform scores ``u_pos``
    and ``u_neg`` (each ``labels.shape``): at most ``int(num_samples *
    positive_fraction)`` positives (labels neither -1 nor ``bg_label``),
    the rest of ``num_samples`` negatives (``bg_label``), each set the
    lowest-scoring of its members (non-members score 2.0, stable sort).
    Returns (pos_mask, neg_mask) bool over ``labels``."""
    pos = (labels != -1) & (labels != bg_label)
    neg = labels == bg_label
    num_pos = pos.sum().clamp(max=int(num_samples * positive_fraction))
    num_neg = neg.sum().clamp(max=num_samples - num_pos)

    def pick(u, mask, count):
        order = torch.sort(torch.where(mask, u, 2.0), stable=True).indices
        keep = torch.zeros_like(mask)
        keep[order] = torch.arange(len(order), device=labels.device) < count
        return keep

    return pick(u_pos, pos, num_pos), pick(u_neg, neg, num_neg)


def subsample_labels(generator, labels, num_samples, positive_fraction, bg_label=0):
    """Pos/neg balanced random subsample (reference matcher.py:133-174):
    ``subsample_choice`` on two (N,) uniform draws from ``generator`` (a
    CPU generator; JAX draws the same distribution from its key's two
    halves). Returns (pos_mask, neg_mask) bool over ``labels`` (N,)."""
    u = torch.rand((2,) + tuple(labels.shape), generator=generator).to(labels.device)
    return subsample_choice(labels, u[0], u[1], num_samples, positive_fraction,
                            bg_label)


def assign_refinement_targets_keypoints(neg, keypoints, gt_boxes, gt_class,
                                        gt_mask, cfg: Config):
    """``vision3d_tpu/core/targets.py:149``, batched over B. Every keypoint
    starts as ignore; the ``neg`` keypoints (B, refinement_num_negatives)
    indices, JAX's ``randint`` draws) become background; a keypoint within
    the ``radius`` of exactly one class's gt centres becomes a positive of
    that class, one within several classes' falls back to background.
    Regression targets at the positives: (gt centre - keypoint, size
    residual against the class's anchor ``wlh``, gt yaw) of the nearest
    in-radius gt of that class (the lowest index among ties).

    keypoints (B, K, 3), gt_boxes (B, G, 7), gt_class (B, G), gt_mask (B, G)
    -> (cls_targets (B, K, n_cls + 2) one-hot float, reg_targets (B, K,
    n_cls, 7)). The distance is rounded as XLA's CPU code fuses
    ``jnp.linalg.norm`` (``ops.fps.squared_distance``), so the radius
    tests equal JAX's."""
    n_cls = cfg.num_classes
    bsz, k = keypoints.shape[:2]
    g = gt_boxes.shape[1]
    dev = keypoints.device
    with annotate("sync"):
        radii = torch.tensor([a.radius for a in cfg.anchors[:n_cls]],
                             dtype=torch.float32, device=dev)
        sizes = torch.tensor([a.wlh for a in cfg.anchors[:n_cls]],
                             dtype=torch.float32, device=dev)
    cls = gt_class.long()

    d = torch.sqrt(squared_distance(keypoints[:, :, None, :],
                                    gt_boxes[:, None, :, 0:3]))         # (B, K, G)
    in_radius = (d < radii[cls][:, None, :]) & gt_mask[:, None, :]
    onehot = cls[..., None] == torch.arange(n_cls, device=dev)          # (B, G, n_cls)
    per_cls = (in_radius[..., None] & onehot[:, None]).any(dim=2)       # (B, K, n_cls)

    cls_t = torch.zeros((bsz, k, n_cls + 2), device=dev)
    cls_t[..., -1] = 1.0
    bidx = torch.arange(bsz, device=dev)[:, None]
    cls_t[bidx, neg.long(), -2] = 1.0
    cls_t[bidx, neg.long(), -1] = 0.0
    n_hit = per_cls.sum(dim=2)
    pos_row = torch.cat([per_cls.float(), torch.zeros((bsz, k, 2), device=dev)], dim=-1)
    cls_t = torch.where((n_hit == 1)[..., None], pos_row, cls_t)
    bg_row = torch.zeros(n_cls + 2, device=dev)
    bg_row[-2] = 1.0
    cls_t = torch.where((n_hit > 1)[..., None], bg_row, cls_t)

    # the nearest in-radius gt of each class, per keypoint
    d_cls = torch.where(onehot.permute(0, 2, 1)[:, :, None, :] & in_radius[:, None],
                        d[:, None], float("inf"))                       # (B, n_cls, K, G)
    is_min = d_cls == d_cls.amin(dim=-1, keepdim=True)
    g_idx = torch.where(is_min, torch.arange(g, device=dev), g).amin(dim=-1)
    gt_sel = torch.gather(gt_boxes[:, None].expand(-1, n_cls, -1, -1), 2,
                          g_idx[..., None].expand(-1, -1, -1, gt_boxes.shape[-1]))
    size = sizes[None, :, None, :]
    reg = torch.cat([gt_sel[..., 0:3] - keypoints[:, None],
                     (gt_sel[..., 3:6] - size) / size, gt_sel[..., 6:7]], dim=-1)
    reg = torch.where(per_cls.permute(0, 2, 1)[..., None], reg, 0.0)
    return cls_t, reg.permute(0, 2, 1, 3)
