"""PV-RCNN point-voxel detector, inference and training forward (port of
``vision3d_tpu/models/pvrcnn.py``).

Stage 1 samples ``num_keypoints`` FPS keypoints from the raw cloud, runs
SECOND's voxel trunk (voxelize, ``SpMiddleFHD`` with its four scales, RPN,
proposal head), gathers keypoint features from five sources (the raw
points with their intensity, then the voxel scales at strides 1, 2, 4, 8)
by multi-scale set abstraction, and samples the RPN's BEV map bilinearly
at the keypoints. Stage 2 weights each keypoint's features by its
foreground probability (the keypoint-segmentation head), pools them on a
grid inside each stage-1 proposal and refines the proposals. A model built
with ``two_stage=False`` has no stage-2 modules, as the JAX package's
``create_pvrcnn(two_stage=False)`` tree has none (the tree that
``train_cli --model pvrcnn`` trains).

FPS keypoints and ball-query indices are computed without gradient; every
float path of the JAX model carries it (the JAX package stops no
gradient): the point branch back into the stage outputs and the RPN, the
grid points back into the proposals' deltas.

Everything but the middle extractor's sparse convs is plain PyTorch: FPS,
ball query and grouping are XLA code in the JAX package, and the shared
MLPs are cuBLAS GEMMs. On the voxel backend the convs are the ``zwin_conv``
CUDA kernel in inference, ``gather_gemm`` and ``gather_rows`` in training;
on the column backend (``cfg.sparse_backend = "column"``) they are
``column_conv``, forward and dX, with ``gather_rows`` for dW, and the
trunk's column scales are read back as voxels at each stage's voxel
capacity. One state dict serves both backends.
"""

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.core.anchors import make_anchors
from vision3d_tpu_torch.models.head import (Detections, decode_proposals,
                                            multiclass_nms)
from vision3d_tpu_torch.models.pointnet import SetAbstractionMSG, SharedMLP
from vision3d_tpu_torch.models.refinement import (RefinementLayer, RoiGridPool,
                                                  apply_refinements, refine_topk)
from vision3d_tpu_torch.models.second import _TRUNC_STD, Second, init_second
from vision3d_tpu_torch.models.sparse_cnn import to_global
from vision3d_tpu_torch.ops.fps import sample_keypoints
from vision3d_tpu_torch.training.profiler import annotate


def bev_bilinear_gather(bev, keypoints_xy, cfg: Config):
    """Bilinear sample of the BEV map at metric keypoint xy: bev
    (B, ny, nx, C) (an NHWC view of the RPN's NCHW output does), keypoints_xy
    (B, K, 2) -> (B, K, C). Pixel coords (xy - offset) / (voxel * stride),
    clamped to [0, dim - 1]."""
    dev = bev.device
    with annotate("sync"):
        pix = torch.tensor(cfg.voxel_size[:2], dtype=torch.float32, device=dev)
        off = torch.tensor(cfg.grid_bounds[:2], dtype=torch.float32, device=dev)
    pix = pix * cfg.strides[-1]
    b, ny, nx, _ = bev.shape
    fx = torch.clamp((keypoints_xy[..., 0] - off[0]) / pix[0], 0.0, nx - 1.0)
    fy = torch.clamp((keypoints_xy[..., 1] - off[1]) / pix[1], 0.0, ny - 1.0)
    x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
    x1, y1 = torch.clamp(x0 + 1, max=nx - 1), torch.clamp(y0 + 1, max=ny - 1)
    wx, wy = (fx - x0)[..., None], (fy - y0)[..., None]
    bidx = torch.arange(b, device=dev)[:, None]
    top = bev[bidx, y0, x0] * (1 - wx) + bev[bidx, y0, x1] * wx
    bot = bev[bidx, y1, x0] * (1 - wx) + bev[bidx, y1, x1] * wx
    return top * (1 - wy) + bot * wy


def point_mask(points, num_points):
    return (torch.arange(points.shape[1], device=points.device)[None, :]
            < num_points[:, None])


STAGE2_MODULES = ("roi_grid_pool", "refinement", "keypoint_seg")


def has_stage2(state_dict) -> bool:
    """Whether a PV_RCNN state_dict holds the stage-2 modules."""
    return any(k.split(".", 1)[0] in STAGE2_MODULES for k in state_dict)


class PV_RCNN(Second):
    """SECOND's trunk (``cnn``, ``rpn``, ``head``) plus the point branch
    (``pnets``) and, with ``two_stage``, RoI grid pooling, refinement and
    keypoint segmentation (``STAGE2_MODULES``). In eval mode ``forward``
    and ``inference`` are SECOND's: they run the BEV branch alone, which
    is all that XLA keeps of the JAX model's ``__call__`` under ``jit``
    (the keypoints and set abstraction feed no output). In training mode
    ``forward`` runs all of ``stage1``, as the JAX training step applies
    ``__call__`` with mutable batch statistics: the point branch's outputs
    reach no loss, so it runs without gradient, but its batch norms take
    the batch's statistics."""

    def __init__(self, cfg: Config, two_stage: bool = True):
        super().__init__(cfg)
        self.pnets = nn.ModuleList(
            SetAbstractionMSG(m[0][0], cfg.psa.radii[i], cfg.samples_pn,
                              [w[1:] for w in m])
            for i, m in enumerate(cfg.psa.mlps))
        self.has_stage2 = two_stage
        if two_stage:
            self.roi_grid_pool = RoiGridPool(cfg)
            self.refinement = RefinementLayer(cfg)
            self.keypoint_seg = nn.Linear(cfg.gridpool.mlps_pn[0][0],
                                          cfg.num_classes + 1)

    def stage1(self, points, num_points, point_grad: bool = True):
        """Returns (keypoints (B, K, 3), point_features (B, K, 384 + BEV
        width), cls_map, reg_map, diag). ``point_grad=False`` runs the set
        abstraction and the BEV gather without gradient."""
        cfg = self.cfg
        mask = point_mask(points, num_points)
        with torch.no_grad(), annotate("fps"):
            keypoints, _ = sample_keypoints(points[..., :3], mask, cfg.num_keypoints)
        x, cls_map, reg_map, diag, scales = self.trunk(points, num_points,
                                                       need_scales=True)
        with (contextlib.nullcontext() if point_grad else torch.no_grad(),
              annotate("point_branch")):
            sources = [(points[..., :3], points[..., 3:4], mask)]
            sources += [to_global(s, cfg, stride)
                        for s, stride in zip(scales, cfg.strides)]
            feats = [pnet(xyz, f, m, keypoints)
                     for pnet, (xyz, f, m) in zip(self.pnets, sources)]
            feats.append(bev_bilinear_gather(x.permute(0, 2, 3, 1),
                                             keypoints[..., :2], cfg))
            point_features = torch.cat(feats, dim=-1)
        return keypoints, point_features, cls_map, reg_map, diag

    def forward(self, points, num_points):
        """points (B, P, C), num_points (B,) -> (cls_map, reg_map, diag)."""
        if not self.training:
            return super().forward(points, num_points)
        _, _, cls_map, reg_map, diag = self.stage1(points, num_points,
                                                   point_grad=False)
        return cls_map, reg_map, diag

    def two_stage(self, points, num_points, anchors, generator=None, u=None):
        """Stage-1 proposals pooled on keypoint features and refined.
        ``u`` / ``generator``: the grid points' uniform draws, as
        ``refinement.sample_gridpoints`` takes them. Returns (dict of the
        stage-1 maps, keypoints, point features, proposals, their scores,
        refined deltas, confidence and segmentation logits; diag)."""
        if not self.has_stage2:
            raise ValueError("this PV_RCNN was built with two_stage=False: it has "
                             f"no stage-2 modules ({', '.join(STAGE2_MODULES)})")
        cfg = self.cfg
        keypoints, point_features, cls_map, reg_map, diag = self.stage1(
            points, num_points)
        boxes, scores = decode_proposals(cls_map, reg_map, anchors, cfg)
        b = boxes.shape[0]
        proposals = boxes.reshape(b, -1, cfg.box_dof)
        kp_mask = torch.ones(keypoints.shape[:2], dtype=torch.bool,
                             device=keypoints.device)
        seg_logits = self.keypoint_seg(point_features)
        fg = 1.0 - F.softmax(seg_logits, dim=-1)[..., -1:]
        with annotate("grid_pool"):
            pooled = self.roi_grid_pool(proposals, keypoints, point_features * fg,
                                        kp_mask, u=u, generator=generator)
        with annotate("refine"):
            box_deltas, conf_logits = self.refinement(pooled)
        return dict(cls_map=cls_map, reg_map=reg_map, keypoints=keypoints,
                    point_features=point_features, proposals=proposals,
                    proposal_scores=scores.reshape(b, -1), box_deltas=box_deltas,
                    conf_logits=conf_logits, seg_logits=seg_logits), diag

    def inference_two_stage(self, points, num_points, anchors, generator=None,
                            u=None, rerank_only: bool = False):
        """Refined boxes scored by sigmoid(confidence) * proposal score,
        then rotated NMS into ``Detections``; with ``rerank_only`` the top
        ``proposal.topk`` by that score, no NMS ((boxes, scores, indices)).
        Returns (that, diag)."""
        cfg = self.cfg
        with annotate("inference"):
            out, diag = self.two_stage(points, num_points, anchors, generator, u)
            with annotate("refine"):
                refined = apply_refinements(out["box_deltas"], out["proposals"])
                conf = torch.sigmoid(out["conf_logits"]) * out["proposal_scores"]
            b, k = refined.shape[0], cfg.proposal.topk
            if rerank_only:
                return refine_topk(refined, conf, k), diag
            return multiclass_nms(refined.reshape(b, cfg.num_classes, k, cfg.box_dof),
                                  conf.reshape(b, cfg.num_classes, k), cfg), diag


def init_pvrcnn(model: PV_RCNN, generator: torch.Generator):
    """Fresh weights as the JAX package initialises them, drawn from
    ``generator`` (a CPU generator; call before moving the model): the
    trunk as ``init_second``; the shared MLPs' Linears
    ``variance_scaling(2, fan_out, normal)`` (std sqrt(2/out), not
    truncated); the reduction / refinement MLPs and the refinement output
    normal(0.01), biases 0; the keypoint-segmentation Linear flax's
    ``lecun_normal``, a normal cut at two of its own std and widened so
    the std stays sqrt(1/in) (every weight within 2.2737 std), bias 0;
    batch norms scale 1 / bias 0 / mean 0 / var 1. The stage-2 modules are
    drawn last, so a model with ``two_stage=False`` gets the same trunk and
    point branch from the same seed."""
    init_second(model, generator)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, SharedMLP):
                for lin in mod.linears:
                    lin.weight.normal_(0.0, math.sqrt(2.0 / lin.weight.shape[0]),
                                       generator=generator)
        if not model.has_stage2:
            return model
        for lin in (list(model.roi_grid_pool.mlp.linears)
                    + list(model.refinement.mlp.linears) + [model.refinement.out]):
            lin.weight.normal_(0.0, 0.01, generator=generator)
            if lin.bias is not None:
                lin.bias.zero_()
        w = model.keypoint_seg.weight                      # (out, in)
        s = math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD
        torch.nn.init.trunc_normal_(w, 0.0, s, -2.0 * s, 2.0 * s, generator=generator)
        model.keypoint_seg.bias.zero_()
    return model


def create_pvrcnn(cfg: Config, device="cuda", state_dict=None,
                  two_stage: bool = True):
    """An eval-mode PV_RCNN on ``device`` and its anchor tensor: weights
    from ``state_dict`` (``convert.py`` or a ``train_cli`` checkpoint),
    loaded strictly, else fresh from ``init_pvrcnn`` with a CPU generator
    seeded 0 (the JAX CLI's ``PRNGKey(0)`` init). ``two_stage=False``
    builds the stage-1 model; a two-stage model asked of a stage-1
    ``state_dict`` raises, naming the missing modules."""
    if two_stage and state_dict is not None and not has_stage2(state_dict):
        raise ValueError(
            "a two-stage PV-RCNN needs the stage-2 modules "
            f"({', '.join(STAGE2_MODULES)}); these weights are a stage-1 tree "
            "(train_cli --model pvrcnn): evaluate them with --model pvrcnn")
    model = PV_RCNN(cfg, two_stage=two_stage)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_pvrcnn(model, torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    anchors = torch.as_tensor(make_anchors(cfg), device=device)
    return model, anchors


__all__ = ["Detections", "PV_RCNN", "STAGE2_MODULES", "bev_bilinear_gather",
           "create_pvrcnn", "has_stage2", "init_pvrcnn"]
