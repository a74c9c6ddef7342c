"""SECOND one-stage voxel detector, inference and training forward (port
of ``vision3d_tpu/models/second.py``).

points -> voxelize + mean VFE -> the sparse representation
``cfg.sparse_backend`` names (key-sorted voxels, or BEV columns dense in
z) -> the middle extractor ``cfg.cnn`` names -> BEV -> RPN -> proposal
head; ``inference`` also decodes against the anchor grid and runs rotated
NMS. The capacity diagnostics the JAX model sows are returned as a dict
of 0-d int tensors next to the outputs, which nothing here reads back
(``inference``'s one read-back is NMS's, ``core/nms.py``; its copies of
host constants to the card wait for the stream too, spans ``v3d:sync``):
``voxelizer_dropped``, and on the voxel backend ``stage1_dropped``,
``stage2_dropped``, ``stage2_densify_dropped``, on the column backend
``stage0_columns_dropped`` and one ``stage{i}_columns_dropped`` per
sparse stage. In training mode
(``model.train()``, either backend) the stages before
``cfg.train_dense_from_stage`` run sparse, and the voxel backend's
counters are ``voxelizer_dropped`` and one ``stage{i}_dropped`` per
sparse stage (its training cutover has no column cap).
"""

import math

import torch
from torch import nn

from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.core.anchors import make_anchors
from vision3d_tpu_torch.core.voxelize import mean_vfe, voxelize_batch
from vision3d_tpu_torch.models.head import Detections, ProposalHead, head_inference
from vision3d_tpu_torch.models.rpn import RPN
from vision3d_tpu_torch.models.sparse_cnn import (CNN_FACTORY, from_voxels,
                                                  from_voxels_columns)
from vision3d_tpu_torch.training.profiler import annotate


def build_middle_input(cfg: Config, vox):
    """Voxelizer output -> (the configured sparse representation, the
    per-sample count of active BEV columns the stage-0 column capacity
    truncated: None on the voxel backend, whose capacity is the
    voxelizer's own ``max_voxels``)."""
    feats = mean_vfe(vox["features"], vox["occupancy"])
    if cfg.sparse_backend == "column":
        return from_voxels_columns(feats, vox["coords"], vox["voxel_mask"],
                                   cfg.grid_shape_zyx,
                                   cfg.stage_column_capacity(0))
    return from_voxels(feats, vox["coords"], vox["voxel_mask"],
                       cfg.grid_shape_zyx), None


class Second(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        if cfg.sparse_backend not in ("voxel", "column"):
            raise ValueError(f"unknown sparse_backend {cfg.sparse_backend!r}")
        self.cfg = cfg
        self.cnn = CNN_FACTORY[cfg.cnn](cfg)
        self.rpn = self.bev_backbone()
        self.head = ProposalHead(cfg)

    def bev_backbone(self) -> nn.Module:
        """The BEV backbone between the middle extractor and the head: the
        RPN, ``proposal.c_in`` wide."""
        c = self.cfg.proposal.c_in
        return RPN(c_in=c, c_down=c, c_up=c)

    def trunk(self, points, num_points, need_scales: bool = False):
        """Voxelize, middle extractor, RPN, head: (RPN output (B, C, ny, nx),
        cls_map, reg_map, diag, and with ``need_scales`` the middle
        extractor's four scales, else None)."""
        cfg = self.cfg
        with annotate("voxelize"):
            vox = voxelize_batch(points, num_points, cfg)
            diag = {"voxelizer_dropped":
                    (vox["num_voxels_total"] - vox["num_voxels"]).sum()}
            st, col_dropped = build_middle_input(cfg, vox)
        if col_dropped is not None:
            diag["stage0_columns_dropped"] = col_dropped.sum()
        with annotate("middle"):
            bev, cnn_diag, *scales = self.cnn(st, need_scales=need_scales)
        diag.update({k: v.sum() for k, v in cnn_diag.items()})
        with annotate("rpn"):
            x = self.rpn(bev.permute(0, 3, 1, 2).float())
        with annotate("head"):
            cls_map, reg_map = self.head(x)
        return x, cls_map, reg_map, diag, (scales[0] if scales else None)

    def forward(self, points, num_points):
        """points (B, P, C), num_points (B,) -> (cls_map, reg_map, diag)."""
        _, cls_map, reg_map, diag, _ = self.trunk(points, num_points)
        return cls_map, reg_map, diag

    def inference(self, points, num_points, anchors):
        """Points in, NMS-filtered fixed-capacity boxes out.
        Returns (Detections, diagnostics)."""
        with annotate("inference"):
            cls_map, reg_map, diag = self(points, num_points)
            return head_inference(cls_map, reg_map, anchors, self.cfg), diag


# std of a unit normal cut at +-2 (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def init_second(model: Second, generator: torch.Generator):
    """Fresh weights as the JAX package initialises them, drawn from
    ``generator`` (a CPU generator; call before moving the model):
    sparse convs ``variance_scaling(2, fan_out, normal)`` (std
    sqrt(2/Cout)), RPN (or BEV backbone) convs and transposed convs
    xavier-normal as flax draws it (a normal cut
    at two of its own std and widened so the std stays sqrt(2/fan_avg):
    every weight within 2.2737 std), head kernels normal(0.01), the cls
    bias at the focal prior -log((1-p)/p) with p = 0.01
    (``vision3d_tpu/models/head.py:54-60``); batch norms keep their
    constructors' scale 1 / bias 0 / mean 0 / var 1. The two frameworks
    draw different numbers from a seed; only the distributions agree."""
    with torch.no_grad():
        for conv in list(model.cnn.subm) + list(model.cnn.down):
            conv.weight.normal_(0.0, math.sqrt(2.0 / conv.weight.shape[1]),
                                generator=generator)
        for conv in model.rpn.modules():
            if not isinstance(conv, (nn.Conv2d, nn.ConvTranspose2d)):
                continue
            w = conv.weight                   # (Cout, Cin, kh, kw) or (Cin, Cout, kh, kw)
            fan = (w.shape[0] + w.shape[1]) * w.shape[2] * w.shape[3]
            s = math.sqrt(2.0 / fan) / _TRUNC_STD
            torch.nn.init.trunc_normal_(w, 0.0, s, -2.0 * s, 2.0 * s,
                                        generator=generator)
        prior = 0.01
        model.head.conv_cls.weight.normal_(0.0, 0.01, generator=generator)
        model.head.conv_cls.bias.fill_(-math.log((1 - prior) / prior))
        model.head.conv_reg.weight.normal_(0.0, 0.01, generator=generator)
        model.head.conv_reg.bias.zero_()
    return model


def create_second(cfg: Config, device="cuda", state_dict=None):
    """Build an eval-mode Second on ``device`` and its anchor tensor;
    ``state_dict`` (from ``convert.py``) loads weights, strictly. (A model
    to train, with fresh weights, comes from
    ``training.train.create_train_state``.)"""
    model = Second(cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model = model.to(device).eval()
    anchors = torch.as_tensor(make_anchors(cfg), device=device)
    return model, anchors


__all__ = ["Detections", "Second", "create_second", "init_second"]
