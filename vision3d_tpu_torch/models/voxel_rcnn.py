"""Voxel R-CNN (Deng et al., "Voxel R-CNN: Towards High Performance
Voxel-based 3D Object Detection", AAAI 2021, arXiv:2012.15712), inference,
as OpenPCDet's ``tools/cfgs/kitti_models/voxel_rcnn_car.yaml`` builds it.
The port's own: the JAX package has no Voxel R-CNN.

Stage 1 is SECOND's trunk (``Second.trunk``) on ``VoxelBackBone8x``, all
stages sparse, with ``BaseBEVBackbone`` and the proposal head, and the top
``proposal.topk`` anchors a frame by score as RoIs (``decode_proposals``).
Stage 2 pools voxel features straight from the middle extractor's scales
at strides 2, 4 and 8 (``x_conv2``-``x_conv4``, each block's output after
its submanifold convs): a 6^3 grid of points in
each RoI, a voxel query on each scale (``ops/voxel_query.py``, on the card
the CUDA kernel K2), a pre-MLP on the scale's voxels, the gathered rows
plus a position term, ReLU, a max over the group and an out-MLP
(``NeighborVoxelSAModuleMSG``); the three scales concatenate to 96
channels a grid point, and the RoI head's FCs give a class logit and 7
residuals, decoded in the RoI's frame. Then rotated NMS.

Departures from the published model, each kept on both sides of the
benchmark's comparison: the RoIs are the top ``proposal.topk`` by score
with no proposal NMS (OpenPCDet: NMS at IoU 0.7 over the top 2,048); the proposal head has
no direction classifier; the final score is sigmoid(class logit) and NMS
is the port's ``multiclass_nms``; the box codec clamps the log-size
residual at 10 (``core/boxes.decode``). Training is not ported: RoI
sampling, IoU-guided scores and the head's loss.
"""

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.core.anchors import make_anchors
from vision3d_tpu_torch.core.boxes import decode
from vision3d_tpu_torch.models.head import Detections, decode_proposals, multiclass_nms
from vision3d_tpu_torch.models.rpn import BaseBEVBackbone
from vision3d_tpu_torch.models.second import Second, init_second
from vision3d_tpu_torch.ops import sparse as sp
from vision3d_tpu_torch.ops.voxel_query import geometry, row_map, voxel_query
from vision3d_tpu_torch.training.profiler import annotate


def voxel_rcnn_config(cfg: Config) -> Config:
    """``cfg``'s geometry, anchors and thresholds with Voxel R-CNN's
    architecture: ``VoxelBackBone8x`` all sparse (``dense_from_stage`` 4,
    as spconv runs it), ``BaseBEVBackbone``, a proposal head 256 wide."""
    return cfg.replace(cnn="VoxelBackBone8x", dense_from_stage=4,
                       proposal=dataclasses.replace(cfg.proposal, c_in=256))


class LinearBN(nn.Module):
    """Linear without bias, then ``BatchNorm1d`` over the last axis (eps
    1e-5, torch's default, as OpenPCDet builds the head's), then ReLU where
    ``relu``. Float32 whatever the model's compute dtype."""

    def __init__(self, cin: int, cout: int, relu: bool = True):
        super().__init__()
        self.linear = nn.Linear(cin, cout, bias=False)
        self.bn = nn.BatchNorm1d(cout)
        self.relu = relu

    def forward(self, x):
        y = self.linear(x)
        y = self.bn(y.reshape(-1, y.shape[-1])).reshape(y.shape)
        return F.relu(y) if self.relu else y


def roi_grid_points(rois, n: int):
    """(B, R, 7) RoIs -> (B, R, n^3, 3) grid points: ((i + 0.5) / n - 0.5)
    times the RoI's size (x, y, z in its own frame: ``boxes[3:6]``),
    rotated by its yaw and moved to its centre; x index outermost, z
    innermost (OpenPCDet's ``get_dense_grid_points``)."""
    i = torch.arange(n, dtype=torch.float32, device=rois.device)
    frac = (i + 0.5) / n - 0.5
    gx, gy, gz = torch.meshgrid(frac, frac, frac, indexing="ij")
    u = torch.stack([gx, gy, gz], -1).reshape(-1, 3)
    local = rois[:, :, None, 3:6] * u
    yaw = rois[..., 6][:, :, None]
    c, s = torch.cos(yaw), torch.sin(yaw)
    x = local[..., 0] * c - local[..., 1] * s
    y = local[..., 0] * s + local[..., 1] * c
    return rois[:, :, None, 0:3] + torch.stack([x, y, local[..., 2]], dim=-1)


def decode_rois(residuals, rois):
    """The RoI head's (B, R, 7) residuals -> boxes: decoded (``core/boxes``,
    OpenPCDet's ``ResidualCoder``) against the RoI with its centre at the
    origin, then the centre rotated by the RoI's yaw and moved to the RoI's
    centre; the yaw is the residual plus the RoI's (OpenPCDet's
    ``generate_predicted_boxes``)."""
    local = torch.cat([torch.zeros_like(rois[..., 0:3]), rois[..., 3:]], dim=-1)
    box = decode(residuals, local)
    yaw = rois[..., 6]
    c, s = torch.cos(yaw), torch.sin(yaw)
    x = box[..., 0] * c - box[..., 1] * s
    y = box[..., 0] * s + box[..., 1] * c
    centre = torch.stack([x, y, box[..., 2]], dim=-1) + rois[..., 0:3]
    return torch.cat([centre, box[..., 3:]], dim=-1)


class VoxelPoolLayer(nn.Module):
    """One scale of ``NeighborVoxelSAModuleMSG``: ``mlp_in`` (Linear + BN)
    on every voxel, ``mlp_pos`` (Linear + BN) on each grouped voxel's
    centre less the grid point, ``mlp_out`` (Linear + BN + ReLU) after the
    max over the group."""

    def __init__(self, cin: int, mid: int, out: int):
        super().__init__()
        self.mlp_in = LinearBN(cin, mid, relu=False)
        self.mlp_pos = LinearBN(3, mid, relu=False)
        self.mlp_out = LinearBN(mid, out)


class VoxelRoIPool(nn.Module):
    """Voxel RoI pooling over the middle extractor's scales
    ``cfg.voxel_rcnn.scales`` (channels ``channels``), each with its own
    radius; the scales' outputs concatenate."""

    def __init__(self, cfg: Config, channels):
        super().__init__()
        self.cfg = cfg
        mid, out = cfg.voxel_rcnn.mlps
        self.layers = nn.ModuleList(VoxelPoolLayer(c, mid, out) for c in channels)
        # each scale's (lo, step), kept on the model's device: a copy from
        # the host in the forward would wait for the card
        self.geometry = [geometry(cfg.voxel_size, cfg.grid_bounds, cfg.strides[si])
                         for si in cfg.voxel_rcnn.scales]
        self.register_buffer("geometry_t", torch.tensor(np.stack(
            [np.stack(g) for g in self.geometry])), persistent=False)

    def forward(self, rois, scales):
        """rois (B, R, 7), scales: one ``SparseTensor`` a pooled scale ->
        (pooled (B, R, n^3, C), each scale's voxel-query rows (B, R*n^3, S)
        int32, -1 for an empty ball)."""
        v = self.cfg.voxel_rcnn
        b, r, _ = rois.shape
        with annotate("voxel_roi_pool"):
            grid = roi_grid_points(rois, v.grid_size).reshape(b, -1, 3).contiguous()
            outs, rows = [], []
            for k, (layer, st, radius) in enumerate(zip(self.layers, scales, v.pool_radius)):
                lo, step = self.geometry[k]
                with torch.no_grad(), annotate("voxel_query"):
                    idx = voxel_query(row_map(st.keys, st.mask, st.grid), st.grid, grid, lo,
                                      step, v.query_range, radius, v.nsample)
                rows.append(idx)
                outs.append(self._pool(layer, st, grid, idx, *self.geometry_t[k]))
            pooled = torch.cat(outs, dim=-1)
        return pooled.reshape(b, r, v.grid_size ** 3, -1), rows

    @staticmethod
    def _pool(layer, st, grid, idx, lo, step):
        """Group a scale's pre-MLP features and relative centres at the
        query's rows (an empty ball's rows zero), add the position term,
        ReLU, max over the group, out-MLP: (B, G, out). ``lo`` and
        ``step`` are (3,) tensors on the card."""
        b, n = st.keys.shape
        dev = grid.device
        valid = (idx[..., :1] >= 0)[..., None]                         # (B, G, 1, 1)
        flat = (idx.clamp(min=0).long()
                + torch.arange(b, device=dev)[:, None, None] * n).reshape(-1)
        feats = layer.mlp_in(st.feats.float()).reshape(b * n, -1)[flat]
        feats = feats.reshape(idx.shape + (-1,))
        zyx = sp.keys_to_coords(st.keys.reshape(-1)[flat].reshape(idx.shape), st.grid)
        centre = (zyx.flip(-1).float() + 0.5) * step + lo
        rel = torch.where(valid, centre - grid[:, :, None, :], 0.0)
        h = torch.where(valid, feats, 0.0) + layer.mlp_pos(rel)
        return layer.mlp_out(F.relu(h).amax(dim=2))


class VoxelRCNNHead(nn.Module):
    """``VoxelRCNNHead``'s FCs: the pooled grid flattened channel-major
    ((C, n, n, n), as OpenPCDet views it), ``shared_fc`` Linear + BN + ReLU
    layers, then the ``cls_fc`` and ``reg_fc`` branches of the same and
    their output Linears (with bias) to one class logit and 7 residuals.
    Dropout is off in inference."""

    def __init__(self, cfg: Config, c_in: int):
        super().__init__()
        v = cfg.voxel_rcnn

        def stack(cin, widths):
            layers = []
            for w in widths:
                layers.append(LinearBN(cin, w))
                cin = w
            return nn.Sequential(*layers), cin

        self.shared, c = stack(c_in * v.grid_size ** 3, v.shared_fc)
        self.cls, cc = stack(c, v.cls_fc)
        self.reg, cr = stack(c, v.reg_fc)
        self.cls_pred = nn.Linear(cc, 1)
        self.reg_pred = nn.Linear(cr, cfg.box_dof)

    def forward(self, pooled):
        """pooled (B, R, n^3, C) -> (class logits (B, R), residuals (B, R, 7))."""
        b, r = pooled.shape[:2]
        with annotate("rcnn_head"):
            x = self.shared(pooled.transpose(2, 3).reshape(b * r, -1))
            cls = self.cls_pred(self.cls(x)).reshape(b, r)
            reg = self.reg_pred(self.reg(x)).reshape(b, r, -1)
        return cls, reg


class VoxelRCNN(Second):
    """SECOND's trunk (``cnn``: ``VoxelBackBone8x``; ``rpn``:
    ``BaseBEVBackbone``; ``head``) plus voxel RoI pooling (``roi_pool``)
    and the RoI head (``rcnn``). ``forward`` and ``inference`` are SECOND's
    one-stage path; ``inference_two_stage`` is the model."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        specs = self.cnn.block_specs()
        channels = [specs[si - 1][1]["features"] for si in cfg.voxel_rcnn.scales]
        self.roi_pool = VoxelRoIPool(cfg, channels)
        self.rcnn = VoxelRCNNHead(cfg, cfg.voxel_rcnn.mlps[-1] * len(channels))

    def bev_backbone(self) -> nn.Module:
        return BaseBEVBackbone(self.cnn.bev_channels())

    def two_stage(self, points, num_points, anchors):
        """Returns (dict of the stage-1 maps, the RoIs (B, R, 7), each
        scale's voxel-query rows, the RoI head's class logits and
        residuals; diag, which adds ``voxel_query_empty``: grid points whose
        ball was empty, summed over the scales)."""
        cfg = self.cfg
        _, cls_map, reg_map, diag, scales = self.trunk(points, num_points, need_scales=True)
        rois, _ = decode_proposals(cls_map, reg_map, anchors, cfg)
        b = rois.shape[0]
        rois = rois.reshape(b, -1, cfg.box_dof)
        pooled, rows = self.roi_pool(rois, [scales[i] for i in cfg.voxel_rcnn.scales])
        diag["voxel_query_empty"] = sum((r[..., 0] < 0).sum() for r in rows)
        cls, reg = self.rcnn(pooled)
        return dict(cls_map=cls_map, reg_map=reg_map, rois=rois, rows=rows, rcnn_cls=cls,
                    rcnn_reg=reg), diag

    def inference_two_stage(self, points, num_points, anchors):
        """Boxes decoded from the RoI head, scored sigmoid(class logit), then
        rotated NMS into ``Detections``. Returns (Detections, diag)."""
        cfg = self.cfg
        with annotate("inference"):
            out, diag = self.two_stage(points, num_points, anchors)
            with annotate("decode"):
                boxes = decode_rois(out["rcnn_reg"], out["rois"])
                scores = torch.sigmoid(out["rcnn_cls"])
            b = boxes.shape[0]
            k = boxes.shape[1] // cfg.num_classes
            return multiclass_nms(boxes.reshape(b, cfg.num_classes, k, cfg.box_dof),
                                  scores.reshape(b, cfg.num_classes, k), cfg), diag


def init_voxel_rcnn(model: VoxelRCNN, generator: torch.Generator):
    """Fresh weights drawn from ``generator`` (a CPU generator; call before
    moving the model): the trunk as ``init_second``; then as OpenPCDet
    initialises the RoI head: the pooling Linears Kaiming-normal (std
    sqrt(2/in)), the FCs Xavier-normal (std sqrt(2/(in+out))), the class
    output normal(0.01), the residual output normal(0.001), biases 0; batch
    norms scale 1 / bias 0 / mean 0 / var 1."""
    init_second(model, generator)
    with torch.no_grad():
        for layer in model.roi_pool.layers:
            for m in (layer.mlp_in, layer.mlp_pos, layer.mlp_out):
                w = m.linear.weight
                w.normal_(0.0, math.sqrt(2.0 / w.shape[1]), generator=generator)
        for seq in (model.rcnn.shared, model.rcnn.cls, model.rcnn.reg):
            for m in seq:
                w = m.linear.weight
                w.normal_(0.0, math.sqrt(2.0 / (w.shape[0] + w.shape[1])), generator=generator)
        model.rcnn.cls_pred.weight.normal_(0.0, 0.01, generator=generator)
        model.rcnn.reg_pred.weight.normal_(0.0, 0.001, generator=generator)
        model.rcnn.cls_pred.bias.zero_()
        model.rcnn.reg_pred.bias.zero_()
    return model


def create_voxel_rcnn(cfg: Config, device="cuda", state_dict=None):
    """An eval-mode VoxelRCNN on ``device`` and its anchor tensor: weights
    from ``state_dict``, loaded strictly, else fresh from
    ``init_voxel_rcnn`` with a CPU generator seeded 0. ``cfg`` names Voxel
    R-CNN's architecture as ``voxel_rcnn_config`` gives it."""
    model = VoxelRCNN(cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_voxel_rcnn(model, torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    anchors = torch.as_tensor(make_anchors(cfg), device=device)
    return model, anchors


__all__ = ["Detections", "VoxelRCNN", "create_voxel_rcnn", "decode_rois", "init_voxel_rcnn",
           "roi_grid_points", "voxel_rcnn_config"]
