"""Voxel R-CNN (Deng et al., AAAI 2021, arXiv:2012.15712; OpenPCDet
``kitti_models/voxel_rcnn_car.yaml``), both stages, on the benchmark: the
model file that a configuration names with ``"bench": {"model":
"voxel_rcnn"}``.

The reference is built on ``harness/reference.py``'s primitives (voxelizer,
sparse conv on its own active sets and neighbour pairs, batch norm, linear,
codec, rotated NMS; float8 control) with what this architecture adds:
``VoxelBackBone8x``, ``BaseBEVBackbone``, the top ``proposal.topk``
anchors as RoIs, the 6^3 grid points, the voxel query (a scan of each grid
point's window of the reference's own sorted key table), voxel RoI pooling
and the RoI head. The grid points' arithmetic and the query's float32
rounding are frozen copies of the port's plain versions
(``vision3d_tpu_torch/models/voxel_rcnn.roi_grid_points``,
``ops/voxel_query.voxel_query_plain``), so that both sides choose the same
voxels. The port's own departures from the published model (top-``topk``
RoIs without proposal NMS; no direction classifier; sigmoid score; the port's NMS) are the
reference's too.

Weights follow the port's ``init_voxel_rcnn`` (a frozen copy): the trunk as
SECOND's file draws it (BEV-backbone convs and transposed convs
Xavier-normal cut at two standard deviations), the pooling Linears
normal(0, sqrt(2/in)), the FCs normal(0, sqrt(2/(in + out))), the class
output normal(0.01) and the residual output normal(0.001), biases 0; batch
norms scale 1, bias 0.

This file imports the port's Voxel R-CNN when it is loaded, so a tree
without it fails at once.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from harness import compare, files, reference as ref, weights
from harness.compare import (choice_gap, decoded_at, mismatches, nms_mismatch, program_choice,
                             rel_gap)
from vision3d_tpu_torch.models.voxel_rcnn import VoxelRCNN

second = files.model("second")

# VoxelBackBone8x: submanifold widths, then the strided conv's (width,
# kernel, stride, pad), ZYX
BLOCKS = (
    ((16, 16), (32, (3, 3, 3), (2, 2, 2), (1, 1, 1))),
    ((32, 32), (64, (3, 3, 3), (2, 2, 2), (1, 1, 1))),
    ((64, 64), (64, (3, 3, 3), (2, 2, 2), (0, 1, 1))),
    ((64, 64), (128, (3, 1, 1), (2, 1, 1), (0, 0, 0))),
)
# BaseBEVBackbone: (extra convs, stride, width, upsampling stride, its width)
BEV = ((5, 1, 64, 1, 128), (5, 2, 128, 2, 128))
CLAMP = 64          # the grid point's cell is clamped this far outside the grid
QUERY_BUDGET = 1 << 24


def bev_width(cfg):
    """The BEV map's channels: the last stage's width times its z extent."""
    d = ref.grid_zyx(cfg)[0]
    for _, (_, k, s, p) in BLOCKS:
        d = (d + 2 * p[0] - k[0]) // s[0] + 1
    return BLOCKS[-1][1][0] * d


def param_shapes(cfg: dict) -> dict:
    """{name: (shape, (kind, parameter))} in the program's state-dict
    order: the middle extractor, the BEV backbone, the head, voxel RoI
    pooling and the RoI head."""
    out = {}
    cin, li = cfg["c_in"], 0
    for chans, (cout, kernel, _, _) in BLOCKS:
        for ch in chans:
            out[f"cnn.subm.{li}.weight"] = ((27 * cin, ch), ("normal", math.sqrt(2.0 / ch)))
            weights.bn(f"cnn.subm.{li}.bn", ch, out)
            cin, li = ch, li + 1
        cin = cout
    for si, (chans, (cout, kernel, _, _)) in enumerate(BLOCKS):
        kv = kernel[0] * kernel[1] * kernel[2]
        out[f"cnn.down.{si}.weight"] = ((kv * chans[-1], cout), ("normal", math.sqrt(2.0 / cout)))
        weights.bn(f"cnn.down.{si}.bn", cout, out)
    cin = bev_width(cfg)
    for i, (n, _, c, us, uc) in enumerate(BEV):
        for j in range(n + 1):
            ci = cin if j == 0 else c
            s = math.sqrt(2.0 / ((c + ci) * 9)) / weights.TRUNC_STD
            out[f"rpn.blocks.{i}.{j}.0.weight"] = ((c, ci, 3, 3), ("trunc", s))
            weights.bn(f"rpn.blocks.{i}.{j}.1", c, out, tracked=True)
        s = math.sqrt(2.0 / ((c + uc) * us * us)) / weights.TRUNC_STD
        out[f"rpn.deblocks.{i}.0.weight"] = ((c, uc, us, us), ("trunc", s))
        weights.bn(f"rpn.deblocks.{i}.1", uc, out, tracked=True)
        cin = c
    c = cfg["proposal"]["c_in"]
    n = cfg["num_classes"] * len(cfg["anchors"][0]["yaw"])
    out["head.conv_cls.weight"] = ((n, c, 1, 1), ("normal", 0.01))
    out["head.conv_cls.bias"] = ((n,), ("const", -math.log((1 - second.PRIOR) / second.PRIOR)))
    out["head.conv_reg.weight"] = ((n * 7, c, 1, 1), ("normal", 0.01))
    out["head.conv_reg.bias"] = ((n * 7,), ("const", 0.0))
    v = cfg["voxel_rcnn"]
    mid, pooled = v["mlps"]
    for k, si in enumerate(v["scales"]):
        pre = f"roi_pool.layers.{k}"
        for name, ci, co in (("mlp_in", BLOCKS[si - 1][1][0], mid), ("mlp_pos", 3, mid),
                             ("mlp_out", mid, pooled)):
            out[f"{pre}.{name}.linear.weight"] = ((co, ci), ("normal", math.sqrt(2.0 / ci)))
            weights.bn(f"{pre}.{name}.bn", co, out, tracked=True)

    def fcs(prefix, cin, widths):
        for j, w in enumerate(widths):
            out[f"{prefix}.{j}.linear.weight"] = ((w, cin), ("normal", math.sqrt(2.0 / (w + cin))))
            weights.bn(f"{prefix}.{j}.bn", w, out, tracked=True)
            cin = w
        return cin

    c = fcs("rcnn.shared", pooled * len(v["scales"]) * v["grid_size"] ** 3, v["shared_fc"])
    cc = fcs("rcnn.cls", c, v["cls_fc"])
    cr = fcs("rcnn.reg", c, v["reg_fc"])
    out["rcnn.cls_pred.weight"] = ((1, cc), ("normal", 0.01))
    out["rcnn.cls_pred.bias"] = ((1,), ("const", 0.0))
    out["rcnn.reg_pred.weight"] = ((7, cr), ("normal", 0.001))
    out["rcnn.reg_pred.bias"] = ((7,), ("const", 0.0))
    return out


# ------------------------------------------------------------- stage 1

def middle(ctx, sd, x: ref.Sparse):
    """VoxelBackBone8x: (the last stage's sites, the four scales
    ``x_conv1``-``x_conv4``: each block's output after its submanifold
    convs)."""
    scales, li = [], 0
    for si, (chans, (_, kernel, stride, pad)) in enumerate(BLOCKS):
        for _ in chans:
            pre = f"cnn.subm.{li}"
            x = ref.sparse_conv(ctx, x, sd[pre + ".weight"], (3, 3, 3), (1, 1, 1), (1, 1, 1),
                                True, f"subm{li}", si)
            x.feats = F.relu(ref.batch_norm(ctx, sd, pre + ".bn", x.feats))
            li += 1
        scales.append(x)
        pre = f"cnn.down.{si}"
        x = ref.sparse_conv(ctx, x, sd[pre + ".weight"], kernel, stride, pad, False,
                            f"down{si}", si)
        x.feats = F.relu(ref.batch_norm(ctx, sd, pre + ".bn", x.feats))
    return x, scales


def _conv(ctx, x, w, name, **kw):
    y = ctx.qg(F.conv2d(ctx.q(x), ctx.q(w), **kw))
    ctx.counts.append(dict(name=name, flops=2 * w[0].numel() * y.numel()))
    return y


def bev_backbone(ctx, sd, x):
    ups = []
    for i, (n, s, _, us, _) in enumerate(BEV):
        for j in range(n + 1):
            pre = f"rpn.blocks.{i}.{j}"
            x = _conv(ctx, x, sd[pre + ".0.weight"], pre, stride=s if j == 0 else 1, padding=1)
            x = F.relu(ref.batch_norm(ctx, sd, pre + ".1", x, channel_dim=1))
        pre = f"rpn.deblocks.{i}"
        w = sd[pre + ".0.weight"]
        u = ctx.qg(F.conv_transpose2d(ctx.q(x), ctx.q(w), stride=us))
        ctx.counts.append(dict(name=pre, flops=2 * w.numel() * x[:, 0].numel()))
        ups.append(F.relu(ref.batch_norm(ctx, sd, pre + ".1", u, channel_dim=1)))
    return torch.cat(ups, dim=1)


def stage1(ctx, sd, cfg, points, num_points):
    """(cls map (B, n_cls, n_yaw, ny, nx), reg map (..., 7), the scales)."""
    last, scales = middle(ctx, sd, ref.voxelize(points, num_points, cfg))
    x = bev_backbone(ctx, sd, ref.to_bev(last))
    b, _, ny, nx = x.shape
    n_cls, n_yaw = cfg["num_classes"], len(cfg["anchors"][0]["yaw"])
    cls = _conv(ctx, x, sd["head.conv_cls.weight"], "head_cls")
    cls = cls + sd["head.conv_cls.bias"][:, None, None]
    reg = _conv(ctx, x, sd["head.conv_reg.weight"], "head_reg")
    reg = reg + sd["head.conv_reg.bias"][:, None, None]
    return (cls.reshape(b, n_cls, n_yaw, ny, nx),
            reg.reshape(b, n_cls, n_yaw, 7, ny, nx).permute(0, 1, 2, 4, 5, 3), scales)


def own_rois(cfg, cls, reg, anchors):
    """The reference's own top ``topk`` anchors of each frame, decoded."""
    boxes, logits = ref.decode_all(cls, reg, anchors)
    _, idx = ref.topk_stable(logits, cfg["proposal"]["topk"])
    return torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 7))


# ------------------------------------------------------------- stage 2

def grid_points(rois, n):
    """(B, R, 7) -> (B, R, n^3, 3): ((i + 0.5) / n - 0.5) x the RoI's size,
    rotated by its yaw, moved to its centre; x index outermost."""
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


def scale_geometry(cfg, stride, dev):
    lo = np.asarray(cfg["grid_bounds"][:3], np.float32)
    step = np.asarray(cfg["voxel_size"], np.float32) * np.float32(stride)
    return torch.from_numpy(lo).to(dev), torch.from_numpy(step).to(dev)


def voxel_query(x: ref.Sparse, points, lo, step, ranges, radius, nsample):
    """Each grid point's scan of its window, dz outermost and dx innermost,
    over the reference's own sorted sites: (indices (B, G, nsample) into
    ``x``'s sites, -1 for an empty ball; distance tests a scan that stops
    at the ``nsample``-th hit makes: the occupied in-grid cells before it).
    Float32, each operation rounded apart, as the port's plain version."""
    d, h, w = x.dims
    b, g, _ = points.shape
    dev = points.device
    rx, ry, rz = ranges
    dz, dy, dx = torch.meshgrid(torch.arange(-rz, rz + 1), torch.arange(-ry, ry + 1),
                                torch.arange(-rx, rx + 1), indexing="ij")
    off = torch.stack([dx, dy, dz], -1).reshape(-1, 3).to(dev)
    t = off.shape[0]
    r2 = float(np.float32(radius) * np.float32(radius))
    f = torch.floor((points - lo) / step)
    f = torch.where(f >= -CLAMP, f, -CLAMP)
    cells = torch.minimum(f, torch.tensor([w, h, d], dtype=torch.float32, device=dev) + CLAMP)
    cells = cells.long()
    dims = torch.tensor([w, h, d], device=dev)
    chunk = max(1, min(g, QUERY_BUDGET // max(1, b * t)))
    bi = torch.arange(b, device=dev)[:, None, None]
    out, tests = [], 0
    for c0 in range(0, g, chunk):
        p = points[:, c0:c0 + chunk]
        nb = cells[:, c0:c0 + chunk, None, :] + off                        # (B, C, T, 3)
        inside = ((nb >= 0) & (nb < dims)).all(-1)
        nbc = nb.clamp(min=0)
        key = ((bi * h + nbc[..., 1]) * w + nbc[..., 0]) * d + nbc[..., 2]
        pos = torch.searchsorted(x.key, key.reshape(-1)).clamp(max=len(x.key) - 1)
        pos = pos.reshape(key.shape)
        occupied = inside & (x.key[pos] == key)
        centre = (nb.float() + 0.5) * step + lo
        diff = centre - p[:, :, None, :]
        dist = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
            + diff[..., 2] * diff[..., 2]
        hit = occupied & (dist <= r2)
        rank = hit.to(torch.int32).cumsum(dim=2)
        tests += int((occupied & (rank - hit.to(torch.int32) < nsample)).sum())
        cnt = rank[..., -1:]
        slot = torch.where(hit & (rank <= nsample), rank - 1, nsample).long()
        idx = torch.full(slot.shape[:2] + (nsample + 1,), -1, dtype=torch.int64, device=dev)
        idx.scatter_(2, slot, torch.where(hit, pos, -1))
        idx = idx[..., :nsample]
        found = torch.arange(nsample, device=dev) < cnt
        out.append(torch.where(found, idx, idx[..., :1]))
    return torch.cat(out, dim=1), tests


def frame_rows(x: ref.Sparse, idx):
    """Site indices (B, G, S), -1 empty -> rows within each frame's
    key-sorted table, as the program numbers them."""
    d, h, w = x.dims
    start = torch.searchsorted(x.key, torch.arange(x.batch, device=idx.device) * (d * h * w))
    return torch.where(idx >= 0, idx - start[:, None, None], -1)


def linear_bn(ctx, sd, prefix, x, relu=True):
    w = sd[prefix + ".linear.weight"]
    ctx.counts.append(dict(name=prefix, flops=2 * w.numel() * (x.numel() // x.shape[-1])))
    y = ref.linear(ctx, x, w)
    y = ref.batch_norm(ctx, sd, prefix + ".bn", y.reshape(-1, y.shape[-1]), eps=1e-5)
    y = y.reshape(x.shape[:-1] + (-1,))
    return F.relu(y) if relu else y


def pool(ctx, sd, cfg, rois, scales):
    """Voxel RoI pooling of ``rois`` (B, R, 7) on the pooled scales:
    (pooled (B, R, n^3, C), each scale's query as the program numbers its
    rows (B, R*n^3, S))."""
    v = cfg["voxel_rcnn"]
    b, r, _ = rois.shape
    grid = grid_points(rois, v["grid_size"]).reshape(b, -1, 3).contiguous()
    outs, rows = [], []
    for k, (si, radius) in enumerate(zip(v["scales"], v["pool_radius"])):
        x = scales[si]
        lo, step = scale_geometry(cfg, cfg["strides"][si], rois.device)
        with torch.no_grad():
            idx, tests = voxel_query(x, grid, lo, step, v["query_range"], radius, v["nsample"])
        g = grid.shape[1]
        ctx.counts.append(dict(name=f"voxel_query{k}", flops=0, tests=tests,
                               bytes=b * g * (24 + 4 * v["nsample"]) + len(x.key) * 12))
        rows.append(frame_rows(x, idx))
        pre = f"roi_pool.layers.{k}"
        feats = linear_bn(ctx, sd, pre + ".mlp_in", x.feats, relu=False)
        valid = (idx[..., :1] >= 0)[..., None]
        at = idx.clamp(min=0)
        centre = (x.coords[at][..., 1:].flip(-1).float() + 0.5) * step + lo
        rel = torch.where(valid, centre - grid[:, :, None, :], 0.0)
        h = torch.where(valid, feats[at], 0.0) + linear_bn(ctx, sd, pre + ".mlp_pos", rel,
                                                             relu=False)
        outs.append(linear_bn(ctx, sd, pre + ".mlp_out", F.relu(h).amax(dim=2)))
    return torch.cat(outs, -1).reshape(b, r, v["grid_size"] ** 3, -1), rows


def rcnn(ctx, sd, cfg, pooled):
    """The RoI head's FCs: (class logits (B, R), residuals (B, R, 7))."""
    v = cfg["voxel_rcnn"]
    b, r = pooled.shape[:2]
    x = pooled.transpose(2, 3).reshape(b * r, -1)
    for j in range(len(v["shared_fc"])):
        x = linear_bn(ctx, sd, f"rcnn.shared.{j}", x)
    c, g = x, x
    for j in range(len(v["cls_fc"])):
        c = linear_bn(ctx, sd, f"rcnn.cls.{j}", c)
    for j in range(len(v["reg_fc"])):
        g = linear_bn(ctx, sd, f"rcnn.reg.{j}", g)
    for name, h in (("rcnn.cls_pred", c), ("rcnn.reg_pred", g)):
        ctx.counts.append(dict(name=name, flops=2 * sd[name + ".weight"].numel() * h.shape[0]))
    cls = ref.linear(ctx, c, sd["rcnn.cls_pred.weight"], sd["rcnn.cls_pred.bias"])
    reg = ref.linear(ctx, g, sd["rcnn.reg_pred.weight"], sd["rcnn.reg_pred.bias"])
    return cls.reshape(b, r), reg.reshape(b, r, 7)


def decode_rois(res, rois):
    """Residuals decoded against the RoI with its centre at the origin, the
    centre rotated by the RoI's yaw and moved to its centre."""
    local = torch.cat([torch.zeros_like(rois[..., 0:3]), rois[..., 3:]], dim=-1)
    box = ref.decode(res, local)
    yaw = rois[..., 6]
    c, s = torch.cos(yaw), torch.sin(yaw)
    x = box[..., 0] * c - box[..., 1] * s
    y = box[..., 0] * s + box[..., 1] * c
    return torch.cat([torch.stack([x, y, box[..., 2]], dim=-1) + rois[..., 0:3], box[..., 3:]],
                     dim=-1)


def forward(ctx, sd, cfg, batch, anchors, rois=None):
    """The reference's two stages on its own top anchors, or on ``rois``:
    dict of cls, reg, rois, pooled, rows, rcnn (logits, residuals)."""
    cls, reg, scales = stage1(ctx, sd, cfg, batch["points"], batch["num_points"])
    if rois is None:
        rois = own_rois(cfg, cls, reg, anchors)
    pooled, rows = pool(ctx, sd, cfg, rois, scales)
    return dict(cls=cls, reg=reg, rois=rois, pooled=pooled, rows=rows,
                rcnn=rcnn(ctx, sd, cfg, pooled))


# -------------------------------------------------------------- the API

@torch.no_grad()
def calibrate(cfg: dict, sd: dict, batch: dict, anchors, u=None) -> dict:
    """Every batch norm's running statistics set to those of ``batch``, the
    second stage on the reference's own RoIs. Returns ``sd``."""
    with weights.no_tf32():
        forward(ref.Ctx("calib"), sd, cfg, batch, anchors)
    return sd


def draws(seed, index, batch, cfg):
    """Voxel R-CNN draws nothing at random: its grid is regular."""
    return None


def build(pcfg, sd, dev):
    with torch.device(dev):
        model = VoxelRCNN(pcfg)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def capture(model, cur):
    """Hooks that put into ``cur`` the head's maps, the RoIs, the pooled
    features and the voxel query's rows, and the RoI head's outputs;
    returns the handles."""
    return [model.head.register_forward_hook(lambda _m, _a, o: cur.update(cls=o[0], reg=o[1])),
            model.roi_pool.register_forward_pre_hook(lambda _m, a: cur.update(rois=a[0])),
            model.roi_pool.register_forward_hook(
                lambda _m, _a, o: cur.update(pooled=o[0], rows=tuple(o[1]))),
            model.rcnn.register_forward_hook(lambda _m, _a, o: cur.update(rcnn=o))]


def infer(model, batch, anchors, u):
    det, _ = model.inference_two_stage(batch["points"], batch["num_points"], anchors)
    return det


def _detect(cfg, rois, rcnn_out):
    """Decode, score and NMS of the RoI head's outputs: (boxes, scores,
    class, valid)."""
    logits, res = rcnn_out
    boxes = decode_rois(res.float(), rois)
    scores = torch.sigmoid(logits.float())
    keep = ref.nms_keep(boxes, scores, cfg["proposal"]["nms_iou_threshold"],
                        cfg["iou_angle_mode"])
    valid = keep & (scores > cfg["anchors"][0]["score_thresh"])
    return boxes, scores, torch.zeros_like(valid, dtype=torch.int32), valid


def control(cfg, sd, batch, anchors, u):
    """The reference in float8 in the program's place: what ``capture`` and
    ``infer`` give."""
    return reference_outputs(cfg, sd, batch, anchors, quant=True)


def reference_outputs(cfg, sd, batch, anchors, quant):
    """The reference in the program's place, in float8 with ``quant``: its
    top anchors chosen and decoded as the program does it."""
    with weights.no_tf32(), torch.no_grad():
        ctx = ref.Ctx("eval", quant=quant)
        cls, reg, scales = stage1(ctx, sd, cfg, batch["points"], batch["num_points"])
        _, idx = compare.program_choice(cls, cfg["proposal"]["topk"])
        rois = compare.decoded_at(reg, anchors, idx)
        pooled, rows = pool(ctx, sd, cfg, rois, scales)
        out = dict(cls=cls, reg=reg, rois=rois, pooled=pooled, rows=tuple(rows),
                   rcnn=rcnn(ctx, sd, cfg, pooled))
        out["det"] = _detect(cfg, rois, out["rcnn"])
    return out


@torch.no_grad()
def judge(cfg, prog, batch, sd, anchors, u):
    """Numbers of one Voxel R-CNN batch. The reference runs its own stage 1
    and pools the program's RoIs (which ``choice_gap`` and
    ``decode_mismatch`` judge) on its own scales."""
    with weights.no_tf32():
        want = forward(ref.Ctx("eval"), sd, cfg, batch, anchors, rois=prog["rois"].float())
    k = cfg["proposal"]["topk"]
    _, idx = program_choice(prog["cls"], k)
    logit_p, res_p = prog["rcnn"]
    logit_r, res_r = want["rcnn"]
    boxes, scores, _, valid = prog["det"]
    rois = prog["rois"].float()
    decode = (mismatches(rois, decoded_at(prog["reg"], anchors, idx))
              + mismatches(boxes, decode_rois(res_p.float(), rois))
              + mismatches(scores, torch.sigmoid(logit_p.float())))
    return dict(cls_gap=rel_gap(prog["cls"], want["cls"]),
                reg_gap=rel_gap(prog["reg"], want["reg"]),
                choice_gap=choice_gap(want["cls"], idx, k),
                voxel_query_mismatch=sum(mismatches(p, r) for p, r in zip(prog["rows"],
                                                                          want["rows"])),
                pooled_gap=rel_gap(prog["pooled"], want["pooled"]),
                rcnn_gap=max(rel_gap(logit_p, logit_r), rel_gap(res_p, res_r)),
                decode_mismatch=decode,
                nms_mismatch=nms_mismatch(boxes, scores, valid, cfg),
                boxes_over_thresh=int((scores > cfg["anchors"][0]["score_thresh"]).sum()),
                voxel_query_empty=sum(int((r[..., 0] < 0).sum()) for r in want["rows"]))


@torch.no_grad()
def counts(cfg, sd, batch, anchors, u):
    """The reference's work of one forward, its second stage on its own
    RoIs: sparse convs on their pairs, dense layers and MLPs on their
    outputs and rows, and each voxel query's distance tests and bytes
    (``flops`` 0: float32 tests, no tensor-core work)."""
    with weights.no_tf32():
        ctx = ref.Ctx("eval")
        forward(ctx, sd, cfg, batch, anchors)
    return ctx.counts
