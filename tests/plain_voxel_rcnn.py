"""Plain reference of Voxel R-CNN inference (Deng et al., AAAI 2021,
arXiv:2012.15712; OpenPCDet ``kitti_models/voxel_rcnn_car.yaml``) in float32
PyTorch, for the CPU tests of the port's ``models/voxel_rcnn.py``.

Only ``torch`` and ``numpy``: nothing of the port, nothing of JAX. The
configuration is a plain dict (the port's ``Config`` fields, as
``dataclasses.asdict`` gives them) and the weights a state dict under the
port's names. Whole forward: the voxelizer (the mean of each voxel's first
``max_occupancy`` points in scan order), ``VoxelBackBone8x`` on its own
active sets and neighbour pairs (a sorted key table, one ``searchsorted``
a tap), the BEV map, ``BaseBEVBackbone``, the proposal head, the top
``proposal.topk`` anchors by score as RoIs, the 6^3 grid points, the voxel
query by a scan of each grid point's window, voxel RoI pooling, the RoI
head's FCs, the decode in the RoI's frame and greedy rotated NMS. TF32 is
off while it runs (``no_tf32``).

Departures from the published description, the port's own (see
``vision3d_tpu_torch/models/voxel_rcnn.py``): RoIs are the top ``topk``
by score, with no proposal NMS; no direction classifier; the score is
sigmoid(class logit), NMS one greedy pass with the port's thresholds; the
log-size residual is clamped at 10; the first-come cap on the number of
voxels is not modelled (a frame over ``max_voxels`` raises).
The grid points' arithmetic, the voxel query's scan and its float32
rounding, the box codec, the rotated IoU and NMS are frozen copies of the
port's plain versions, so that discrete choices agree bit for bit.

``Ctx("calib")`` normalises with each batch's statistics and writes them
into the state dict as running statistics (the tests' calibration of
fresh weights); ``Ctx("eval")`` uses the running statistics.
"""

import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F

# VoxelBackBone8x: submanifold widths, then the strided conv's (width,
# kernel, stride, pad), ZYX
BLOCKS = (
    ((16, 16), (32, (3, 3, 3), (2, 2, 2), (1, 1, 1))),
    ((32, 32), (64, (3, 3, 3), (2, 2, 2), (1, 1, 1))),
    ((64, 64), (64, (3, 3, 3), (2, 2, 2), (0, 1, 1))),
    ((64, 64), (128, (3, 1, 1), (2, 1, 1), (0, 0, 0))),
)
BEV_LAYERS = (5, 5)             # BaseBEVBackbone: extra convs a block
BEV_STRIDES = (1, 2)


class no_tf32:
    """TF32 off for matmuls and convolutions while the reference runs."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False


class Ctx:
    def __init__(self, mode="eval"):
        if mode not in ("eval", "calib"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode


def batch_norm(ctx, sd, prefix, x, eps, channel_dim=-1):
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    if ctx.mode == "eval":
        mean, var = sd[prefix + ".running_mean"], sd[prefix + ".running_var"]
    else:
        axes = [a for a in range(x.dim()) if a != channel_dim % x.dim()]
        mean = x.mean(dim=axes)
        var = (x - mean.view(shape)).square().mean(dim=axes)
        sd[prefix + ".running_mean"] = mean.clone()
        sd[prefix + ".running_var"] = var.clone()
    return ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + eps)
            * sd[prefix + ".weight"].view(shape) + sd[prefix + ".bias"].view(shape))


# ---------------------------------------------------------------- voxels

class Sparse:
    """Active sites: ``coords`` (N, 4) int64 (b, z, y, x) sorted by ``key``
    = ((b*H + y)*W + x)*D + z, ``feats`` (N, C), grid ``dims`` (D, H, W)."""

    def __init__(self, coords, key, feats, dims, batch):
        self.coords, self.key, self.feats = coords, key, feats
        self.dims, self.batch = tuple(dims), batch


def site_key(coords, dims):
    d, h, w = dims
    return ((coords[:, 0] * h + coords[:, 2]) * w + coords[:, 3]) * d + coords[:, 1]


def key_coords(key, dims):
    d, h, w = dims
    z = key % d
    rest = key // d
    x = rest % w
    rest = rest // w
    return torch.stack([rest // h, z, rest % h, x], dim=1)


def grid_zyx(cfg):
    vs = np.asarray(cfg["voxel_size"])
    lo, hi = np.asarray(cfg["grid_bounds"][:3]), np.asarray(cfg["grid_bounds"][3:])
    nx, ny, nz = (int(v) for v in np.round((hi - lo) / vs))
    return (nz + 1, ny, nx)


def voxelize(points, num_points, cfg) -> Sparse:
    b, p, c = points.shape
    lo = torch.tensor(cfg["grid_bounds"][:3], dtype=points.dtype)
    vs = torch.tensor(cfg["voxel_size"], dtype=points.dtype)
    cxyz = torch.floor((points[..., :3] - lo) / vs).to(torch.int64)
    dims = grid_zyx(cfg)
    nxyz = torch.tensor([dims[2], dims[1], dims[0] - 1])
    ok = ((cxyz >= 0) & (cxyz < nxyz)).all(-1)
    ok &= torch.arange(p)[None] < num_points[:, None]
    bidx = torch.arange(b)[:, None].expand(b, p)
    coords = torch.stack([bidx, cxyz[..., 2], cxyz[..., 1], cxyz[..., 0]], -1)[ok]
    key, order = torch.sort(site_key(coords, dims), stable=True)
    pts = points[ok][order]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    seg = first.cumsum(0) - 1
    starts = torch.nonzero(first)[:, 0]
    keep = torch.arange(len(key)) - starts[seg] < cfg["max_occupancy"]
    vkey = key[first]
    if int(torch.bincount(key_coords(vkey, dims)[:, 0], minlength=b).max()) > cfg["max_voxels"]:
        raise RuntimeError("plain reference: a frame has more than max_voxels voxels")
    sums = torch.zeros((len(vkey), c), dtype=points.dtype).index_add_(0, seg[keep], pts[keep])
    cnt = torch.bincount(seg[keep], minlength=len(vkey)).to(points.dtype)
    return Sparse(key_coords(vkey, dims), vkey, sums / cnt[:, None], dims, b)


def sparse_conv(x: Sparse, weight, kernel, stride, pad, subm) -> Sparse:
    """out[o] = sum over taps t of in[o*stride - pad + t] @ W[t], W laid out
    (K*Cin, Cout) with K = (dz*ky + dy)*kx + dx; a strided conv's sites are
    every output any active input reaches."""
    cin = x.feats.shape[1]
    s_t, p_t, in_dims = torch.tensor(stride), torch.tensor(pad), torch.tensor(x.dims)
    taps = list(itertools.product(*(range(k) for k in kernel)))
    if subm:
        out_dims, out_coords, out_key = x.dims, x.coords, x.key
    else:
        out_dims = tuple((d + 2 * pp - k) // s + 1
                         for d, k, s, pp in zip(x.dims, kernel, stride, pad))
        od = torch.tensor(out_dims)
        cand = []
        for t in taps:
            num = x.coords[:, 1:] + p_t - torch.tensor(t)
            o = torch.div(num, s_t, rounding_mode="floor")
            ok = ((num % s_t) == 0).all(1) & (num >= 0).all(1) & (o < od).all(1)
            cand.append(site_key(torch.cat([x.coords[ok, :1], o[ok]], 1), out_dims))
        out_key = torch.unique(torch.cat(cand))
        out_coords = key_coords(out_key, out_dims)
    out = torch.zeros((len(out_key), weight.shape[1]), dtype=x.feats.dtype)
    for ti, t in enumerate(taps):
        src = out_coords[:, 1:] * s_t - p_t + torch.tensor(t)
        inb = ((src >= 0) & (src < in_dims)).all(1)
        k = site_key(torch.cat([out_coords[:, :1], src.clamp(min=0)], 1), x.dims)
        pos = torch.searchsorted(x.key, k).clamp(max=len(x.key) - 1)
        o = torch.nonzero(inb & (x.key[pos] == k))[:, 0]
        out = out.index_add(0, o, x.feats[pos[o]] @ weight[ti * cin:(ti + 1) * cin])
    return Sparse(out_coords, out_key, out, out_dims, x.batch)


def middle(ctx, sd, x: Sparse):
    """VoxelBackBone8x: (the last stage, the four scales ``x_conv1``-
    ``x_conv4``: each block's output after its submanifold convs)."""
    scales, li = [], 0
    for si, (chans, (_, kernel, stride, pad)) in enumerate(BLOCKS):
        for _ in chans:
            pre = f"cnn.subm.{li}"
            x = sparse_conv(x, sd[pre + ".weight"], (3, 3, 3), (1, 1, 1), (1, 1, 1), True)
            x.feats = F.relu(batch_norm(ctx, sd, pre + ".bn", x.feats, 1e-3))
            li += 1
        scales.append(x)
        pre = f"cnn.down.{si}"
        x = sparse_conv(x, sd[pre + ".weight"], kernel, stride, pad, False)
        x.feats = F.relu(batch_norm(ctx, sd, pre + ".bn", x.feats, 1e-3))
    return x, scales


def to_bev(x: Sparse):
    """(B, C*D, H, W), channels c-major over (C, D)."""
    d, h, w = x.dims
    c = x.feats.shape[1]
    dense = torch.zeros((x.batch, d, h, w, c), dtype=x.feats.dtype)
    cc = x.coords
    dense = dense.index_put((cc[:, 0], cc[:, 1], cc[:, 2], cc[:, 3]), x.feats)
    return dense.permute(0, 4, 1, 2, 3).reshape(x.batch, c * d, h, w)


def bev_backbone(ctx, sd, x):
    """BaseBEVBackbone: blocks at strides 1 and 2, each upsampled back by a
    transposed conv + BN + ReLU, concatenated."""
    ups = []
    for i, (n, s) in enumerate(zip(BEV_LAYERS, BEV_STRIDES)):
        for j in range(n + 1):
            pre = f"rpn.blocks.{i}.{j}"
            x = F.conv2d(x, sd[pre + ".0.weight"], stride=s if j == 0 else 1, padding=1)
            x = F.relu(batch_norm(ctx, sd, pre + ".1", x, 1e-3, channel_dim=1))
        pre = f"rpn.deblocks.{i}"
        w = sd[pre + ".0.weight"]
        u = F.conv_transpose2d(x, w, stride=w.shape[-1])
        ups.append(F.relu(batch_norm(ctx, sd, pre + ".1", u, 1e-3, channel_dim=1)))
    return torch.cat(ups, dim=1)


def maps(ctx, sd, cfg, points, num_points):
    """Stage 1: (cls map (B, 1, n_yaw, ny, nx), reg map (..., 7), the
    scales)."""
    last, scales = middle(ctx, sd, voxelize(points, num_points, cfg))
    x = bev_backbone(ctx, sd, to_bev(last))
    b, _, ny, nx = x.shape
    n_yaw = len(cfg["anchors"][0]["yaw"])
    cls = F.conv2d(x, sd["head.conv_cls.weight"], sd["head.conv_cls.bias"])
    reg = F.conv2d(x, sd["head.conv_reg.weight"], sd["head.conv_reg.bias"])
    return (cls.reshape(b, 1, n_yaw, ny, nx),
            reg.reshape(b, 1, n_yaw, 7, ny, nx).permute(0, 1, 2, 4, 5, 3), scales)


# ------------------------------------------------------- codec, IoU, NMS

def _norm(wlh):
    diag = torch.sqrt(wlh[..., 0:1] ** 2 + wlh[..., 1:2] ** 2)
    return torch.cat([diag, diag, wlh[..., 2:3]], dim=-1)


def decode(deltas, anchors, max_wlh_delta=10.0):
    wlh = torch.clamp(deltas[..., 3:6], -max_wlh_delta, max_wlh_delta)
    return torch.cat([deltas[..., 0:3] * _norm(anchors[..., 3:6]) + anchors[..., 0:3],
                      torch.exp(wlh) * anchors[..., 3:6], deltas[..., 6:7] + anchors[..., 6:7]], -1)


def rois_of(cls, reg, anchors, k):
    """The top ``k`` anchors of each frame by score, ties to the lower
    index, decoded: ((B, k, 7), scores (B, k))."""
    b = cls.shape[0]
    scores = torch.sigmoid(cls.reshape(b, -1))
    s, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    s, idx = s[:, :k], idx[:, :k]
    deltas = torch.gather(reg.reshape(b, -1, 7), 1, idx[..., None].expand(-1, -1, 7))
    return decode(deltas, anchors.reshape(-1, 7)[idx]), s


def _corners(boxes, degrees):
    theta = boxes[..., 4] * (math.pi / 180.0 if degrees else 1.0)
    c, s = torch.cos(theta), torch.sin(theta)
    w2, h2 = boxes[..., 2] * 0.5, boxes[..., 3] * 0.5
    lx = torch.stack([-w2, w2, w2, -w2], dim=-1)
    ly = torch.stack([-h2, -h2, h2, h2], dim=-1)
    gx = lx * c[..., None] - ly * s[..., None] + boxes[..., 0:1]
    gy = lx * s[..., None] + ly * c[..., None] + boxes[..., 1:2]
    return torch.stack([gx, gy], dim=-1)


def rotated_iou(boxes1, boxes2, angle_mode="degrees"):
    """IoU of broadcast (..., 5) BEV boxes (x, y, w, l, angle)."""
    boxes1, boxes2 = torch.broadcast_tensors(boxes1, boxes2)
    shift = boxes1[..., 0:2]
    deg = angle_mode == "degrees"
    q1 = _corners(torch.cat([boxes1[..., 0:2] - shift, boxes1[..., 2:5]], -1), deg)
    q2 = _corners(torch.cat([boxes2[..., 0:2] - shift, boxes2[..., 2:5]], -1), deg)
    a, b = q1[..., :, None, :], torch.roll(q1, -1, dims=-2)[..., :, None, :]
    c, d = q2[..., None, :, :], torch.roll(q2, -1, dims=-2)[..., None, :, :]
    r, s = b - a, d - c
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = c - a
    t_num = qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]
    u_num = qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]
    nonpar = denom.abs() > 1e-14
    safe = torch.where(nonpar, denom, torch.ones_like(denom))
    t, u = t_num / safe, u_num / safe
    ivalid = nonpar & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    ipts = a + t[..., None] * r
    shape = ivalid.shape[:-2] + (16,)
    ipts, ivalid = ipts.reshape(shape + (2,)), ivalid.reshape(shape)

    def inside(pts, quad):
        qa = quad[..., None, :, :]
        qb = torch.roll(quad, -1, dims=-2)[..., None, :, :]
        p = pts[..., :, None, :]
        cross = ((qb[..., 0] - qa[..., 0]) * (p[..., 1] - qa[..., 1])
                 - (qb[..., 1] - qa[..., 1]) * (p[..., 0] - qa[..., 0]))
        return (cross >= -1e-12).all(dim=-1)

    pts = torch.cat([ipts, q1, q2], dim=-2)
    valid = torch.cat([ivalid, inside(q1, q2), inside(q2, q1)], dim=-1)
    vf = valid.to(pts.dtype)
    n = vf.sum(dim=-1, keepdim=True)
    center = (pts * vf[..., None]).sum(dim=-2, keepdim=True) / n[..., None].clamp(min=1.0)
    rel = pts - center
    ang = torch.where(valid, torch.atan2(rel[..., 1], rel[..., 0]), 1e9)
    order = torch.sort(ang, dim=-1, stable=True).indices
    pts_s = torch.gather(pts, -2, order[..., None].expand(pts.shape))
    val_s = torch.gather(valid, -1, order)
    pts_s = torch.where(val_s[..., None], pts_s, pts_s[..., 0:1, :])
    nxt = torch.roll(pts_s, -1, dims=-2)
    area = 0.5 * (pts_s[..., 0] * nxt[..., 1] - pts_s[..., 1] * nxt[..., 0]).sum(-1).abs()
    inter = torch.where(n[..., 0] >= 3, area, torch.zeros_like(area))
    union = boxes1[..., 2] * boxes1[..., 3] + boxes2[..., 2] * boxes2[..., 3] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-14), torch.zeros_like(inter))


def nms_keep(boxes, scores, iou_threshold, angle_mode):
    """Greedy rotated NMS over (B, K, 7) boxes, one class: keep (B, K) in
    the boxes' order; strict ``>``, ties in score to the lower index."""
    b, k = scores.shape
    order = torch.sort(-scores, dim=1, stable=True).indices
    bx = torch.gather(boxes[..., [0, 1, 3, 4, 6]], 1, order[..., None].expand(b, k, 5))
    iou = rotated_iou(bx[:, :, None, :], bx[:, None, :, :], angle_mode)
    rank = torch.arange(k)
    suppress = (iou > iou_threshold) & (rank[:, None] < rank[None, :])
    keep = torch.ones((b, k), dtype=torch.bool)
    for i in range(k):
        keep[:, i + 1:] &= ~(suppress[:, i, i + 1:] & keep[:, i:i + 1])
    return torch.zeros_like(keep).scatter_(1, order, keep)


# ------------------------------------------------------------- stage 2

def grid_points(rois, n):
    """(B, R, 7) -> (B, R, n^3, 3), x index outermost."""
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


def scale_geometry(cfg, stride):
    lo = torch.from_numpy(np.asarray(cfg["grid_bounds"][:3], np.float32))
    step = torch.from_numpy(np.asarray(cfg["voxel_size"], np.float32) * np.float32(stride))
    return lo, step


def voxel_query(x: Sparse, points, lo, step, ranges, radius, nsample, clamp=64):
    """Each grid point's scan of its window, dz outermost and dx innermost:
    (B, G, nsample) int64 indices into ``x``'s sites, -1 for an empty ball.
    Float32 throughout, each operation rounded apart."""
    d, h, w = x.dims
    b, g, _ = points.shape
    rx, ry, rz = ranges
    dz, dy, dx = torch.meshgrid(torch.arange(-rz, rz + 1), torch.arange(-ry, ry + 1),
                                torch.arange(-rx, rx + 1), indexing="ij")
    off = torch.stack([dx, dy, dz], -1).reshape(-1, 3)
    f = torch.floor((points - lo) / step)
    f = torch.where(f >= -clamp, f, -clamp)
    cells = torch.minimum(f, torch.tensor([w, h, d], dtype=torch.float32) + clamp).long()
    nb = cells[:, :, None, :] + off                                    # (B, G, T, 3) xyz
    inside = ((nb >= 0) & (nb < torch.tensor([w, h, d]))).all(-1)
    bi = torch.arange(b)[:, None, None].expand(nb.shape[:3])
    key = site_key(torch.stack([bi, nb[..., 2], nb[..., 1], nb[..., 0]], -1).reshape(-1, 4)
                   .clamp(min=0), x.dims).reshape(nb.shape[:3])
    pos = torch.searchsorted(x.key, key).clamp(max=len(x.key) - 1)
    occupied = inside & (x.key[pos] == key)
    centre = (nb.float() + 0.5) * step + lo
    diff = centre - points[:, :, None, :]
    dist = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    hit = occupied & (dist <= float(np.float32(radius) * np.float32(radius)))
    out = torch.full((b, g, nsample), -1, dtype=torch.int64)
    for bb in range(b):
        for gg in range(g):
            taken = pos[bb, gg][hit[bb, gg]][:nsample]
            if len(taken):
                out[bb, gg] = taken[0]
                out[bb, gg, :len(taken)] = taken
    return out


def linear_bn(ctx, sd, prefix, x, relu=True):
    y = x @ sd[prefix + ".linear.weight"].t()
    y = batch_norm(ctx, sd, prefix + ".bn", y.reshape(-1, y.shape[-1]), 1e-5).reshape(y.shape)
    return F.relu(y) if relu else y


def pool(ctx, sd, cfg, rois, scales):
    """Voxel RoI pooling of the pooled scales: ((B, R, n^3, C), each scale's
    query indices)."""
    v = cfg["voxel_rcnn"]
    b, r, _ = rois.shape
    grid = grid_points(rois, v["grid_size"]).reshape(b, -1, 3)
    outs, found = [], []
    for k, (si, radius) in enumerate(zip(v["scales"], v["pool_radius"])):
        x = scales[si]
        lo, step = scale_geometry(cfg, cfg["strides"][si])
        idx = voxel_query(x, grid, lo, step, v["query_range"], radius, v["nsample"])
        found.append(idx)
        pre = f"roi_pool.layers.{k}"
        f = linear_bn(ctx, sd, pre + ".mlp_in", x.feats, relu=False)
        valid = (idx[..., :1] >= 0)[..., None]
        rows = idx.clamp(min=0)
        centre = (x.coords[rows][..., 1:].flip(-1).float() + 0.5) * step + lo
        rel = torch.where(valid, centre - grid[:, :, None, :], 0.0)
        h = torch.where(valid, f[rows], 0.0) + linear_bn(ctx, sd, pre + ".mlp_pos", rel, relu=False)
        outs.append(linear_bn(ctx, sd, pre + ".mlp_out", F.relu(h).amax(dim=2)))
    return torch.cat(outs, -1).reshape(b, r, v["grid_size"] ** 3, -1), found


def rcnn(ctx, sd, cfg, pooled):
    """The RoI head: (class logits (B, R), residuals (B, R, 7))."""
    b, r = pooled.shape[:2]
    v = cfg["voxel_rcnn"]
    x = pooled.transpose(2, 3).reshape(b * r, -1)
    for j in range(len(v["shared_fc"])):
        x = linear_bn(ctx, sd, f"rcnn.shared.{j}", x)
    c, g = x, x
    for j in range(len(v["cls_fc"])):
        c = linear_bn(ctx, sd, f"rcnn.cls.{j}", c)
    for j in range(len(v["reg_fc"])):
        g = linear_bn(ctx, sd, f"rcnn.reg.{j}", g)
    cls = c @ sd["rcnn.cls_pred.weight"].t() + sd["rcnn.cls_pred.bias"]
    reg = g @ sd["rcnn.reg_pred.weight"].t() + sd["rcnn.reg_pred.bias"]
    return cls.reshape(b, r), reg.reshape(b, r, 7)


def decode_rois(res, rois):
    local = torch.cat([torch.zeros_like(rois[..., 0:3]), rois[..., 3:]], dim=-1)
    box = decode(res, local)
    yaw = rois[..., 6]
    c, s = torch.cos(yaw), torch.sin(yaw)
    x = box[..., 0] * c - box[..., 1] * s
    y = box[..., 0] * s + box[..., 1] * c
    return torch.cat([torch.stack([x, y, box[..., 2]], dim=-1) + rois[..., 0:3], box[..., 3:]], -1)


@torch.no_grad()
def forward(ctx, sd, cfg, points, num_points, anchors, rois=None):
    """The whole inference, one class. ``rois`` pools these in place of the
    reference's own top anchors (to hold stage 2 against a program's).
    Returns a dict: cls, reg (stage-1 maps), rois, indices (each scale's),
    pooled, rcnn_cls, rcnn_reg, boxes, scores, valid."""
    with no_tf32():
        cls, reg, scales = maps(ctx, sd, cfg, points, num_points)
        if rois is None:
            rois, _ = rois_of(cls, reg, anchors, cfg["proposal"]["topk"])
        pooled, indices = pool(ctx, sd, cfg, rois, scales)
        rcnn_cls, rcnn_reg = rcnn(ctx, sd, cfg, pooled)
        boxes = decode_rois(rcnn_reg, rois)
        scores = torch.sigmoid(rcnn_cls)
        keep = nms_keep(boxes, scores, cfg["proposal"]["nms_iou_threshold"], cfg["iou_angle_mode"])
        valid = keep & (scores > cfg["anchors"][0]["score_thresh"])
    return dict(cls=cls, reg=reg, rois=rois, indices=indices, pooled=pooled, scales=scales,
                rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg, boxes=boxes, scores=scores, valid=valid)
