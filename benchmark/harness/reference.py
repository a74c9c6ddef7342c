"""The plain reference: SECOND and PV-RCNN in float32 PyTorch, written
from the published architecture and the configuration file alone.

It imports nothing of the program, takes no weights the program made and
re-derives everything the program derives: voxels, the active set of every
sparse conv and its neighbour pairs, keypoints, ball groups, targets. The
sparse convs are gathers over a sorted key table (one ``searchsorted`` per
tap), which is not how the program computes them. Small plain pieces whose
bits decide discrete choices (the squared distance of FPS and the ball
queries, the rotated IoU, the box codec, NMS, target assignment) are
frozen copies of the port's plain versions, so that both sides make the
same choices from the same numbers.

Three modes (``Ctx.mode``): ``eval`` normalises with the running
statistics; ``train`` with the batch's (masked mean and biased variance);
``calib`` as ``train``, and writes the batch's statistics into the state
dict as running statistics (the benchmark's calibration of fresh weights).
``Ctx.quant`` rounds the inputs and weights of every conv and linear layer
to float8 e4m3, and the gradient that reaches its output to float8 e5m2,
each with one scale per tensor: the control, one precision below the
bfloat16 the configuration states. ``Ctx.counts`` collects the work of each sparse conv (active input
and output sites, neighbour pairs hit) for the rooflines and ``mfu``. With ``over_ranks`` a
``Ctx`` computes one rank's share of a global batch too large for one card, its sums over the
batch taken over the ranks (``torch.distributed``).
"""

import itertools
import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

# SpMiddleFHD's blocks: submanifold widths, then the strided conv's
# (width, kernel, stride, pad), ZYX
BLOCKS = (
    ((16, 16), (32, (3, 3, 3), (2, 2, 2), (1, 1, 1))),
    ((32, 32), (64, (3, 3, 3), (2, 2, 2), (1, 1, 1))),
    ((64, 64, 64), (64, (3, 3, 3), (2, 2, 2), (0, 1, 1))),
    ((64, 64, 64), (64, (3, 1, 1), (2, 1, 1), (0, 0, 0))),
)
RPN_LAYERS = 7          # six 3x3 Conv-BN-ReLU, then one 1x1


def fp8_round(x, dtype=torch.float8_e4m3fn):
    """``x`` rounded to a float8 format with one scale for the tensor."""
    scale = torch.finfo(dtype).max / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _GradFp8(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to float8 e5m2 (the
    usual float8 training recipe: e4m3 operands, e5m2 gradients)."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2)


class _SumOverRanks(torch.autograd.Function):
    """A tensor summed over the process group's ranks; its gradient is the
    sum of every rank's gradient of the sum."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


class Ctx:
    """``over_ranks``: this process computes one rank's share of a global
    batch, and every sum over the batch (batch-norm statistics, the loss
    normaliser) is taken over all ranks of the default process group, so the
    ranks together compute the global batch's forward."""

    def __init__(self, mode: str = "eval", quant: bool = False, over_ranks: bool = False):
        if mode not in ("eval", "train", "calib"):
            raise ValueError(f"unknown reference mode {mode!r}")
        self.mode, self.quant = mode, quant
        self.counts = []
        self.world = dist.get_world_size() if over_ranks else 1

    def total(self, x):
        """``x`` summed over the ranks (``x`` itself on one)."""
        return _SumOverRanks.apply(x) if self.world > 1 else x

    def q(self, x):
        """An operand of a matmul or conv, rounded to float8 (the gradient
        passes straight through)."""
        if not self.quant:
            return x
        return x + (fp8_round(x.detach()) - x).detach()

    def qg(self, y):
        """A matmul's or conv's result, whose gradient is rounded to
        float8 before the backward matmuls use it."""
        return _GradFp8.apply(y) if self.quant and y.requires_grad else y


def linear(ctx, x, w, b=None):
    y = ctx.qg(ctx.q(x) @ ctx.q(w).t())
    return y if b is None else y + b


def batch_norm(ctx, sd, prefix, x, mask=None, eps=1e-3, channel_dim=-1):
    """Batch norm over ``channel_dim``; rows where ``mask`` is False take
    no part in the statistics and come out zero."""
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    if ctx.mode == "eval":
        mean, var = sd[prefix + ".running_mean"], sd[prefix + ".running_var"]
    else:
        axes = [a for a in range(x.dim()) if a != channel_dim % x.dim()]
        if mask is None:
            n = x.numel() // x.shape[channel_dim]
            if ctx.world > 1:       # the ranks' shares differ (a sparse conv's sites)
                n = ctx.total(torch.tensor(float(n), dtype=x.dtype, device=x.device))
            mean = ctx.total(x.sum(dim=axes)) / n
            var = ctx.total((x - mean.view(shape)).square().sum(dim=axes)) / n
        else:
            w = mask.unsqueeze(channel_dim).to(x.dtype)
            n = ctx.total(w.sum()).clamp(min=1.0)
            mean = ctx.total((x * w).sum(dim=axes)) / n
            var = ctx.total(((x - mean.view(shape)).square() * w).sum(dim=axes)) / n
        if ctx.mode == "calib":
            sd[prefix + ".running_mean"] = mean.detach().clone()
            sd[prefix + ".running_var"] = var.detach().clone()
    y = ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + eps)
         * sd[prefix + ".weight"].view(shape) + sd[prefix + ".bias"].view(shape))
    return y if mask is None else torch.where(mask.unsqueeze(channel_dim), y, 0.0)


# ---------------------------------------------------------------- sparse

class Sparse:
    """Active sites of a batch: ``coords`` (N, 4) int64 (b, z, y, x),
    sorted by ``key`` = ((b*H + y)*W + x)*D + z (a frame's sites in
    column-major order), ``feats`` (N, C), grid ``dims`` (D, H, W)."""

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


def grid_dims_xyz(cfg):
    vs = np.asarray(cfg["voxel_size"])
    lo, hi = np.asarray(cfg["grid_bounds"][:3]), np.asarray(cfg["grid_bounds"][3:])
    return tuple(int(v) for v in np.round((hi - lo) / vs))


def grid_zyx(cfg):
    nx, ny, nz = grid_dims_xyz(cfg)
    return (nz + 1, ny, nx)


def voxelize(points, num_points, cfg) -> Sparse:
    """Each voxel's feature is the mean of its first ``max_occupancy``
    points in scan order. The first-come cap on the number of voxels is not
    modelled: a frame with more than ``max_voxels`` voxels raises."""
    b, p, c = points.shape
    dev = points.device
    lo = torch.tensor(cfg["grid_bounds"][:3], dtype=points.dtype, device=dev)
    vs = torch.tensor(cfg["voxel_size"], dtype=points.dtype, device=dev)
    cxyz = torch.floor((points[..., :3] - lo) / vs).to(torch.int64)
    nxyz = torch.tensor(grid_dims_xyz(cfg), device=dev)
    ok = ((cxyz >= 0) & (cxyz < nxyz)).all(-1)
    ok &= torch.arange(p, device=dev)[None] < num_points.to(dev)[:, None]
    dims = grid_zyx(cfg)
    bidx = torch.arange(b, device=dev)[:, None].expand(b, p)
    coords = torch.stack([bidx, cxyz[..., 2], cxyz[..., 1], cxyz[..., 0]], -1)[ok]
    key, order = torch.sort(site_key(coords, dims), stable=True)
    pts = points[ok][order]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    seg = first.cumsum(0) - 1
    starts = torch.nonzero(first)[:, 0]
    rank = torch.arange(len(key), device=dev) - starts[seg]
    keep = rank < cfg["max_occupancy"]
    vkey = key[first]
    per_frame = torch.bincount(key_coords(vkey, dims)[:, 0], minlength=b)
    if int(per_frame.max()) > cfg["max_voxels"]:
        raise RuntimeError(f"reference: {int(per_frame.max())} voxels in a frame, over "
                           f"max_voxels {cfg['max_voxels']}")
    sums = torch.zeros((len(vkey), c), dtype=points.dtype, device=dev)
    sums.index_add_(0, seg[keep], pts[keep])
    cnt = torch.bincount(seg[keep], minlength=len(vkey)).to(points.dtype)
    return Sparse(key_coords(vkey, dims), vkey, sums / cnt[:, None], dims, b)


def taps(kernel):
    return list(itertools.product(*(range(k) for k in kernel)))


def sparse_conv(ctx, x: Sparse, weight, kernel, stride, pad, subm, name, stage) -> Sparse:
    """Cross-correlation: out[o] = sum over taps t of in[o*stride - pad + t]
    @ W[t], W laid out (K*Cin, Cout) with K = (dz*ky + dy)*kx + dx. A
    submanifold conv keeps the input's sites; a strided one's sites are
    every output any active input reaches."""
    dev = x.feats.device
    cin = x.feats.shape[1]
    s_t = torch.tensor(stride, device=dev)
    p_t = torch.tensor(pad, device=dev)
    in_dims = torch.tensor(x.dims, device=dev)
    if subm:
        out_dims, out_coords, out_key = x.dims, x.coords, x.key
    else:
        out_dims = tuple((d + 2 * pp - k) // s + 1
                         for d, k, s, pp in zip(x.dims, kernel, stride, pad))
        od = torch.tensor(out_dims, device=dev)
        cand = []
        for t in taps(kernel):
            num = x.coords[:, 1:] + p_t - torch.tensor(t, device=dev)
            o = torch.div(num, s_t, rounding_mode="floor")
            ok = ((num % s_t) == 0).all(1) & (num >= 0).all(1) & (o < od).all(1)
            cand.append(site_key(torch.cat([x.coords[ok, :1], o[ok]], 1), out_dims))
        out_key = torch.unique(torch.cat(cand))
        out_coords = key_coords(out_key, out_dims)
    w = ctx.q(weight)
    xf = ctx.q(x.feats)
    out = torch.zeros((len(out_key), weight.shape[1]), dtype=x.feats.dtype, device=dev)
    hits = 0
    for ti, t in enumerate(taps(kernel)):
        src = out_coords[:, 1:] * s_t - p_t + torch.tensor(t, device=dev)
        inb = ((src >= 0) & (src < in_dims)).all(1)
        k = site_key(torch.cat([out_coords[:, :1], src.clamp(min=0)], 1), x.dims)
        pos = torch.searchsorted(x.key, k).clamp(max=len(x.key) - 1)
        hit = inb & (x.key[pos] == k)
        o = torch.nonzero(hit)[:, 0]
        hits += len(o)
        out = out.index_add(0, o, ctx.qg(xf[pos[o]] @ w[ti * cin:(ti + 1) * cin]))
    ctx.counts.append(dict(name=name, stage=stage, n_in=len(x.key), n_out=len(out_key), cin=cin,
                           cout=weight.shape[1], kvol=len(taps(kernel)), hits=hits))
    return Sparse(out_coords, out_key, out, out_dims, x.batch)


def middle(ctx, sd, x: Sparse):
    """SpMiddleFHD: returns (the last stage's Sparse, the four scales: the
    input and the outputs of stages 0-2)."""
    scales, li = [x], 0
    for si, (chans, (cout, kernel, stride, pad)) in enumerate(BLOCKS):
        for _ in chans:
            pre = f"cnn.subm.{li}"
            y = sparse_conv(ctx, x, sd[pre + ".weight"], (3, 3, 3), (1, 1, 1),
                            (1, 1, 1), True, f"subm{li}", si)
            y.feats = F.relu(batch_norm(ctx, sd, pre + ".bn", y.feats))
            x, li = y, li + 1
        pre = f"cnn.down.{si}"
        y = sparse_conv(ctx, x, sd[pre + ".weight"], kernel, stride, pad, False,
                        f"down{si}", si)
        y.feats = F.relu(batch_norm(ctx, sd, pre + ".bn", y.feats))
        x = y
        scales.append(x)
    return x, scales[:4]


def to_bev(x: Sparse):
    """(B, C*D, H, W), channels c-major over (C, D)."""
    d, h, w = x.dims
    c = x.feats.shape[1]
    dense = torch.zeros((x.batch, d, h, w, c), dtype=x.feats.dtype, device=x.feats.device)
    cc = x.coords
    dense = dense.index_put((cc[:, 0], cc[:, 1], cc[:, 2], cc[:, 3]), x.feats)
    return dense.permute(0, 4, 1, 2, 3).reshape(x.batch, c * d, h, w)


def rpn_head(ctx, sd, cfg, x):
    for j in range(RPN_LAYERS):
        w = sd[f"rpn.{j}.0.weight"]
        x = ctx.qg(F.conv2d(ctx.q(x), ctx.q(w), padding=w.shape[-1] // 2))
        ctx.counts.append(dict(name=f"rpn{j}", flops=2 * w[0].numel() * x.numel()))
        x = F.relu(batch_norm(ctx, sd, f"rpn.{j}.1", x, channel_dim=1))
    b, _, ny, nx = x.shape
    n_cls, n_yaw = cfg["num_classes"], len(cfg["anchors"][0]["yaw"])
    cls = ctx.qg(F.conv2d(ctx.q(x), ctx.q(sd["head.conv_cls.weight"]), sd["head.conv_cls.bias"]))
    reg = ctx.qg(F.conv2d(ctx.q(x), ctx.q(sd["head.conv_reg.weight"]), sd["head.conv_reg.bias"]))
    ctx.counts.append(dict(name="head", flops=2 * (cls.numel() + reg.numel()) * x.shape[1]))
    cls = cls.reshape(b, n_cls, n_yaw, ny, nx)
    reg = reg.reshape(b, n_cls, n_yaw, 7, ny, nx).permute(0, 1, 2, 4, 5, 3)
    return x, cls, reg


def second_maps(ctx, sd, cfg, points, num_points, need_scales=False):
    """Voxelize, middle extractor, RPN, head: (RPN output, cls map
    (B, n_cls, n_yaw, ny, nx), reg map (..., 7), scales or None)."""
    vox = voxelize(points, num_points, cfg)
    last, scales = middle(ctx, sd, vox)
    x, cls, reg = rpn_head(ctx, sd, cfg, to_bev(last))
    return x, cls, reg, (scales if need_scales else None)


# ------------------------------------------------- anchors, codec, NMS

def make_anchors(cfg) -> np.ndarray:
    """(n_cls, n_yaw, ny, nx, 7) float32 at the BEV grid's bin midpoints."""
    stride = cfg["strides"][-1]
    pixel = np.asarray(cfg["voxel_size"][:2]) * stride
    lower = np.asarray(cfg["grid_bounds"][:2], dtype=np.float64)
    upper = np.asarray(cfg["grid_bounds"][3:5], dtype=np.float64)
    nx, ny = np.round((upper - lower) / pixel).astype(np.int64)

    def mid(x0, x1, n):
        dx = (x1 - x0) / n
        return x0 + dx / 2 + dx * np.arange(n, dtype=np.float64)

    xs, ys = mid(lower[0], upper[0], nx), mid(lower[1], upper[1], ny)
    n_cls = cfg["num_classes"]
    anchors_cfg = cfg["anchors"][:n_cls]
    n_yaw = len(anchors_cfg[0]["yaw"])
    out = np.zeros((n_cls, n_yaw, ny, nx, 7), dtype=np.float32)
    out[..., 0] = xs[None, None, None, :]
    out[..., 1] = ys[None, None, :, None]
    for c, a in enumerate(anchors_cfg):
        out[c, ..., 2] = a["center_z"]
        out[c, ..., 3:6] = np.asarray(a["wlh"], dtype=np.float32)
        for j in range(n_yaw):
            out[c, j, ..., 6] = a["yaw"][j]
    return out


def _anchor_norm(a_wlh):
    diag = torch.sqrt(a_wlh[..., 0:1] ** 2 + a_wlh[..., 1:2] ** 2)
    return torch.cat([diag, diag, a_wlh[..., 2:3]], dim=-1)


def encode(boxes, anchors):
    a_norm = _anchor_norm(anchors[..., 3:6])
    return torch.cat([(boxes[..., 0:3] - anchors[..., 0:3]) / a_norm,
                      torch.log(boxes[..., 3:6] / anchors[..., 3:6]),
                      torch.remainder(boxes[..., 6:7] - anchors[..., 6:7], math.pi)], -1)


def decode(deltas, anchors, max_wlh_delta=10.0):
    wlh = torch.clamp(deltas[..., 3:6], -max_wlh_delta, max_wlh_delta)
    a_norm = _anchor_norm(anchors[..., 3:6])
    return torch.cat([deltas[..., 0:3] * a_norm + anchors[..., 0:3],
                      torch.exp(wlh) * anchors[..., 3:6],
                      deltas[..., 6:7] + anchors[..., 6:7]], -1)


def decode_all(cls, reg, anchors):
    """Every anchor's (box, logit): ((B, A, 7), (B, A)), one class."""
    b = cls.shape[0]
    flat_anchors = anchors.reshape(1, -1, 7).expand(b, -1, -1)
    return decode(reg.reshape(b, -1, 7), flat_anchors), cls.reshape(b, -1)


def topk_stable(scores, k):
    s, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], idx[..., :k]


_EPS = 1e-14


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
    """IoU of broadcast (..., 5) BEV boxes (x, y, w, l, angle): the convex
    intersection of two quads from its 24 candidate vertices."""
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
    nonpar = denom.abs() > _EPS
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
    return torch.where(union > 0, inter / union.clamp(min=_EPS), torch.zeros_like(inter))


BEV_COLS = [0, 1, 3, 4, 6]


def nms_keep(boxes, scores, iou_threshold, angle_mode):
    """Greedy rotated NMS over (B, K, 7) boxes, one class: keep (B, K)
    bool in the boxes' order. Suppression is strict ``>``; ties in score
    go to the lower index."""
    b, k = scores.shape
    order = torch.sort(-scores, dim=1, stable=True).indices
    bx = torch.gather(boxes[..., BEV_COLS], 1, order[..., None].expand(b, k, 5))
    iou = rotated_iou(bx[:, :, None, :], bx[:, None, :, :], angle_mode)
    rank = torch.arange(k, device=scores.device)
    suppress = (iou > iou_threshold) & (rank[:, None] < rank[None, :])
    keep = torch.ones((b, k), dtype=torch.bool, device=scores.device)
    for i in range(k):
        keep[:, i + 1:] &= ~(suppress[:, i, i + 1:] & keep[:, i:i + 1])
    out = torch.zeros_like(keep)
    out.scatter_(1, order, keep)
    return out


# ------------------------------------------------------------- PV-RCNN

def squared_distance(a, b):
    """|a - b|^2 in float32 as fused multiply-adds round it: the product of
    two float32 numbers is exact in float64."""
    d = (a - b).double()
    p = (d[..., 0] * d[..., 0]).float().double()
    q = (d[..., 1] * d[..., 1] + p).float().double()
    return (d[..., 2] * d[..., 2] + q).float()


def furthest_point_sample(xyz, mask, k):
    b = xyz.shape[0]
    bidx = torch.arange(b, device=xyz.device)
    neg = torch.tensor(float("-inf"), device=xyz.device)
    dist = torch.where(mask, float("inf"), neg)
    cur = mask.to(torch.int32).argmax(dim=1)
    out = [cur]
    for _ in range(1, k):
        d = squared_distance(xyz, xyz[bidx, cur][:, None, :])
        dist = torch.minimum(dist, torch.where(mask, d, neg))
        cur = dist.argmax(dim=1)
        out.append(cur)
    return torch.stack(out, dim=1)


def ball_query(src_xyz, src_mask, centers, radius, nsample, budget=1 << 26):
    """The first ``nsample`` sources by index within ``radius`` of each
    centre, the first repeated to fill the group: (idx (B, M, S), valid
    (B, M, S), all False for an empty ball)."""
    b, n, _ = src_xyz.shape
    m = centers.shape[1]
    r2 = float(np.float32(radius) * np.float32(radius))
    chunk = max(1, min(m, budget // max(1, b * n)))
    idx_out, valid_out = [], []
    for c0 in range(0, m, chunk):
        ctr = centers[:, c0:c0 + chunk]
        in_ball = ((squared_distance(ctr[:, :, None, :], src_xyz[:, None, :, :]) < r2)
                   & src_mask[:, None, :])
        rank = in_ball.to(torch.int32).cumsum(dim=2)
        cnt = rank[..., -1:]
        # the j-th in-ball source is the first index whose running count is j + 1
        want = torch.arange(1, nsample + 1, device=src_xyz.device, dtype=torch.int32)
        idx = torch.searchsorted(rank, want.expand(rank.shape[:2] + (nsample,)).contiguous())
        found = want <= cnt
        idx = torch.where(found, idx, idx[..., :1]).clamp(max=n - 1)
        idx_out.append(torch.where((cnt > 0), idx, 0))
        valid_out.append((cnt > 0).expand(-1, -1, nsample))
    return torch.cat(idx_out, 1), torch.cat(valid_out, 1)


def set_abstraction(ctx, sd, prefix, radii, nsamples, src_xyz, src_feats, src_mask,
                    centers, eps=1e-5):
    b, n, _ = src_xyz.shape
    outs = []
    for j, (r, s) in enumerate(zip(radii, nsamples)):
        with torch.no_grad():
            idx, valid = ball_query(src_xyz, src_mask, centers, r, s)
        flat = (idx + torch.arange(b, device=idx.device)[:, None, None] * n).reshape(-1)
        g = src_xyz.reshape(b * n, 3)[flat].reshape(idx.shape + (3,)) - centers[:, :, None]
        if src_feats is not None:
            g = torch.cat([g, src_feats.reshape(b * n, -1)[flat].reshape(idx.shape + (-1,))], -1)
        h = torch.where(valid[..., None], g, 0.0)
        pre = f"{prefix}.mlps.{j}"
        rows = int(valid.any(dim=2).sum()) * s
        layer = 0
        while f"{pre}.linears.{layer}.weight" in sd:
            w = sd[f"{pre}.linears.{layer}.weight"]
            ctx.counts.append(dict(name=f"{pre}.{layer}", flops=2 * w.numel() * rows))
            h = linear(ctx, h, w)
            h = F.relu(batch_norm(ctx, sd, f"{pre}.bns.{layer}", h, valid, eps=eps))
            layer += 1
        pooled = torch.where(valid[..., None], h, float("-inf")).amax(dim=2)
        outs.append(torch.where(valid.any(dim=2)[..., None], pooled, 0.0))
    return torch.cat(outs, -1)


def padded_scale(x: Sparse, cfg, stride):
    """A scale's sites per frame in key order, padded: (xyz of each
    voxel's origin corner (B, N, 3), feats (B, N, C), mask (B, N))."""
    dev = x.feats.device
    frame = x.coords[:, 0]
    counts = torch.bincount(frame, minlength=x.batch)
    n = int(counts.max())
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(len(frame), device=dev) - starts[frame]
    vs = torch.tensor(cfg["voxel_size"], dtype=torch.float32) * stride
    off = torch.tensor(cfg["grid_bounds"][:3], dtype=torch.float32)
    xyz = (x.coords[:, 1:].flip(-1).double() * vs.double().to(dev)
           + off.double().to(dev)).float()
    c = x.feats.shape[1]
    out_xyz = torch.zeros((x.batch, n, 3), device=dev).index_put((frame, slot), xyz)
    out_f = torch.zeros((x.batch, n, c), dtype=x.feats.dtype, device=dev)
    out_f = out_f.index_put((frame, slot), x.feats)
    mask = torch.zeros((x.batch, n), dtype=torch.bool, device=dev)
    mask[frame, slot] = True
    return out_xyz, out_f, mask, counts


def bev_bilinear(bev_nchw, kp_xy, cfg):
    bev = bev_nchw.permute(0, 2, 3, 1)
    dev = bev.device
    pix = torch.tensor(cfg["voxel_size"][:2], dtype=torch.float32, device=dev) * cfg["strides"][-1]
    off = torch.tensor(cfg["grid_bounds"][:2], dtype=torch.float32, device=dev)
    b, ny, nx, _ = bev.shape
    fx = torch.clamp((kp_xy[..., 0] - off[0]) / pix[0], 0.0, nx - 1.0)
    fy = torch.clamp((kp_xy[..., 1] - off[1]) / pix[1], 0.0, ny - 1.0)
    x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
    x1, y1 = torch.clamp(x0 + 1, max=nx - 1), torch.clamp(y0 + 1, max=ny - 1)
    wx, wy = (fx - x0)[..., None], (fy - y0)[..., None]
    bi = torch.arange(b, device=dev)[:, None]
    top = bev[bi, y0, x0] * (1 - wx) + bev[bi, y0, x1] * wx
    bot = bev[bi, y1, x0] * (1 - wx) + bev[bi, y1, x1] * wx
    return top * (1 - wy) + bot * wy


def point_branch(ctx, sd, cfg, points, num_points, x, scales):
    """FPS keypoints and their features: the five set abstractions (raw
    points with intensity, then the scales at strides 1, 2, 4, 8) and the
    BEV map's bilinear sample. Returns (keypoints, point features, the
    scales' site counts per frame)."""
    mask = torch.arange(points.shape[1], device=points.device)[None] < num_points[:, None]
    xyz = points[..., :3]
    with torch.no_grad():
        idx = furthest_point_sample(xyz, mask, cfg["num_keypoints"])
    bi = torch.arange(points.shape[0], device=points.device)[:, None]
    kp = xyz[bi, idx]
    sources = [(xyz, points[..., 3:4], mask)]
    counts = []
    for s, stride in zip(scales, cfg["strides"]):
        sx, sf, sm, cnt = padded_scale(s, cfg, stride)
        sources.append((sx, sf, sm))
        counts.append(cnt)
    feats = [set_abstraction(ctx, sd, f"pnets.{i}", cfg["psa"]["radii"][i],
                             cfg["samples_pn"], sx, sf, sm, kp)
             for i, (sx, sf, sm) in enumerate(sources)]
    feats.append(bev_bilinear(x, kp[..., :2], cfg))
    return kp, torch.cat(feats, -1), counts


def sample_gridpoints(boxes, u):
    u = u.to(device=boxes.device, dtype=boxes.dtype) - 0.5
    local = boxes[:, :, None, 3:6] * u
    yaw = boxes[..., 6][:, :, None]
    c, s = torch.cos(yaw), torch.sin(yaw)
    x = local[..., 0] * c - local[..., 1] * s
    y = local[..., 0] * s + local[..., 1] * c
    return boxes[:, :, None, 0:3] + torch.stack([x, y, local[..., 2]], dim=-1)


def stage2(ctx, sd, cfg, proposals, keypoints, point_features, u):
    """RoI grid pooling and refinement of ``proposals`` (B, N, 7):
    (refined boxes (B, N, 7), confidence logits (B, N), box deltas
    (B, N, 7))."""
    seg = linear(ctx, point_features, sd["keypoint_seg.weight"], sd["keypoint_seg.bias"])
    fg = 1.0 - F.softmax(seg, dim=-1)[..., -1:]
    b, n, _ = proposals.shape
    m = u.shape[2]
    grid = sample_gridpoints(proposals, u).reshape(b, n * m, 3)
    kp_mask = torch.ones(keypoints.shape[:2], dtype=torch.bool, device=keypoints.device)
    gp = cfg["gridpool"]
    feats = set_abstraction(ctx, sd, "roi_grid_pool.sa", gp["radii_pn"], cfg["samples_pn"],
                            keypoints, point_features * fg, kp_mask, grid)
    h = feats.reshape(b, n, -1)
    names = [f"roi_grid_pool.mlp.linears.{j}" for j in range(len(gp["mlps_reduction"]) - 1)]
    names += [f"refinement.mlp.linears.{j}" for j in range(len(cfg["refinement"]["mlps"]))]
    for name in names + ["refinement.out", "keypoint_seg"]:
        rows = point_features.shape[1] if name == "keypoint_seg" else n
        ctx.counts.append(dict(name=name, flops=2 * sd[name + ".weight"].numel() * b * rows))
    for name in names:
        h = F.relu(linear(ctx, h, sd[name + ".weight"], sd.get(name + ".bias")))
    out = linear(ctx, h, sd["refinement.out.weight"], sd["refinement.out.bias"])
    return decode(out[..., :7], proposals), out[..., 7], out[..., :7]


# ------------------------------------------------------------ training

def assign_targets(boxes, gt_mask, anchors, cfg, chunk=8192):
    """One class: (G_cls, M_cls, G_reg, M_reg) laid out as the anchor grid
    with a leading batch dim. Anchors below the low IoU threshold are
    background, between the two ignored, above positive; each matched to
    its highest-IoU gt (the lowest index among ties)."""
    a_flat = anchors.reshape(-1, 7)
    bsz, g = boxes.shape[:2]
    ious = [rotated_iou(boxes[:, :, None, BEV_COLS], blk[None, None, :, BEV_COLS],
                        cfg["iou_angle_mode"]) for blk in a_flat.split(chunk)]
    iou = torch.where(gt_mask[..., None], torch.cat(ious, -1), 0.0)      # (B, G, A)
    low, high = cfg["anchors"][0]["iou_thresh"]
    best = iou.amax(dim=1)
    gidx = torch.arange(g, device=boxes.device)[None, :, None]
    match = torch.where(iou == best[:, None], gidx, g).amin(dim=1)      # (B, A)
    labels = torch.where(best < low, 0, 1)
    labels = torch.where((best >= low) & (best < high), -1, labels)
    m_cls, m_reg = labels != -1, labels == 1
    matched = torch.gather(boxes, 1, match[..., None].expand(-1, -1, 7))
    g_reg = torch.where(m_reg[..., None], encode(matched, a_flat[None]), 0.0)
    shape = (bsz,) + tuple(anchors.shape[:-1])
    return (labels.clamp(min=0).float().reshape(shape), m_cls.reshape(shape),
            g_reg.reshape(shape + (7,)), m_reg.reshape(shape))


def proposal_loss(cls, reg, targets, lam, total):
    """Focal loss (alpha 0.25, gamma 2) at non-ignored anchors plus
    smooth-L1 at positives (the yaw term counted 3/pi, as the model's
    reference sums it), both over the positive count clamped to 1. The
    count is ``total``'s (``Ctx.total``) of this batch's: over the ranks,
    the global batch's, so that a rank's loss is its share of the global
    loss."""
    g_cls, m_cls, g_reg, m_reg = targets
    norm = total(m_reg.float().sum()).clamp(min=1.0)
    p = torch.sigmoid(cls)
    ce = F.binary_cross_entropy_with_logits(cls, g_cls, reduction="none")
    p_t = p * g_cls + (1 - p) * (1 - g_cls)
    focal = (0.25 * g_cls + 0.75 * (1 - g_cls)) * ce * (1 - p_t) ** 2
    cls_loss = (focal * m_cls.float()).sum() / norm
    d = (reg - g_reg).abs()
    per = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    scale = per.new_ones(7)
    scale[6] = 3.0 / math.pi
    reg_loss = ((per * scale).sum(-1) * m_reg.float()).sum() / norm
    return dict(loss=cls_loss + lam * reg_loss, cls_loss=cls_loss, reg_loss=reg_loss)


def sum_over_ranks_(tensors):
    """Each tensor replaced, in place, by its sum over the ranks of the
    default process group (one all-reduce of them all, flattened)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    for t, s in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(s.view_as(t))


def lr_at(cfg, count):
    """One-cycle cosine learning rate at update ``count`` (from 0)."""
    tr = cfg["train"]
    total = max(tr["epochs"] * cfg["bench"]["steps_per_epoch"], 1)
    peak = tr["max_lr"]
    init, end = peak / 25.0, peak / 25.0 / 1e4
    b1 = int(0.3 * total)

    def cosine(pct, start, stop):
        return stop + (start - stop) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    if count < b1:
        return cosine(count / b1, init, peak)
    if count < total:
        return cosine((count - b1) / (total - b1), peak, end)
    return end
