"""Ball query and grouping (port of ``vision3d_tpu/ops/ball_query.py``).

For each centre: the FIRST ``nsample`` source points by index within
``radius`` (squared distance below radius^2, both in float32, the distance
in ``ops.fps.squared_distance``'s rounding), the first one found repeated
to fill the group. ``valid`` is all True for a non-empty ball and all
False for an empty one, whose indices are all 0.

On a CPU tensor ``ball_query`` runs the plain PyTorch version
(``ball_query_plain``); on a CUDA tensor it launches the CUDA kernel
``csrc/ball_query.cu`` (a scan of the source in index order that stops once
every group of a block is full; the distance bit-equal to the plain
version's) or raises. ``LAUNCHES["ball_query"]`` counts kernel launches.
"""

import ctypes

import numpy as np
import torch

from vision3d_tpu_torch import kernels
from vision3d_tpu_torch.ops.fps import squared_distance

LAUNCHES = kernels.LAUNCHES
_VP = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = [_VP, _VP, _VP, _INT, _INT, _INT, _INT, ctypes.c_float, _VP, _VP, _VP]


def _r2(radius: float) -> float:
    """radius^2 in float32, as jit traces it."""
    return float(np.float32(radius) * np.float32(radius))


def ball_query_plain(src_xyz, src_mask, centers, radius: float, nsample: int,
                     budget: int = 1 << 26):
    """Plain PyTorch version: the in-ball mask of each centre over the whole
    source, the rank of a point in its ball a cumsum of that mask (so ties
    never arise), the first ``nsample`` ranks scattered into the group.
    Batched over B; chunked over the centres so the (B, chunk, N) distance
    temporaries stay near ``budget`` elements."""
    b, n, _ = src_xyz.shape
    m = centers.shape[1]
    r2 = _r2(radius)
    chunk = max(1, min(m, budget // max(1, b * n)))
    order = torch.arange(n, device=src_xyz.device).expand(b, 1, n)
    idx_out, valid_out = [], []
    for c0 in range(0, m, chunk):
        ctr = centers[:, c0:c0 + chunk]
        in_ball = (squared_distance(ctr[:, :, None, :], src_xyz[:, None, :, :]) < r2) \
            & src_mask[:, None, :]
        rank = in_ball.to(torch.int32).cumsum(dim=2)          # 1-based
        cnt = rank[..., -1:]
        slot = torch.where(in_ball & (rank <= nsample), rank - 1, nsample).long()
        idx = torch.zeros(slot.shape[:2] + (nsample + 1,), dtype=torch.int64,
                          device=src_xyz.device)
        idx.scatter_(2, slot, order.expand(slot.shape))
        idx = idx[..., :nsample]
        found = torch.arange(nsample, device=idx.device) < cnt
        idx_out.append(torch.where(found, idx, idx[..., :1]))
        valid_out.append((cnt > 0).expand(-1, -1, nsample))
    return torch.cat(idx_out, dim=1), torch.cat(valid_out, dim=1)


def ball_query(src_xyz, src_mask, centers, radius: float, nsample: int,
               budget: int = 1 << 26):
    """src_xyz (B, N, 3) float32, src_mask (B, N) bool, centers (B, M, 3)
    float32 -> (indices (B, M, nsample) int64, valid (B, M, nsample) bool).
    On the card every input must be contiguous; ``budget`` is the plain
    version's (CPU tensors)."""
    if src_xyz.device.type == "cpu":
        return ball_query_plain(src_xyz, src_mask, centers, radius, nsample, budget)
    if src_xyz.device.type != "cuda":
        raise ValueError(f"ball_query: unsupported device {src_xyz.device}")
    if src_mask.device != src_xyz.device or centers.device != src_xyz.device:
        raise ValueError(f"ball_query: inputs on {src_xyz.device}, {src_mask.device}, "
                         f"{centers.device}")
    if (src_xyz.dim() != 3 or src_xyz.shape[2] != 3 or centers.dim() != 3
            or centers.shape[2] != 3 or centers.shape[0] != src_xyz.shape[0]
            or tuple(src_mask.shape) != tuple(src_xyz.shape[:2])):
        raise ValueError("ball_query: need src_xyz (B, N, 3), src_mask (B, N) and "
                         "centers (B, M, 3)")
    if src_xyz.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError("ball_query: src_xyz and centers must be float32")
    if src_mask.dtype != torch.bool:
        raise TypeError("ball_query: src_mask must be bool")
    if not (src_xyz.is_contiguous() and src_mask.is_contiguous()
            and centers.is_contiguous()):
        raise ValueError("ball_query: src_xyz, src_mask and centers must be contiguous")
    b, n, _ = src_xyz.shape
    m = centers.shape[1]
    if nsample < 1 or b > 65535 or n >= 2 ** 31 or m >= 2 ** 31:
        raise ValueError(f"ball_query: unsupported sizes B {b}, N {n}, M {m}, "
                         f"nsample {nsample}")
    idx = torch.empty((b, m, nsample), dtype=torch.int64, device=src_xyz.device)
    valid = torch.empty((b, m, nsample), dtype=torch.bool, device=src_xyz.device)
    if b * m == 0:
        return idx, valid
    with torch.cuda.device(src_xyz.device):
        kernels.launch(
            "ball_query", _ARGTYPES,
            src_xyz.data_ptr(), src_mask.data_ptr(), centers.data_ptr(), b, n, m,
            nsample, _r2(radius), idx.data_ptr(), valid.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    return idx, valid


def group_features(src_xyz, src_feats, idx, valid, centers):
    """(xyz - centre ++ feats) of each centre's group: src_xyz (B, N, 3),
    src_feats (B, N, C) or None, idx / valid (B, M, S), centers (B, M, 3)
    -> (B, M, S, 3 [+ C]), zero where not valid."""
    b, n, _ = src_xyz.shape
    flat = (idx + torch.arange(b, device=idx.device)[:, None, None] * n).reshape(-1)
    g = src_xyz.reshape(b * n, 3)[flat].reshape(idx.shape + (3,)) - centers[:, :, None]
    if src_feats is not None:
        f = src_feats.reshape(b * n, -1)[flat].reshape(idx.shape + (-1,))
        g = torch.cat([g, f.to(g.dtype)], dim=-1)
    return torch.where(valid[..., None], g, 0.0)
