"""Ball query and grouping (port of ``vision3d_tpu/ops/ball_query.py``).

For each centre: the FIRST ``nsample`` source points by index within
``radius`` (squared distance below radius^2, both in float32, the distance
in ``ops.fps.squared_distance``'s rounding), the first one found repeated
to fill the group. ``valid`` is all True for a non-empty ball and all
False for an empty one, whose indices are all 0. The rank of a point in
its ball is a cumsum of the in-ball mask, so ties never arise.

Batched over B; chunked over the centres so the (B, chunk, N) distance
temporaries stay near ``budget`` elements.
"""

import numpy as np
import torch

from vision3d_tpu_torch.ops.fps import squared_distance


def ball_query(src_xyz, src_mask, centers, radius: float, nsample: int,
               budget: int = 1 << 26):
    """src_xyz (B, N, 3), src_mask (B, N), centers (B, M, 3) ->
    (indices (B, M, nsample) int64, valid (B, M, nsample) bool)."""
    b, n, _ = src_xyz.shape
    m = centers.shape[1]
    r2 = float(np.float32(radius) * np.float32(radius))   # float32, as jit traces it
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
