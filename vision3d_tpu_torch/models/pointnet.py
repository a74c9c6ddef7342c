"""PointNet++ multi-scale set abstraction (port of
``vision3d_tpu/models/pointnet.py``).

Per radius r_i with group size s_i: the first s_i in-ball source points of
each centre (``ops/ball_query.py``), [xyz - centre ++ feats], a shared
per-point MLP (Linear without bias, masked batch norm eps 1e-5 / momentum
0.1 in torch's convention (flax 0.9), ReLU), and a max over the group
that writes 0 for an empty ball; the scales are concatenated. The max is
``amax``, whose gradient splits evenly among tied maxima, as JAX's
``reduce_max`` does: the ball query pads a group with copies of its first
point, so ties are the rule. The ball query runs without gradient: it
gives indices only. The Linear layers run in float32 whatever the model's
compute dtype (the JAX Dense layers carry no dtype); on the card they are
cuBLAS GEMMs.
"""

import torch
import torch.nn.functional as F
from torch import nn

from vision3d_tpu_torch.models.sparse_cnn import MaskedBatchNorm
from vision3d_tpu_torch.ops.ball_query import ball_query, group_features


class SharedMLP(nn.Module):
    """Per-point Linear + masked BN + ReLU stack over (B, M, S, C) groups."""

    def __init__(self, cin: int, widths):
        super().__init__()
        self.linears = nn.ModuleList()
        self.bns = nn.ModuleList()
        for w in widths:
            self.linears.append(nn.Linear(cin, w, bias=False))
            self.bns.append(MaskedBatchNorm(w, eps=1e-5, momentum=0.1))
            cin = w

    def forward(self, x, valid):
        for lin, bn in zip(self.linears, self.bns):
            x = F.relu(bn(lin(x), valid))
        return x


class SetAbstractionMSG(nn.Module):
    """Multi-scale grouping: radii[i] pairs with nsamples[i] and the layer
    widths mlps[i]; ``c_feats`` is the source feature width (0: xyz only).
    The output width is the sum of each MLP's last width."""

    def __init__(self, c_feats: int, radii, nsamples, mlps):
        super().__init__()
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.mlps = nn.ModuleList(SharedMLP(c_feats + 3, w) for w in mlps)

    def forward(self, src_xyz, src_feats, src_mask, centers):
        """src_xyz (B, N, 3), src_feats (B, N, C) or None, src_mask (B, N),
        centers (B, M, 3) -> (B, M, sum of the output widths)."""
        outs = []
        with torch.no_grad():       # the card's ball query takes contiguous inputs
            query = (src_xyz.contiguous(), src_mask.contiguous(), centers.contiguous())
        for r, s, mlp in zip(self.radii, self.nsamples, self.mlps):
            with torch.no_grad():
                idx, valid = ball_query(*query, r, s)
            g = group_features(src_xyz, src_feats, idx, valid, centers)
            h = mlp(g, valid)
            pooled = torch.where(valid[..., None], h, float("-inf")).amax(dim=2)
            outs.append(torch.where(valid.any(dim=2)[..., None], pooled, 0.0))
        return torch.cat(outs, dim=-1)
