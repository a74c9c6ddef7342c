"""Box encode/decode (port of ``vision3d_tpu/core/boxes.py:29-66``).

VoxelNet-style encoding: xy normalized by the anchor's BEV diagonal, z by
anchor height, wlh as log ratios; encode wraps the yaw residual mod pi,
decode adds the raw residual to the anchor yaw (the reference contract).
Shape-polymorphic over leading dims; torch tensors in, torch tensors out.
"""

import math

import torch


def _anchor_diagonal(a_wlh):
    """BEV diagonal for the x/y slots, height for the z slot."""
    diag = torch.sqrt(a_wlh[..., 0:1] ** 2 + a_wlh[..., 1:2] ** 2)
    return torch.cat([diag, diag, a_wlh[..., 2:3]], dim=-1)


def encode(boxes, anchors):
    """Encode (*, 7) boxes against (*, 7) anchors -> (*, 7) deltas."""
    g_xyz, g_wlh, g_yaw = boxes[..., 0:3], boxes[..., 3:6], boxes[..., 6:7]
    a_xyz, a_wlh, a_yaw = anchors[..., 0:3], anchors[..., 3:6], anchors[..., 6:7]
    a_norm = _anchor_diagonal(a_wlh)
    return torch.cat(
        [
            (g_xyz - a_xyz) / a_norm,
            torch.log(g_wlh / a_wlh),
            torch.remainder(g_yaw - a_yaw, math.pi),
        ],
        dim=-1,
    )


def decode(deltas, anchors, max_wlh_delta=10.0):
    """Decode (*, 7) deltas against (*, 7) anchors -> (*, 7) boxes.

    ``max_wlh_delta`` clamps the log-size residual before exp so an
    untrained delta cannot overflow to inf; None gives the raw reference
    behaviour.
    """
    p_xyz, p_wlh, p_yaw = deltas[..., 0:3], deltas[..., 3:6], deltas[..., 6:7]
    if max_wlh_delta is not None:
        p_wlh = torch.clamp(p_wlh, -max_wlh_delta, max_wlh_delta)
    a_xyz, a_wlh, a_yaw = anchors[..., 0:3], anchors[..., 3:6], anchors[..., 6:7]
    a_norm = _anchor_diagonal(a_wlh)
    return torch.cat(
        [p_xyz * a_norm + a_xyz, torch.exp(p_wlh) * a_wlh, p_yaw + a_yaw],
        dim=-1,
    )
