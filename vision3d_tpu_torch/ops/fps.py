"""Furthest point sampling (port of ``vision3d_tpu/ops/fps.py``).

Start at the first valid point (index 0 when there is none), then K-1
times take the point whose running min-distance to the chosen set is
largest. The running distance starts at +inf on valid points and -inf on
invalid ones, so an invalid point is never taken; ``torch.argmax`` takes
the first maximum, as ``jnp.argmax`` does. Once every valid point has been
taken the loop repeats points at distance 0, as the JAX loop does.

Batched over B as (B, N) tensors: one Python loop of K-1 steps of plain
PyTorch, no loop over the batch.

``squared_distance`` rounds as XLA's CPU code does for
``jnp.sum(jnp.square(a - b), -1)``: fma(dz, dz, fma(dy, dy, dx * dx)) in
float32. Each product of two float32 numbers is exact in float64, so the
fused multiply-adds run as float64 sums rounded to float32, on the CPU and
on the card alike (each torch op is its own kernel, so no compiler fuses
them otherwise). A float64 sum rounded again to float32 differs from one
rounding only when it falls exactly on a float32 midpoint. FPS indices
and ball-query memberships depend on every distance's bits, so they equal
the JAX package's on the CPU and the card's equal the CPU's.
"""

import torch

from vision3d_tpu_torch.training.profiler import annotate


def squared_distance(a, b):
    """|a - b|^2 over the last axis (3), float32, in XLA's CPU rounding."""
    d = (a - b).double()
    p = (d[..., 0] * d[..., 0]).float().double()
    q = (d[..., 1] * d[..., 1] + p).float().double()
    return (d[..., 2] * d[..., 2] + q).float()


def furthest_point_sample(xyz, mask, k: int):
    """xyz (B, N, 3) float32, mask (B, N) bool -> indices (B, K) int64."""
    b = xyz.shape[0]
    bidx = torch.arange(b, device=xyz.device)
    with annotate("sync"):
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


def sample_keypoints(points_xyz, mask, k: int):
    """points_xyz (B, N, 3), mask (B, N) -> (keypoints (B, K, 3), their
    indices (B, K))."""
    idx = furthest_point_sample(points_xyz, mask, k)
    bidx = torch.arange(points_xyz.shape[0], device=idx.device)[:, None]
    return points_xyz[bidx, idx], idx
