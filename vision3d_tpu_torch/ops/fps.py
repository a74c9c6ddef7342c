"""Furthest point sampling (port of ``vision3d_tpu/ops/fps.py``).

Start at the first valid point (index 0 when there is none), then K-1
times take the point whose running min-distance to the chosen set is
largest. The running distance starts at +inf on valid points and -inf on
invalid ones, so an invalid point is never taken; ``torch.argmax`` takes
the first maximum, as ``jnp.argmax`` does. Once every valid point has been
taken the loop repeats points at distance 0, as the JAX loop does.

On a CPU tensor ``furthest_point_sample`` runs the plain version
(``furthest_point_sample_plain``: batched over B as (B, N) tensors, one
Python loop of K-1 steps of plain PyTorch); on a CUDA tensor it launches the
CUDA kernel ``csrc/fps.cu`` (K3: a thread-block cluster a cloud, every step
on the card, the indices bit-equal to the plain version's) or raises.
``LAUNCHES["fps"]`` counts kernel launches, ``LAUNCHES["fps.<route>"]``
those of each route (where a block keeps its slice of the cloud: "reg",
"smem" or "global", from N and the cluster size ``plan`` gives).

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

import ctypes

import torch

from vision3d_tpu_torch import kernels
from vision3d_tpu_torch.training.profiler import annotate

LAUNCHES = kernels.LAUNCHES
ROUTES = kernels.ROUTES["fps"]
_VP = ctypes.c_void_p
_INT = ctypes.c_int
_PLAN_ARGTYPES = [_INT, _INT, ctypes.POINTER(_INT), ctypes.POINTER(_INT)]
_ARGTYPES = [_VP, _VP, _INT, _INT, _INT, _INT, _INT, _VP, _VP, _VP]


def squared_distance(a, b):
    """|a - b|^2 over the last axis (3), float32, in XLA's CPU rounding."""
    d = (a - b).double()
    p = (d[..., 0] * d[..., 0]).float().double()
    q = (d[..., 1] * d[..., 1] + p).float().double()
    return (d[..., 2] * d[..., 2] + q).float()


def furthest_point_sample_plain(xyz, mask, k: int):
    """Plain PyTorch version: xyz (B, N, 3) float32, mask (B, N) bool ->
    indices (B, K) int64."""
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


def plan(b: int, n: int, device):
    """(route, cluster size) that K3 takes for B clouds of N points on a CUDA
    ``device``: the widest cluster of 16, 8, 4, 2 or 1 blocks a cloud at
    which every cloud's cluster is resident on the card at once, and the
    route where each block then keeps its slice of N / C points."""
    route, cluster = _INT(), _INT()
    with torch.cuda.device(device):
        kernels.call("fps", "fps_plan", _PLAN_ARGTYPES, b, n, ctypes.byref(route),
                     ctypes.byref(cluster))
    return ROUTES[route.value], cluster.value


def furthest_point_sample(xyz, mask, k: int):
    """xyz (B, N, 3) float32 with finite coordinates, mask (B, N) bool ->
    indices (B, K) int64, K >= 1. On the card both inputs must be
    contiguous."""
    if mask.device != xyz.device:
        raise ValueError(f"furthest_point_sample: inputs on {xyz.device}, {mask.device}")
    if xyz.dim() != 3 or xyz.shape[2] != 3 or tuple(mask.shape) != tuple(xyz.shape[:2]):
        raise ValueError("furthest_point_sample: need xyz (B, N, 3) and mask (B, N)")
    if k < 1:
        raise ValueError(f"furthest_point_sample: K {k} < 1")
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, mask, k)
    if xyz.device.type != "cuda":
        raise ValueError(f"furthest_point_sample: unsupported device {xyz.device}")
    if xyz.dtype != torch.float32:
        raise TypeError("furthest_point_sample: xyz must be float32")
    if mask.dtype != torch.bool:
        raise TypeError("furthest_point_sample: mask must be bool")
    if not (xyz.is_contiguous() and mask.is_contiguous()):
        raise ValueError("furthest_point_sample: xyz and mask must be contiguous")
    b, n, _ = xyz.shape
    if n < 1 or b > 65535 or n >= 2 ** 31 or k >= 2 ** 31:
        raise ValueError(f"furthest_point_sample: unsupported sizes B {b}, N {n}, K {k}")
    out = torch.empty((b, k), dtype=torch.int64, device=xyz.device)
    if b == 0:
        return out
    route, cluster = plan(b, n, xyz.device)
    scratch = (torch.empty((b, n), dtype=torch.float32, device=xyz.device)
               if route == "global" else None)
    with torch.cuda.device(xyz.device):
        kernels.launch(
            "fps", _ARGTYPES, xyz.data_ptr(), mask.data_ptr(), b, n, k, ROUTES.index(route),
            cluster, None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream, route=route)
    return out


def sample_keypoints(points_xyz, mask, k: int):
    """points_xyz (B, N, 3), mask (B, N) -> (keypoints (B, K, 3), their
    indices (B, K))."""
    idx = furthest_point_sample(points_xyz.contiguous(), mask, k)
    bidx = torch.arange(points_xyz.shape[0], device=idx.device)[:, None]
    return points_xyz[bidx, idx], idx
