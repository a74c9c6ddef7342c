"""Rulebook gather-GEMM: wrapper of the CUDA kernels ``csrc/gather_gemm.cu``.

Port of the TPU kernel ``vision3d_tpu/ops/pallas/sparse_conv.py:52``
(``fused_gather_gemm``: ``out[n] = concat_k(table[idx[n, k]]) @ W``), the
compute of every full-tap sparse conv of the training graph, forward and
dX. The TPU wrapper took one flat table with a zero row for misses; the
CUDA kernels read the batched ``(feats, rb)`` themselves and treat any row
outside ``[0, N)`` as a miss.

Two routes, picked by ``route_of(compute_dtype, C, Cout)`` and nothing
else: ``"mma"`` (tensor cores, ``mma.sync`` on tiles of gathered rows
staged by ``cp.async``) for bfloat16 with ``C % 16 == 0`` and
``Cout % 8 == 0``; ``"fma"`` (float32 FMA) for float32 and the other
bfloat16 widths. float32 stays off the tensor cores: the card-vs-CPU
checks need exact f32 products. One route never stands in for the other:
a failed launch raises.

On a CPU tensor the wrapper runs the plain PyTorch version
(``ops.sparse.conv_rulebook_apply``); on a CUDA tensor it launches a
kernel or raises. ``LAUNCHES["gather_gemm"]`` counts kernel launches,
``LAUNCHES["gather_gemm.mma"]`` and ``LAUNCHES["gather_gemm.fma"]`` those
of each route.
"""

import ctypes

import torch

from vision3d_tpu_torch import kernels
from vision3d_tpu_torch.ops import sparse as sp

LAUNCHES = kernels.LAUNCHES
ROUTES = kernels.ROUTES["gather_gemm"]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COUTS = (4, 8, 16, 32, 64, 128)
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_VP] * 4 + [_CI] * 8 + [_VP]


def route_of(compute_dtype, c, cout):
    """The kernel a call with these widths takes: "mma" for bfloat16 with
    C % 16 == 0 and Cout % 8 == 0 (the MMA's depth and width), else
    "fma". The z-window conv (``ops/zwin_conv.py``) takes the same rule."""
    if compute_dtype == torch.bfloat16 and c % 16 == 0 and cout % 8 == 0:
        return "mma"
    return "fma"


def pick_route(name, compute_dtype, c, cout, route=None):
    """The route a call of kernel ``name`` takes: ``route`` where the
    caller forces one, else ``route_of``'s. Raises for a route the kernel
    does not have, and for "mma" on widths or a dtype it cannot take."""
    chosen = route_of(compute_dtype, c, cout)
    route = chosen if route is None else route
    if route not in kernels.ROUTES[name] or (route == "mma" and chosen != "mma"):
        raise ValueError(f"{name}: route {route!r} cannot take {compute_dtype} {c}x{cout}")
    return route


def aligned16(t):
    """``t`` itself if its data starts on a 16-byte boundary (what the mma
    route's cp.async needs), else a fresh copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def gather_gemm(feats, rb, weight, compute_dtype=torch.float32, route=None):
    """feats (B, N, C); rb (B, M*K) int32 rows with misses = N; weight
    (K*C, Cout). Returns (B, M, Cout) f32. Inputs are rounded to
    ``compute_dtype`` (float32 or bfloat16); sums are float32. ``route``
    (card only) forces a kernel where the comparisons need both; by
    default ``route_of`` picks it."""
    if feats.device.type == "cpu":
        return sp.conv_rulebook_apply(feats, rb, weight, compute_dtype)
    if feats.device.type != "cuda":
        raise ValueError(f"gather_gemm: unsupported device {feats.device}")
    if compute_dtype not in _DTYPES:
        raise TypeError(f"gather_gemm: compute_dtype {compute_dtype} unsupported")
    for name, t in (("rb", rb), ("weight", weight)):
        if t.device != feats.device:
            raise ValueError(f"gather_gemm: {name} on {t.device}, feats on {feats.device}")
    if feats.dim() != 3 or rb.dim() != 2 or rb.shape[0] != feats.shape[0]:
        raise ValueError("gather_gemm: need feats (B, N, C) and rb (B, M*K)")
    if rb.dtype != torch.int32:
        raise TypeError("gather_gemm: rb must be int32")
    b, n, c = feats.shape
    if weight.dim() != 2 or c == 0 or weight.shape[0] % c:
        raise ValueError(f"gather_gemm: weight {tuple(weight.shape)} is not (K*{c}, Cout)")
    k = weight.shape[0] // c
    if k == 0 or rb.shape[1] % k:
        raise ValueError(f"gather_gemm: rb {tuple(rb.shape)} is not (B, M*{k})")
    cout = weight.shape[1]
    if cout not in _COUTS:
        raise ValueError(f"gather_gemm: Cout {cout} not in {_COUTS}")
    if not (feats.is_contiguous() and rb.is_contiguous()):
        raise ValueError("gather_gemm: feats and rb must be contiguous")
    route = pick_route("gather_gemm", compute_dtype, c, cout, route)
    m = rb.shape[1] // k
    x = feats.to(compute_dtype)
    w = weight.to(compute_dtype).contiguous()
    if route == "mma":
        x, w = aligned16(x), aligned16(w)
    out = torch.empty((b, m, cout), dtype=torch.float32, device=feats.device)
    if b == 0 or m == 0:
        return out
    with torch.cuda.device(feats.device):
        kernels.launch(
            "gather_gemm", _ARGTYPES,
            x.data_ptr(), rb.data_ptr(), w.data_ptr(), out.data_ptr(),
            b, n, m, k, c, cout, _DTYPES[compute_dtype], ROUTES.index(route),
            torch.cuda.current_stream().cuda_stream, route=route)
    return out
