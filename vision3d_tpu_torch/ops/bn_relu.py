"""Inference epilogue of a conv: batch norm on the running statistics, ReLU,
zero off the active sites, cast to the compute dtype.

The middle extractor's ``models/sparse_cnn.bn_relu`` ends every conv with
it. In eval mode on a CUDA tensor it calls ``bn_relu`` here, which launches
the CUDA kernel ``csrc/bn_relu.cu`` (K4: one pass, bit-equal to
``bn_relu_plain``) or raises; on a CPU tensor ``bn_relu`` runs
``bn_relu_plain``, the PyTorch chain of ``MaskedBatchNorm``'s eval branch,
``relu``, ``where`` and the cast, each a pass over the whole tensor in
float32. ``LAUNCHES["bn_relu"]`` counts kernel launches and
``LAUNCHES["bn_relu.<route>"]`` those of each input dtype ("f32", "bf16").
"""

import ctypes

import torch
import torch.nn.functional as F

from vision3d_tpu_torch import kernels

LAUNCHES = kernels.LAUNCHES
ROUTES = kernels.ROUTES["bn_relu"]   # by the input dtype
_DTYPES = (torch.float32, torch.bfloat16)
_VP = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = [_VP, _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_longlong, _INT, _INT, _INT, _VP]


def bn_relu_plain(x, site, mean, var, weight, bias, eps, channel_dim=-1,
                  dtype=torch.float32):
    """Plain PyTorch version: ``x`` float32 or bf16 with its channels at
    ``channel_dim``, ``site`` bool of ``x``'s shape less that axis, the
    per-channel float32 statistics and affine parameters -> ``dtype``."""
    m = site.unsqueeze(channel_dim)
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    y = ((x.float() - mean.view(shape)) * torch.rsqrt(var.view(shape) + eps)
         * weight.view(shape) + bias.view(shape))
    y = torch.where(m, y, 0.0)
    return torch.where(m, F.relu(y), 0.0).to(dtype)


def bn_relu(x, site, mean, var, weight, bias, eps, channel_dim=-1, dtype=torch.float32):
    """``bn_relu_plain``'s function. On the card ``x`` (float32 or bf16)
    must be channels last in memory (``x.movedim(channel_dim, -1)``
    contiguous: a channels-last-3d volume, (B, N, C) or (B, Ncol, D, C)
    rows), with a channel count that 16-byte loads divide (C % 8 == 0 in
    bf16, C % 4 == 0 in float32); ``dtype`` float32 or bf16. Where ``x``
    has the dtype ``dtype`` the result is written over ``x``, which the
    caller passes as a temporary; otherwise into a new tensor of ``x``'s
    shape and strides. The kernel takes no gradient."""
    if x.device.type == "cpu":
        return bn_relu_plain(x, site, mean, var, weight, bias, eps, channel_dim, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"bn_relu: unsupported device {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("bn_relu: the kernel has no backward; run it under no_grad")
    if x.dtype not in _DTYPES or dtype not in _DTYPES:
        raise TypeError(f"bn_relu: dtypes {x.dtype} -> {dtype} unsupported")
    rows = x.movedim(channel_dim, -1)
    c = rows.shape[-1]
    per_load = 16 // x.element_size()
    if not rows.is_contiguous() or c == 0 or c % per_load or c // per_load > 256:
        raise ValueError(f"bn_relu: need channels-last rows of C % {per_load} == 0 "
                         f"channels, got shape {tuple(rows.shape)} with strides "
                         f"{rows.stride()}")
    if site.dtype != torch.bool or tuple(site.shape) != tuple(rows.shape[:-1]):
        raise ValueError(f"bn_relu: site {site.dtype} {tuple(site.shape)} for rows "
                         f"{tuple(rows.shape)}")
    if site.device != x.device or any(
            p.device != x.device or p.dtype != torch.float32 or tuple(p.shape) != (c,)
            or not p.is_contiguous() for p in (mean, var, weight, bias)):
        raise ValueError("bn_relu: site and the (C,) float32 statistics must be on the "
                         "input's device")
    out = x if x.dtype == dtype else torch.empty_like(x, dtype=dtype)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("bn_relu: input and output must be 16-byte aligned")
    rstd = torch.rsqrt(var + eps)
    site = site.contiguous()
    in_bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        kernels.launch(
            "bn_relu", _ARGTYPES, x.data_ptr(), site.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            rows.numel() // c, c, in_bf16, int(dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream, route=ROUTES[in_bf16])
    return out
