"""Z-window sparse conv: wrapper of the CUDA kernel ``csrc/zwin_conv.cu``.

Port of the TPU kernel ``vision3d_tpu/ops/pallas/zwin_conv.py:114``
(``zwin_conv_gemm_v2`` behind ``conv_zwin_apply_pallas2``). The TPU wrapper
gathered the z-window rows and built the tap masks in XLA before the
kernel; the CUDA kernel reads ``(feats, start, pattern)`` itself.

On a CPU tensor the wrapper runs the plain PyTorch version
(``ops.sparse.conv_zwin_apply``); on a CUDA tensor it launches the kernel
or raises. ``LAUNCHES["zwin_conv"]`` counts kernel launches.
"""

import ctypes

import torch

from vision3d_tpu_torch import kernels
from vision3d_tpu_torch.ops import sparse as sp

LAUNCHES = kernels.LAUNCHES
reset_launches = kernels.reset_launches
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COUTS = (16, 32, 64, 128)
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_VP] * 5 + [_CI] * 6 + [_VP]


def zwin_conv(feats, start, pattern, weight, kernel=(3, 3, 3),
              compute_dtype=torch.float32):
    """feats (B, N, C); start, pattern (B, M*9) int32 from
    ``sp.zwin_rulebook``; weight (27*C, Cout). Returns (B, M, Cout) f32.
    Inputs are rounded to ``compute_dtype`` (float32 or bfloat16); sums
    are float32."""
    if feats.device.type == "cpu":
        return sp.conv_zwin_apply(feats, start, pattern, weight, kernel,
                                  compute_dtype)
    if feats.device.type != "cuda":
        raise ValueError(f"zwin_conv: unsupported device {feats.device}")
    if tuple(kernel) != (3, 3, 3):
        raise ValueError(f"zwin_conv kernel supports (3, 3, 3) only, got {kernel}")
    if compute_dtype not in _DTYPES:
        raise TypeError(f"zwin_conv: compute_dtype {compute_dtype} unsupported")
    for name, t in (("start", start), ("pattern", pattern), ("weight", weight)):
        if t.device != feats.device:
            raise ValueError(f"zwin_conv: {name} on {t.device}, feats on {feats.device}")
    if feats.dim() != 3 or start.dim() != 2 or start.shape != pattern.shape:
        raise ValueError("zwin_conv: need feats (B, N, C) and start, pattern (B, M*9)")
    b, n, c = feats.shape
    if start.shape[0] != b or start.shape[1] % 9:
        raise ValueError(f"zwin_conv: start {tuple(start.shape)} vs feats {tuple(feats.shape)}")
    if start.dtype != torch.int32 or pattern.dtype != torch.int32:
        raise TypeError("zwin_conv: start and pattern must be int32")
    if weight.dim() != 2 or weight.shape[0] != 27 * c:
        raise ValueError(f"zwin_conv: weight {tuple(weight.shape)} is not (27*{c}, Cout)")
    cout = weight.shape[1]
    if cout not in _COUTS:
        raise ValueError(f"zwin_conv: Cout {cout} not in {_COUTS}")
    if not (feats.is_contiguous() and start.is_contiguous()
            and pattern.is_contiguous()):
        raise ValueError("zwin_conv: feats, start and pattern must be contiguous")
    m = start.shape[1] // 9
    x = feats.to(compute_dtype)
    w = weight.to(compute_dtype).contiguous()
    out = torch.empty((b, m, cout), dtype=torch.float32, device=feats.device)
    with torch.cuda.device(feats.device):
        kernels.launch(
            "zwin_conv", _ARGTYPES,
            x.data_ptr(), start.data_ptr(), pattern.data_ptr(), w.data_ptr(),
            out.data_ptr(), b, n, m, c, cout, _DTYPES[compute_dtype],
            torch.cuda.current_stream().cuda_stream)
    return out
