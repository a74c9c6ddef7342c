"""Row gather ``out[i] = table[idx[i]]``: wrapper of the CUDA kernel
``csrc/gather_rows.cu``.

One kernel for the two TPU kernels that compute this function,
``vision3d_tpu/ops/pallas/gather.py:34`` (``gather_rows``) and
``vision3d_tpu/ops/pallas/dma_gather.py:29`` (``dma_gather_rows``). The
training graph uses it to regather a sparse conv's input columns for dW.

On a CPU tensor the wrapper runs the plain PyTorch version
(``gather_rows_plain``); on a CUDA tensor it launches the kernel or
raises. ``LAUNCHES["gather_rows"]`` counts kernel launches.
"""

import ctypes

import torch

from vision3d_tpu_torch import kernels

LAUNCHES = kernels.LAUNCHES
_DTYPES = (torch.float32, torch.bfloat16)
_VP = ctypes.c_void_p
_ARGTYPES = [_VP, _VP, _VP, ctypes.c_longlong, ctypes.c_int, _VP]


def gather_rows_plain(table, idx):
    """Plain PyTorch version: advanced indexing."""
    return table[idx.long()]


def gather_rows(table, idx):
    """table (R, C) float32 or bfloat16; idx (Q,) int32 in [0, R), any Q.
    Returns (Q, C) in the table's dtype. Rows out of range are the
    caller's fault: the kernel does not check them."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    if idx.device != table.device:
        raise ValueError(f"gather_rows: idx on {idx.device}, table on {table.device}")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError("gather_rows: need table (R, C) and idx (Q,)")
    if table.dtype not in _DTYPES:
        raise TypeError(f"gather_rows: table dtype {table.dtype} unsupported")
    if idx.dtype != torch.int32:
        raise TypeError("gather_rows: idx must be int32")
    if table.shape[0] == 0 and idx.numel():
        raise ValueError("gather_rows: empty table")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows: table and idx must be contiguous")
    q, c = idx.shape[0], table.shape[1]
    out = torch.empty((q, c), dtype=table.dtype, device=table.device)
    if q == 0 or c == 0:
        return out
    with torch.cuda.device(table.device):
        kernels.launch(
            "gather_rows", _ARGTYPES,
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), q,
            c * table.element_size(),
            torch.cuda.current_stream().cuda_stream)
    return out
