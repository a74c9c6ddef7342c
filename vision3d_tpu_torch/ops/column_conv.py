"""Column-sparse conv: wrapper of the CUDA kernels ``csrc/column_conv.cu``.

Port of the TPU kernel ``vision3d_tpu/ops/pallas/column_conv.py:86``
(``column_conv_pallas``): gather the K2 BEV-neighbour columns as flat
``D*C`` rows, then per output z one ``(kz*K2*C) x Cout`` product, with
``stride_z`` and ``pad_z``. The TPU wrapper padded rows to 1024 lanes,
appended a zero row, padded z and re-tiled the rulebook; the CUDA kernels
read ``(col_feats, rb_idx, weight)`` as the model holds them and treat a
rulebook entry outside ``[0, N)`` as a miss.

Two routes, picked by ``gather_gemm.route_of(compute_dtype, C, Cout)``, the
rule of the other convs: ``"mma"`` (tensor cores: the (column, zo) sites
that some tap reaches with a non-zero input z-slice are compacted per block
in shared memory, in tiles of 64 whose rulebook of ``kz*K2`` taps is built
there and run by the gather-GEMM tile of ``csrc/gather_tile_mma.cuh``; the
other output rows get exact zeros) for bfloat16 with ``C % 16 == 0``;
``"fma"`` (float32 FMA) for float32, whose card-vs-CPU checks need exact
products, and for C = 4. One route never stands in for the other: a failed
launch raises.

On a CPU tensor the wrapper runs the plain PyTorch version
(``ops.column_sparse.column_conv_dz``); on a CUDA tensor it launches the
kernel or raises.

Training (``ColumnConvFn``) runs the backward on the same kernels, not by
autograd through the plain version: dX is the ``column_conv`` kernel over
the transposed BEV rulebook (``column_sparse.transpose_bev_rulebook_batched``)
with the weights flipped in (dz, k2) and transposed in (C, Cout), on the
gradient rows zero-interleaved in z for ``stride_z`` 2, at ``pad_z' =
kz-1-pad_z``; dW regathers the K2 neighbour columns with the
``gather_rows`` kernel and takes one GEMM (``ops.sparse.matmul_f32``). On
the CPU the same decomposition runs on the plain versions. ``LAUNCHES["column_conv"]`` counts the wrapper's
launches (one a call, though "mma" enqueues a row-mask pass before its
kernel), ``LAUNCHES["column_conv.mma"]`` and ``["column_conv.fma"]`` those
of each route.
"""

import ctypes

import torch
import torch.nn.functional as F

from vision3d_tpu_torch import kernels
from vision3d_tpu_torch.ops import column_sparse as csp
from vision3d_tpu_torch.ops import sparse as sp
from vision3d_tpu_torch.ops.gather_gemm import aligned16, pick_route
from vision3d_tpu_torch.ops.gather_rows import gather_rows

LAUNCHES = kernels.LAUNCHES
ROUTES = kernels.ROUTES["column_conv"]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COUTS = (16, 32, 64)
_MAX_D, _MAX_K2, _MAX_TAPS = 60, 9, 32   # csrc/column_conv.cu
_INT_MAX = 2 ** 31 - 1
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_VP] * 5 + [_CI] * 13 + [_VP]
COLS_PER_BLOCK = None   # an int (1..128) forces the rule below


def cols_per_block(d_out):
    """Output columns a block of the "mma" route owns: 32 at D_out above
    16, else 64, so a block covers at most ~1300 (column, z) output rows
    and lists a few tiles of 64 active sites. On the H100
    (tools/microbench_torch_column.py) 32 ran faster than 64 at D_out 21
    and 41 and slower at D_out 5; 16 and 128 were slower at all shapes
    but one."""
    if COLS_PER_BLOCK is not None:
        return COLS_PER_BLOCK
    return 32 if d_out > 16 else 64


def column_conv(col_feats, rb_idx, weight, kernel, d, c, stride_z=1, pad_z=0,
                compute_dtype=torch.float32, route=None):
    """col_feats (B, N, D*C) flat z-major rows; rb_idx (B, M*K2) int32 with
    misses = N (K2 = ky*kx minor); weight (kz*K2*C, Cout), taps
    (dz, dy, dx)-major. Returns (B, M, D_out*Cout) f32 with
    ``D_out = (D + 2*pad_z - kz)//stride_z + 1``. Inputs are rounded to
    ``compute_dtype`` (float32 or bfloat16); sums are float32. ``route``
    (card only) forces a kernel where the comparisons need both; by
    default ``route_of`` picks it."""
    if col_feats.device.type == "cpu":
        return csp.column_conv_dz(col_feats, rb_idx, weight, kernel, d, c,
                                  stride_z, pad_z, compute_dtype)
    if col_feats.device.type != "cuda":
        raise ValueError(f"column_conv: unsupported device {col_feats.device}")
    if compute_dtype not in _DTYPES:
        raise TypeError(f"column_conv: compute_dtype {compute_dtype} unsupported")
    for name, t in (("rb_idx", rb_idx), ("weight", weight)):
        if t.device != col_feats.device:
            raise ValueError(f"column_conv: {name} on {t.device}, col_feats on "
                             f"{col_feats.device}")
    kz, ky, kx = kernel
    k2 = ky * kx
    if (col_feats.dim() != 3 or rb_idx.dim() != 2
            or rb_idx.shape[0] != col_feats.shape[0]):
        raise ValueError("column_conv: need col_feats (B, N, D*C) and rb_idx (B, M*K2)")
    b, n, dc = col_feats.shape
    if dc != d * c or c <= 0 or c & (c - 1):
        raise ValueError(f"column_conv: rows of {dc} values are not D*C = {d}*{c} "
                         "with C a power of two")
    if (d < 1 or pad_z < 0 or d + 2 * pad_z > _MAX_D or not 0 < k2 <= _MAX_K2
            or not 0 < kz * k2 <= _MAX_TAPS or rb_idx.shape[1] % k2):
        raise ValueError(f"column_conv: D {d} + 2*pad_z {pad_z} (max {_MAX_D}), "
                         f"kernel {kernel} (K2 max {_MAX_K2}, kz*K2 max {_MAX_TAPS}) "
                         f"or rb_idx {tuple(rb_idx.shape)} unsupported")
    if rb_idx.dtype != torch.int32:
        raise TypeError("column_conv: rb_idx must be int32")
    if weight.dim() != 2 or weight.shape[0] != kz * k2 * c:
        raise ValueError(f"column_conv: weight {tuple(weight.shape)} is not "
                         f"({kz}*{k2}*{c}, Cout)")
    cout = weight.shape[1]
    if cout not in _COUTS:
        raise ValueError(f"column_conv: Cout {cout} not in {_COUTS}")
    d_out = csp.conv_out_depth(d, kz, stride_z, pad_z)
    if stride_z < 1 or pad_z < 0 or d_out < 1:
        raise ValueError(f"column_conv: stride_z {stride_z}, pad_z {pad_z} give "
                         f"D_out {d_out}")
    if not (col_feats.is_contiguous() and rb_idx.is_contiguous()):
        raise ValueError("column_conv: col_feats and rb_idx must be contiguous")
    route = pick_route("column_conv", compute_dtype, c, cout, route)
    m = rb_idx.shape[1] // k2
    if route == "mma" and (b * n * d >= _INT_MAX or b * m * d_out + 64 >= _INT_MAX):
        raise ValueError(f"column_conv: B*N*D {b * n * d} or B*M*D_out "
                         f"{b * m * d_out} too large for the mma route")
    x = col_feats.to(compute_dtype)
    w = weight.to(compute_dtype).contiguous()
    zmask = None
    if route == "mma":
        x, w = aligned16(x), aligned16(w)
        zmask = torch.empty((b * n,), dtype=torch.int64, device=col_feats.device)
    out = torch.empty((b, m, d_out * cout), dtype=torch.float32,
                      device=col_feats.device)
    if b == 0 or m == 0:
        return out
    with torch.cuda.device(col_feats.device):
        kernels.launch(
            "column_conv", _ARGTYPES,
            x.data_ptr(), rb_idx.data_ptr(), w.data_ptr(), out.data_ptr(),
            0 if zmask is None else zmask.data_ptr(),
            b, n, m, k2, d, c, cout, kz, stride_z, pad_z, _DTYPES[compute_dtype],
            ROUTES.index(route), cols_per_block(d_out),
            torch.cuda.current_stream().cuda_stream, route=route)
    return out


def interleave_z(g, d_in, kz, stride_z, pad_z, cout):
    """The gradient rows (B, M, D_out*Cout) of a conv with ``stride_z`` as
    the rows of a stride-1 conv's output: row zo moves to z = zo*stride_z,
    zeros between, and zeros at the end up to D' = D_in + 2*pad_z - kz + 1
    (where the forward's floor division dropped input rows).
    Returns (B, M, D'*Cout), contiguous."""
    b, m, _ = g.shape
    d_out = g.shape[2] // cout
    d_full = d_in + 2 * pad_z - kz + 1
    if stride_z == 1:
        return g
    gi = g.new_zeros((b, m, d_full, cout))
    gi[:, :, :(d_out - 1) * stride_z + 1:stride_z] = g.reshape(b, m, d_out, cout)
    return gi.reshape(b, m, d_full * cout)


def column_conv_dx(g, rbt_idx, weight, kernel, d, c, stride_z, pad_z,
                   compute_dtype):
    """dX (B, N, D*C) float32 of a column conv: the ``column_conv`` kernel
    on the z-interleaved gradient rows, over the transposed rulebook
    ``rbt_idx`` (B, N*K2) (misses = M), with the flipped, transposed
    weights, stride 1 and ``pad_z' = kz-1-pad_z``."""
    kz = kernel[0]
    cout = weight.shape[1]
    pad_t = kz - 1 - pad_z
    if pad_t < 0:
        raise ValueError(f"column_conv_dx: pad_z {pad_z} > kz-1 = {kz - 1}")
    gi = interleave_z(g, d, kz, stride_z, pad_z, cout)
    wt = sp.flip_transpose_weight(weight, c)
    return column_conv(gi.to(compute_dtype), rbt_idx, wt, kernel,
                       gi.shape[2] // cout, cout, 1, pad_t, compute_dtype)


def column_conv_dw(col_feats, rb_idx, g, kernel, d, c, stride_z, pad_z,
                   compute_dtype):
    """dW (kz*K2*C, Cout) float32 of a column conv: the K2 neighbour
    columns regathered (``gather_rows``) from the z-padded
    (B*(N+1), (D + 2*pad_z)*C) table, their kz-windows per output z, and
    one GEMM against the gradient rows, as ``conv_rb_dw`` does for voxels."""
    b, n, _ = col_feats.shape
    kz, ky, kx = kernel
    k2 = ky * kx
    m = rb_idx.shape[1] // k2
    cout = g.shape[2] // csp.conv_out_depth(d, kz, stride_z, pad_z)
    dp = d + 2 * pad_z
    table = F.pad(col_feats.to(compute_dtype).reshape(b, n, d, c),
                  (0, 0, pad_z, pad_z, 0, 1)).reshape(b * (n + 1), dp * c)
    base = torch.arange(b, dtype=torch.int32, device=col_feats.device)[:, None] * (n + 1)
    cols = gather_rows(table, (rb_idx + base).reshape(-1)).reshape(b * m, k2, dp, c)
    # (B*M, K2, D_out, C, kz) -> rows (site, zo), columns (k2, dz, c)
    win = cols.unfold(2, kz, stride_z).permute(0, 2, 1, 4, 3)
    a = win.reshape(-1, k2 * kz * c)
    dw = sp.matmul_f32(a, g.reshape(a.shape[0], cout).to(compute_dtype))
    return dw.reshape(k2, kz, c, cout).transpose(0, 1).reshape(kz * k2 * c, cout)


class ColumnConvFn(torch.autograd.Function):
    """Column conv f(col_feats, rb, rbt, weight, kernel, d, c, stride_z,
    pad_z, compute_dtype) -> (B, M, D_out*Cout) float32 (``column_conv``)
    whose backward is ``column_conv_dx`` over the transposed rulebook
    ``rbt`` and ``column_conv_dw`` (a submanifold conv passes its forward
    rulebook as ``rbt``; ``rbt`` may be None where ``col_feats`` takes no
    gradient). The JAX package differentiates
    ``column_conv_dz`` (vision3d_tpu/ops/column_sparse.py:105) by
    autodiff; the gradients are the same function. No gradient to the
    rulebooks."""

    @staticmethod
    def forward(ctx, col_feats, rb_idx, rbt_idx, weight, kernel, d, c,
                stride_z, pad_z, compute_dtype):
        ctx.save_for_backward(col_feats, rb_idx, rbt_idx, weight)
        ctx.conv = (kernel, d, c, stride_z, pad_z, compute_dtype)
        return column_conv(col_feats, rb_idx, weight, kernel, d, c, stride_z,
                           pad_z, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        col_feats, rb_idx, rbt_idx, weight = ctx.saved_tensors
        conv = ctx.conv
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = column_conv_dx(g, rbt_idx, weight, *conv).to(col_feats.dtype)
        if ctx.needs_input_grad[3]:
            dw = column_conv_dw(col_feats, rb_idx, g, *conv).to(weight.dtype)
        return (dx, None, None, dw) + (None,) * 6
