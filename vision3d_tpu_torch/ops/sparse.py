"""Key-sorted sparse voxel tensors, z-window rulebooks (inference) and
full-tap rulebooks with conv-as-backward autograd functions (training):
port of the subset of ``vision3d_tpu/ops/sparse.py`` that SECOND runs.

A sparse tensor is a fixed-capacity, key-sorted structure per sample:
``feats (B, N, C)``, ``keys (B, N)`` int32 column-major linear keys
(``(y*W + x)*D + z``, so one BEV column's voxels are consecutive) with a
sentinel past every real key on padding rows, and ``mask (B, N)``.

What is ported is each function's OUTPUT contract, not its TPU internals:
the JAX plan builds byte-plane record images, column caches and phase
barriers to suit the TPU's gather costs; here the rulebook comes straight
from the sorted keys with ``torch.searchsorted``. Convention for conv
arithmetic (torch/spconv): out[o] receives in[o*stride - pad + d] for
kernel offset d in [0, k).
"""

import numpy as np
import torch

from vision3d_tpu_torch.training.profiler import annotate


def sentinel_key(grid) -> int:
    d, h, w = grid
    return d * h * w


def coords_to_keys(coords, grid):
    """(..., 3) int ZYX -> (...) column-major linear keys."""
    d, h, w = grid
    return (coords[..., 1] * w + coords[..., 2]) * d + coords[..., 0]


def keys_to_coords(keys, grid):
    d, h, w = grid
    return torch.stack([keys % d, keys // (w * d), (keys // d) % w], dim=-1)


def make_sorted(feats, coords, mask, grid):
    """Batched (B, N, ...) voxelizer output -> key-sorted (feats, keys, mask).
    The sort is stable, as ``jnp.argsort`` is."""
    keys = torch.where(mask, coords_to_keys(coords, grid).to(torch.int32),
                       sentinel_key(grid))
    keys, order = torch.sort(keys, dim=1, stable=True)
    feats = torch.gather(feats, 1, order[..., None].expand(feats.shape))
    return feats, keys, torch.gather(mask, 1, order)


def out_grid_shape(in_grid, kernel, stride, pad):
    """Static output spatial dims: (D + 2p - k)//s + 1 per axis."""
    return tuple(
        (in_grid[i] + 2 * pad[i] - kernel[i]) // stride[i] + 1 for i in range(3)
    )


def downsample_active_set(keys, mask, in_grid, kernel, stride, pad, out_cap):
    """Active output key set of a strided sparse conv, batched.

    An output site is active if any active input lies in its window (the
    spconv rule). Candidates are enumerated exactly (ceil(k/s) offsets per
    dim), sorted, uniqued and compacted to ``out_cap`` in ascending key
    order, so truncation drops the largest keys deterministically.

    Returns (out_keys (B, out_cap) int32 sentinel-padded, out_mask,
    n_dropped (B,) int32: true active sites beyond the cap).
    """
    b, n = keys.shape
    og = out_grid_shape(in_grid, kernel, stride, pad)
    s_out = sentinel_key(og)
    dev = keys.device
    coords = keys_to_coords(torch.where(mask, keys, 0), in_grid)  # (B, N, 3)

    cnt = [-(-k_ // s_) for k_, s_ in zip(kernel, stride)]
    joffs = np.stack(np.meshgrid(*[np.arange(c_) for c_ in cnt], indexing="ij"),
                     -1).reshape(-1, 3)
    with annotate("sync"):
        stride_t = torch.tensor(stride, dtype=torch.int32, device=dev)
        pad_t = torch.tensor(pad, dtype=torch.int32, device=dev)
        kern_t = torch.tensor(kernel, dtype=torch.int32, device=dev)
        og_t = torch.tensor(og, dtype=torch.int32, device=dev)
        joffs_t = torch.tensor(joffs, dtype=torch.int32, device=dev)

    cp = (coords + pad_t)[:, None]                         # (B, 1, N, 3)
    d0 = cp % stride_t
    dd = d0 + joffs_t[:, None] * stride_t
    o = torch.div(cp - dd, stride_t, rounding_mode="floor")  # (B, J, N, 3)
    ok = ((dd < kern_t).all(-1) & (o >= 0).all(-1) & (o < og_t).all(-1)
          & mask[:, None, :])
    okey = (o[..., 1] * og[2] + o[..., 2]) * og[0] + o[..., 0]
    okey = torch.where(ok, okey, s_out).reshape(b, -1)

    skey = torch.sort(okey, dim=1).values
    first = torch.ones_like(skey, dtype=torch.bool)
    first[:, 1:] = skey[:, 1:] != skey[:, :-1]
    first &= skey < s_out
    rank = first.to(torch.int64).cumsum(dim=1) - 1
    keep = first & (rank < out_cap)
    out_keys = torch.full((b, out_cap + 1), s_out, dtype=torch.int32, device=dev)
    out_keys.scatter_(1, torch.where(keep, rank, out_cap), skey)
    out_keys = out_keys[:, :out_cap].contiguous()
    n_dropped = (first.sum(dim=1) - out_cap).clamp(min=0).to(torch.int32)
    return out_keys, out_keys < s_out, n_dropped


def zwin_rulebook(keys, mask, grid, out_keys, out_mask, out_grid, kernel,
                  stride=(1, 1, 1), pad=(0, 0, 0)):
    """Z-window rulebook: per (output site, BEV offset), the START row of
    the neighbor column's kz-window and a kz-bit presence pattern.

    Contract of ``csr_zwin_rulebook`` (vision3d_tpu/ops/sparse.py:1246):
    keys are column-major sorted, so a column's voxels with z in
    [z0, z0+kz) are consecutive rows from ``start = colstart +
    (active voxels of the column below max(z0, 0))``, which is exactly
    ``searchsorted(keys, cell*D + max(z0, 0))``. Bit dz of ``pattern`` is
    set iff z0+dz is active in that column. Misses (out-of-grid neighbor,
    empty window, padded site) get start = N and pattern 0.

    Returns (start (B, M*K2) int32, pattern (B, M*K2) int32), site-major.
    """
    b, n = keys.shape
    m = out_keys.shape[1]
    d, h, w = grid
    kz, ky, kx = kernel
    k2 = ky * kx
    assert kz <= 3, kz
    od, oh, ow = out_grid
    dev = keys.device
    ok = torch.where(out_mask, out_keys, 0)
    oz = ok % od
    oy = ok // (ow * od)
    ox = (ok // od) % ow

    with annotate("sync"):
        offs = torch.tensor(
            np.stack(np.meshgrid(np.arange(ky), np.arange(kx), indexing="ij"), -1)
            .reshape(-1, 2), dtype=torch.int32, device=dev)
    ny = oy[..., None] * stride[1] - pad[1] + offs[:, 0]     # (B, M, K2)
    nx = ox[..., None] * stride[2] - pad[2] + offs[:, 1]
    okbev = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w) & out_mask[..., None]
    base = torch.where(okbev, ny * w + nx, 0) * d             # column key base
    z0 = (oz * stride[0] - pad[0])[..., None].expand(b, m, k2)

    start = torch.searchsorted(keys, (base + z0.clamp(min=0)).reshape(b, -1)
                               .contiguous()).reshape(b, m, k2)
    pattern = torch.zeros_like(start)
    for j in range(kz):
        row = start + j
        kj = torch.gather(keys, 1, row.clamp(max=n - 1).reshape(b, -1))
        rel = kj.reshape(b, m, k2) - base                     # z of candidate j
        dz = rel - z0
        hit = (row < n) & (rel >= 0) & (rel < d) & (dz >= 0) & (dz < kz)
        pattern |= torch.where(hit, torch.ones_like(dz) << dz.clamp(0, kz - 1), 0)
    pattern = torch.where(okbev, pattern, 0)
    start = torch.where(pattern > 0, start, n)
    return (start.reshape(b, -1).to(torch.int32),
            pattern.reshape(b, -1).to(torch.int32))


# The JAX plan takes its per-column rulebook caches (and so honours the
# column caps) only when the input BEV has more cells than this
# (vision3d_tpu/ops/sparse.py:537); the port's plan copies the condition so
# that its drop counts and blanked windows agree under overflow.
DENSE_SHIFT_MAX_BEV_CELLS = 1_000_000


def column_overflow(keys, mask, depth, col_cap):
    """Sites of active BEV columns beyond ``col_cap`` (columns in key
    order; a site's column slot is the first-of-column cumsum).

    Returns (over (B, N) bool, ncol_dropped (B,) int32). ``col_cap`` None
    or 0 means one slot per site: nothing overflows."""
    nc = col_cap or keys.shape[1]
    cell = keys // depth
    first = mask.clone()
    first[:, 1:] &= cell[:, 1:] != cell[:, :-1]
    colslot = first.to(torch.int32).cumsum(dim=1) - 1
    ncol_dropped = (first.sum(dim=1) - nc).clamp(min=0).to(torch.int32)
    return mask & (colslot >= nc), ncol_dropped


def _blank_sites(rb, over, n):
    """Empty windows (start n, pattern 0) at the sites flagged in ``over``."""
    start, pattern = rb
    b, m = over.shape
    o = over[..., None].expand(b, m, start.shape[1] // m).reshape(b, -1)
    return (torch.where(o, torch.full_like(start, n), start),
            torch.where(o, torch.zeros_like(pattern), pattern))


def plan_stage_batched(keys, mask, grid, down_kernel, down_stride, down_pad,
                       out_cap, subm_kernel=None, subm_col_cap=None,
                       down_col_cap=None):
    """Per-stage plan: the down conv's active output set plus the z-window
    rulebooks of the stage's submanifold convs and of its down conv.

    Returns (rb_subm or None, rb_down, out_keys, out_mask, n_dropped), each
    rulebook a (start, pattern) pair; n_dropped (B,) counts active output
    sites the capacity truncated. Output contract of
    ``plan_stage_batched`` (vision3d_tpu/ops/sparse.py:1460), except that
    the JAX plan switches to full-tap rulebooks for D > 48 and this one
    stays z-window for any D.

    ``subm_col_cap`` / ``down_col_cap`` have the JAX meaning on the JAX
    branch: for ``grid[0] <= 48`` and a BEV above
    ``DENSE_SHIFT_MAX_BEV_CELLS`` cells, sites of active output columns
    beyond the cap (in key order) get empty windows, and the columns
    dropped are added to ``n_dropped``. Elsewhere the caps are ignored.
    """
    n = keys.shape[1]
    out_grid = out_grid_shape(grid, down_kernel, down_stride, down_pad)
    out_keys, out_mask, n_dropped = downsample_active_set(
        keys, mask, grid, down_kernel, down_stride, down_pad, out_cap)
    capped = grid[0] <= 48 and grid[1] * grid[2] > DENSE_SHIFT_MAX_BEV_CELLS
    rbs = None
    if subm_kernel is not None:
        pad_s = tuple(s // 2 for s in subm_kernel)
        rbs = zwin_rulebook(keys, mask, grid, keys, mask, grid, subm_kernel,
                            (1, 1, 1), pad_s)
        if capped:
            over, cdrop = column_overflow(keys, mask, grid[0], subm_col_cap)
            rbs = _blank_sites(rbs, over, n)
            n_dropped = n_dropped + cdrop
    rbd = zwin_rulebook(keys, mask, grid, out_keys, out_mask, out_grid,
                        down_kernel, down_stride, down_pad)
    if capped:
        over, cdrop = column_overflow(out_keys, out_mask, out_grid[0],
                                      down_col_cap)
        rbd = _blank_sites(rbd, over, n)
        n_dropped = n_dropped + cdrop
    return rbs, rbd, out_keys, out_mask, n_dropped


def zwin_taps(start, pattern, n, kz=3):
    """Per (site, BEV offset, dz): the input row of tap dz, or -1.

    Candidate j of a window is the j-th active voxel at z >= z0, so tap dz
    reads row ``start + popcount(pattern bits below dz)`` when bit dz is
    set; rows >= n read as zero (the JAX wrapper's padded zero rows).
    Returns (B, Q, kz) int64.
    """
    rows = []
    for dz in range(kz):
        below = pattern & ((1 << dz) - 1)
        j = sum((below >> i) & 1 for i in range(dz)) if dz else 0
        r = start.to(torch.int64) + j
        on = ((pattern >> dz) & 1).bool() & (r < n)
        rows.append(torch.where(on, r, -1))
    return torch.stack(rows, dim=-1)


def conv_zwin_apply(feats, start, pattern, weight, kernel,
                    compute_dtype=torch.float32):
    """Plain PyTorch z-window conv: the CUDA kernel's reference.

    feats (B, N, C); (start, pattern) from ``zwin_rulebook``; weight the
    shared (K*Cin, Cout) layout, K = (dz*ky+dy)*kx + dx. Returns
    (B, M, Cout) float32. Inputs are rounded to ``compute_dtype`` and the
    products summed in float32 (the JAX code's
    ``preferred_element_type=f32``).
    """
    b, n, c = feats.shape
    kz, ky, kx = kernel
    k2 = ky * kx
    m = start.shape[1] // k2
    cout = weight.shape[1]
    rows = zwin_taps(start, pattern, n, kz)                   # (B, M*K2, kz)
    fz = torch.cat([feats.to(compute_dtype).float(),
                    feats.new_zeros((b, 1, c), dtype=torch.float32)], dim=1)
    idx = torch.where(rows >= 0, rows, n).reshape(b, -1)
    g = torch.gather(fz, 1, idx[..., None].expand(b, idx.shape[1], c))
    # (B, M, K2, kz, C) -> tap order (dz, j2) of the shared weight layout
    g = g.reshape(b, m, k2, kz, c).transpose(2, 3).reshape(b * m, kz * k2 * c)
    w = weight.to(compute_dtype).float()
    return (g @ w).reshape(b, m, cout)


# ---------------------------------------------------------------------------
# Training path: full per-tap rulebooks and convs whose backward is another
# rulebook conv (vision3d_tpu/ops/sparse.py:1589-1805).
#
#   forward:  out[o] = sum_d X[rb(o, d)] @ W_d
#   dX[i]    = sum_d g[rbt(i, d)] @ W_{K-1-d}^T   (rbt: transpose rulebook,
#              taps reversed; for a submanifold conv rbt == rb)
#   dW_d     = sum_o X[rb(o, d)]^T @ g[o]         (regather + one GEMM)
#
# The JAX plan has three lookup layouts (compact column records, a dense
# perfect-hash table, sorted search) with one output contract; keys are
# sorted, so one ``torch.searchsorted`` serves here.
# ---------------------------------------------------------------------------


def kernel_offsets(kernel):
    """Static (K, 3) offsets, tap K = (dz*ky + dy)*kx + dx."""
    kz, ky, kx = kernel
    return np.stack(np.meshgrid(np.arange(kz), np.arange(ky), np.arange(kx),
                                indexing="ij"), axis=-1).reshape(-1, 3)


def lookup_rows(keys, queries, miss):
    """Row of each query key in the per-sample sorted ``keys`` (B, N), or
    ``miss`` where it is absent. queries (B, Q), sentinel = invalid (padding
    rows of ``keys`` hold the sentinel too, so invalid queries are sent to
    ``miss`` explicitly). Returns (B, Q) int32."""
    n = keys.shape[1]
    pos = torch.searchsorted(keys, queries.contiguous())
    hit = torch.gather(keys, 1, pos.clamp(max=n - 1)) == queries
    return torch.where(hit & (pos < n), pos, miss).to(torch.int32)


def rulebook(keys, mask, grid, out_keys, out_mask, out_grid, kernel,
             stride=(1, 1, 1), pad=(0, 0, 0)):
    """Full-tap rulebook (B, M*K) int32: per (output site, tap) the input
    row at ``o*stride - pad + d``, or N for a miss (out of the grid,
    inactive, padded site). Contract of ``rulebook_compact`` /
    ``build_rulebook_batched`` (vision3d_tpu/ops/sparse.py:1186, :365)."""
    b, n = keys.shape
    d, h, w = grid
    dev = keys.device
    coords = keys_to_coords(torch.where(out_mask, out_keys, 0), out_grid)
    with annotate("sync"):
        offs = torch.tensor(kernel_offsets(kernel), dtype=torch.int32, device=dev)
        stride_t = torch.tensor(stride, dtype=torch.int32, device=dev)
        pad_t = torch.tensor(pad, dtype=torch.int32, device=dev)
        dims = torch.tensor(grid, dtype=torch.int32, device=dev)
    nbr = coords[:, :, None, :] * stride_t - pad_t + offs          # (B, M, K, 3)
    ok = ((nbr >= 0) & (nbr < dims)).all(-1) & out_mask[:, :, None]
    nkey = (nbr[..., 1] * w + nbr[..., 2]) * d + nbr[..., 0]
    sent = sentinel_key(grid)
    rows = lookup_rows(keys, torch.where(ok, nkey, sent).reshape(b, -1), n)
    return torch.where(ok.reshape(b, -1), rows, n)


def transpose_rulebook_batched(in_keys, in_mask, in_grid, out_keys, out_mask,
                               out_grid, kernel, stride, pad):
    """Transpose rulebook of a strided conv, the K taps in REVERSED order:
    entry (i, K-1-d) is the row (in the OUT arrays) of the output site
    o = (i + p - d)/s that reads input i at kernel offset d, or the miss
    row M when s does not divide, o is out of range or o is inactive
    (vision3d_tpu/ops/sparse.py:1722). Returns (B, N*K) int32."""
    b, n = in_keys.shape
    m = out_keys.shape[1]
    dev = in_keys.device
    coords = keys_to_coords(torch.where(in_mask, in_keys, 0), in_grid)
    with annotate("sync"):
        offs = torch.tensor(kernel_offsets(kernel), dtype=torch.int32, device=dev)
        stride_t = torch.tensor(stride, dtype=torch.int32, device=dev)
        pad_t = torch.tensor(pad, dtype=torch.int32, device=dev)
        og = torch.tensor(out_grid, dtype=torch.int32, device=dev)
    t = coords[:, :, None, :] + pad_t - offs                  # (B, N, K, 3)
    o = torch.div(t, stride_t, rounding_mode="floor")
    ok = ((t % stride_t == 0).all(-1) & (o >= 0).all(-1) & (o < og).all(-1)
          & in_mask[:, :, None])
    okey = (o[..., 1] * out_grid[2] + o[..., 2]) * out_grid[0] + o[..., 0]
    sent = sentinel_key(out_grid)
    rows = lookup_rows(out_keys, torch.where(ok, okey, sent).reshape(b, -1), m)
    rbt = torch.where(ok.reshape(b, -1), rows, m).reshape(b, n, -1)
    return rbt.flip(-1).reshape(b, -1).contiguous()


def plan_stage_train_batched(keys, mask, grid, down_kernel, down_stride,
                             down_pad, out_cap, subm_kernel=None):
    """Training-path stage plan: full-tap rulebooks plus the down conv's
    transpose rulebook, so that every backward is a rulebook conv
    (vision3d_tpu/ops/sparse.py:1756).

    Returns (rb_subm or None, rb_down, rbt_down, out_keys, out_mask,
    n_dropped)."""
    out_grid = out_grid_shape(grid, down_kernel, down_stride, down_pad)
    out_keys, out_mask, n_dropped = downsample_active_set(
        keys, mask, grid, down_kernel, down_stride, down_pad, out_cap)
    rbs = None
    if subm_kernel is not None:
        pad_s = tuple(s // 2 for s in subm_kernel)
        rbs = rulebook(keys, mask, grid, keys, mask, grid, subm_kernel,
                       (1, 1, 1), pad_s)
    rbd = rulebook(keys, mask, grid, out_keys, out_mask, out_grid,
                   down_kernel, down_stride, down_pad)
    rbt = transpose_rulebook_batched(keys, mask, grid, out_keys, out_mask,
                                     out_grid, down_kernel, down_stride,
                                     down_pad)
    return rbs, rbd, rbt, out_keys, out_mask, n_dropped


def zero_row_table(feats, rb_idx, compute_dtype):
    """The flat gather form of a batched rulebook: feats (B, N, C) with a
    zero row appended per sample, rounded to ``compute_dtype`` and
    flattened to (B*(N+1), C), and rb_idx (B, Q) offset into it (Q*B,)."""
    b, n, c = feats.shape
    table = torch.cat([feats, feats.new_zeros((b, 1, c))], dim=1).to(compute_dtype)
    base = torch.arange(b, dtype=torch.int32, device=feats.device)[:, None] * (n + 1)
    return table.reshape(b * (n + 1), c), (rb_idx + base).reshape(-1)


def conv_rulebook_apply(feats, rb_idx, weight, compute_dtype=torch.float32):
    """Plain PyTorch rulebook conv, the ``gather_gemm`` kernel's reference
    (vision3d_tpu/ops/sparse.py:1589): one flat gather + one GEMM.

    feats (B, N, C); rb_idx (B, M*K) int32 with misses = N; weight
    (K*C, Cout). Returns (B, M, Cout) float32. Inputs are rounded to
    ``compute_dtype`` and the products summed in float32."""
    b, n, c = feats.shape
    k = weight.shape[0] // c
    m = rb_idx.shape[1] // k
    table, flat = zero_row_table(feats, rb_idx, compute_dtype)
    cols = table.float()[flat.long()].reshape(b * m, k * c)
    return (cols @ weight.to(compute_dtype).float()).reshape(b, m, -1)


def flip_transpose_weight(weight, c_in):
    """(K*Cin, Cout) -> (K*Cout, Cin) with W'[d] = W[K-1-d]^T."""
    cout = weight.shape[1]
    k = weight.shape[0] // c_in
    w3 = weight.reshape(k, c_in, cout).flip(0)
    return w3.transpose(1, 2).reshape(k * cout, c_in)


def _kernel_wrappers():
    # imported here: both modules import this one for their plain versions
    from vision3d_tpu_torch.ops.gather_gemm import gather_gemm
    from vision3d_tpu_torch.ops.gather_rows import gather_rows
    return gather_gemm, gather_rows


def matmul_f32(a_t, b):
    """``a_t.T @ b`` summed and returned in float32, whatever the inputs'
    dtype (the JAX code's ``preferred_element_type=f32``). A library GEMM:
    the JAX package computes this product outside any Pallas kernel."""
    if a_t.dtype == torch.float32:
        return a_t.T @ b
    if a_t.device.type == "cuda":
        return torch.mm(a_t.T, b, out_dtype=torch.float32)
    return a_t.float().T @ b.float()


def conv_rb_dw(feats, rb_idx, g, compute_dtype):
    """dW = cols^T @ g: the forward's columns regathered (``gather_rows``)
    instead of kept, then one GEMM (vision3d_tpu/ops/sparse.py:1650).
    Un-chunked: ``cols`` is the whole (B*M, K*C) matrix in the compute
    dtype. Returns (K*C, Cout) float32."""
    _, gather_rows = _kernel_wrappers()
    bm = g.shape[0] * g.shape[1]
    table, flat = zero_row_table(feats, rb_idx, compute_dtype)
    cols = gather_rows(table, flat).reshape(bm, -1)
    return matmul_f32(cols, g.reshape(bm, -1).to(compute_dtype))


def _conv_backward(ctx, g, rb_dx):
    """(dX, dW) of a rulebook conv whose context saved (feats, rb, ...,
    weight); ``rb_dx`` is the rulebook dX runs over."""
    gather_gemm, _ = _kernel_wrappers()
    feats, rb_idx, *_, weight = ctx.saved_tensors
    cdt = ctx.compute_dtype
    g = g.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
        wt = flip_transpose_weight(weight, feats.shape[2])
        dx = gather_gemm(g.to(cdt), rb_dx, wt, cdt).to(feats.dtype)
    if ctx.needs_input_grad[-2]:
        dw = conv_rb_dw(feats, rb_idx, g, cdt).to(weight.dtype)
    return dx, dw


class SubmConvFn(torch.autograd.Function):
    """Submanifold rulebook conv f(feats, rb, weight, compute_dtype) ->
    (B, N, Cout) float32 with the conv-as-backward of
    ``make_subm_conv_vjp`` (vision3d_tpu/ops/sparse.py:1664): the offset
    grid is symmetric and in == out sites, so dX is the SAME rulebook
    with tap-flipped, transposed weights. No gradient to the rulebook."""

    @staticmethod
    def forward(ctx, feats, rb_idx, weight, compute_dtype):
        gather_gemm, _ = _kernel_wrappers()
        ctx.save_for_backward(feats, rb_idx, weight)
        ctx.compute_dtype = compute_dtype
        return gather_gemm(feats, rb_idx, weight, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        dx, dw = _conv_backward(ctx, g, ctx.saved_tensors[1])
        return dx, None, dw, None


class DownConvFn(torch.autograd.Function):
    """Strided rulebook conv f(feats, rb, rbt, weight, compute_dtype) ->
    (B, M, Cout) float32; dX runs over the transpose rulebook ``rbt``
    (``make_down_conv_vjp``, vision3d_tpu/ops/sparse.py:1692)."""

    @staticmethod
    def forward(ctx, feats, rb_idx, rbt_idx, weight, compute_dtype):
        gather_gemm, _ = _kernel_wrappers()
        ctx.save_for_backward(feats, rb_idx, rbt_idx, weight)
        ctx.compute_dtype = compute_dtype
        return gather_gemm(feats, rb_idx, weight, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        dx, dw = _conv_backward(ctx, g, ctx.saved_tensors[2])
        return dx, None, None, dw, None


class DensifyFn(torch.autograd.Function):
    """All-cells row gather f(table, idx, self_pos, live) -> (Q, C): output
    row q is ``table[idx[q]]``, with the gather-as-backward of
    ``densify_gather`` (vision3d_tpu/ops/sparse.py:1808): every live table
    row is read by exactly one output row, its own cell ``self_pos``, so
    its gradient is one gather of the output gradient there (zero at rows
    that are not ``live``), not a cells-sized scatter-add. Both directions
    run on the ``gather_rows`` kernel.

    table (R, C) float32 or bfloat16; idx (Q,) int32 in [0, R); self_pos
    (R,) int32 in [0, Q) (any value at rows that are not live); live (R,)
    bool. No gradient to the indices."""

    @staticmethod
    def forward(ctx, table, idx, self_pos, live):
        _, gather_rows = _kernel_wrappers()
        ctx.save_for_backward(self_pos, live)
        return gather_rows(table, idx)

    @staticmethod
    def backward(ctx, g):
        _, gather_rows = _kernel_wrappers()
        self_pos, live = ctx.saved_tensors
        pos = torch.where(live, self_pos, 0).contiguous()
        dt = torch.where(live[:, None], gather_rows(g.contiguous(), pos), 0.0)
        return dt, None, None, None


def to_dense(feats, keys, mask, grid):
    """Scatter a batched sparse tensor to a dense (B, D, H, W, C) volume
    (``to_dense``, vision3d_tpu/ops/sparse.py:193). Active keys are
    unique, so the scatter's autograd backward is a plain gather."""
    d, h, w = grid
    b, n, c = feats.shape
    cells = h * w * d
    base = torch.arange(b, device=feats.device)[:, None] * (cells + 1)
    idx = (torch.where(mask, keys, cells) + base).reshape(-1)
    dense = feats.new_zeros((b * (cells + 1), c))
    dense = dense.index_put((idx,), torch.where(mask[..., None], feats, 0.0)
                            .reshape(-1, c))
    dense = dense.reshape(b, cells + 1, c)[:, :cells]
    return dense.reshape(b, h, w, d, c).permute(0, 3, 1, 2, 4)
