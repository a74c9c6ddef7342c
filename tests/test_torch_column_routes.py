"""The column conv's two routes, on the CPU.

On the card, ``column_conv`` picks its kernel with the rule of the rulebook
gather-GEMM (``ops.gather_gemm.route_of``). Its tensor-core route marks
per input row the z whose slice holds a non-zero value, keeps the (column,
zo) output sites that some tap reaches with such a slice, and gives each
kept site a rulebook of kz*K2 taps, k = dz*K2 + k2, into the flat
(B*N*D, C) table of z-slices; the other output rows are exact zeros. The
helper ``mma_plan`` below builds the same in plain PyTorch, so these tests
hold that step (tap order, ``pad_z`` / ``stride_z`` bounds, misses, the
zero-slice skip) against the plain column conv and against the TPU kernel
B3 (``column_conv_pallas``, interpret mode, as its own tests run it). The
kernel itself is held against the plain version in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision3d_tpu.ops.pallas.column_conv import column_conv_pallas
from vision3d_tpu_torch.ops import column_sparse as tcsp
from vision3d_tpu_torch.ops.gather_gemm import route_of

# (C, Cout, D, kernel, stride_z, pad_z) of every column conv of the path
# (tests/test_torch_cuda.py::test_column_conv_kernel_matches_plain)
PATH_SHAPES = [
    (4, 16, 41, (3, 3, 3), 1, 1), (16, 16, 41, (3, 3, 3), 1, 1),
    (16, 32, 41, (3, 3, 3), 2, 1), (32, 32, 21, (3, 3, 3), 1, 1),
    (32, 64, 21, (3, 3, 3), 2, 1), (64, 64, 11, (3, 3, 3), 1, 1),
    (64, 64, 11, (3, 3, 3), 2, 0), (64, 64, 5, (3, 3, 3), 1, 1),
    (64, 64, 5, (3, 1, 1), 2, 0), (32, 32, 21, (3, 3, 3), 2, 0)]


def row_masks(col_feats, d, c):
    """(B, N, D) bool: the z-slices of each input row that hold a non-zero
    value (the "mma" route's 64-bit row masks, bit z)."""
    b, n, _ = col_feats.shape
    return (col_feats.reshape(b, n, d, c) != 0).any(-1)


def mma_plan(col_feats, rb, kernel, d, c, stride_z, pad_z, swap=False):
    """What the "mma" route builds: per active (column, zo) site, in
    (b, m, zo) order, its output row (b*M + m)*D_out + zo and the flat
    table row (b*N + row)*D + z that tap k = dz*K2 + k2 reads (-1: a miss,
    a z outside [0, D) or an all-zero slice). ``swap`` lays the taps out
    as k2*kz + dz instead. Returns (out_rows (S,), grow (S, K))."""
    b, n, _ = col_feats.shape
    kz, ky, kx = kernel
    k2 = ky * kx
    m = rb.shape[1] // k2
    d_out = tcsp.conv_out_depth(d, kz, stride_z, pad_z)
    nz = torch.cat([row_masks(col_feats, d, c),
                    torch.zeros((b, 1, d), dtype=torch.bool)], dim=1)  # miss row N
    rows = torch.where((rb >= 0) & (rb < n), rb, n).long().reshape(b, m, k2)
    hit = torch.stack([nz[i][rows[i]] for i in range(b)])              # (B, M, K2, D)
    z = (torch.arange(d_out)[:, None] * stride_z - pad_z
         + torch.arange(kz)[None])                                     # (D_out, kz)
    inside = (z >= 0) & (z < d)
    zc = z.clamp(0, d - 1)
    taps = hit[:, :, :, zc] & inside                                   # (B, M, K2, D_out, kz)
    taps = taps.permute(0, 1, 3, 4, 2)                                 # (B, M, D_out, kz, K2)
    flat = ((torch.arange(b)[:, None, None] * n + rows) * d)[:, :, None, None, :] \
        + zc[None, None, :, :, None]                                   # (B, M, D_out, kz, K2)
    grow = torch.where(taps, flat, -1)
    if swap:
        grow = grow.transpose(3, 4)
    grow = grow.reshape(b, m, d_out, kz * k2)
    active = (grow >= 0).any(-1)
    site = active.nonzero()
    out_rows = (site[:, 0] * m + site[:, 1]) * d_out + site[:, 2]
    return out_rows, grow[active]


def plan_apply(col_feats, rb, weight, kernel, d, c, stride_z, pad_z, dtype,
               swap=False):
    """The route's product on its plan, in float64: per site the sum over
    hit taps of table[grow] @ W[k*C : (k+1)*C], scattered to its output
    row; every other row 0. Returns (out (B, M, D_out*Cout), sites)."""
    b, n, _ = col_feats.shape
    m = rb.shape[1] // (kernel[1] * kernel[2])
    cout = weight.shape[1]
    d_out = tcsp.conv_out_depth(d, kernel[0], stride_z, pad_z)
    x = col_feats.to(dtype)
    out_rows, grow = mma_plan(x, rb, kernel, d, c, stride_z, pad_z, swap)
    table = torch.cat([x.double().reshape(b * n * d, c),
                       torch.zeros((1, c), dtype=torch.float64)])
    g = table[torch.where(grow < 0, b * n * d, grow)]                  # (S, K, C)
    w = weight.to(dtype).double()
    out = torch.zeros((b * m * d_out, cout), dtype=torch.float64)
    out[out_rows] = g.reshape(len(grow), -1) @ w
    return out.reshape(b, m, d_out * cout), len(out_rows)


def _case(c, cout, d, kernel, seed, b=2, n=30, m=37):
    """A column rulebook as the card tests draw it: rows in [0, N], N (a
    miss) for about a third, one all-miss column (frame 1, column 7);
    values at about a quarter of the (row, z) slices, some slices holding
    -0.0 only (zero, so skipped)."""
    rng = np.random.default_rng(seed)
    k2 = kernel[1] * kernel[2]
    cf = rng.normal(size=(b, n, d, c)).astype(np.float32)
    cf *= rng.uniform(size=(b, n, d, 1)) < 0.25
    cf[0, 3, :4] = -0.0
    rb = rng.integers(0, n + 1, (b, m * k2)).astype(np.int32)
    rb[rng.uniform(size=rb.shape) < 0.3] = n
    rb[1, 7 * k2: 8 * k2] = n
    w = rng.normal(size=(kernel[0] * k2 * c, cout)).astype(np.float32)
    return [torch.from_numpy(a) for a in (cf.reshape(b, n, d * c), rb, w)]


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, {"mma": 9, "fma": 1}),
                                        (torch.float32, {"mma": 0, "fma": 10})])
def test_route_rule_on_the_path(dtype, want):
    """bf16 takes the tensor cores at every column shape but s0 subm 4x16
    (5 of the 6 launches of a forward, 13 of 14 at dense_from_stage 4);
    float32, the card-vs-CPU checks, takes FMA everywhere."""
    routes = [route_of(dtype, c, cout) for c, cout, *_ in PATH_SHAPES]
    assert {r: routes.count(r) for r in ("mma", "fma")} == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,cout,d,kernel,sz,pz", PATH_SHAPES)
def test_mma_plan_equals_column_conv(c, cout, d, kernel, sz, pz, dtype):
    """The plan's product equals the plain column conv at every shape of
    the path: the same exact products of compute-dtype inputs, summed in
    float64 against float32, 1e-5 of the scale. Inactive sites, the
    all-miss column among them, are exactly zero in both, and the active
    sites are those of ``column_occupancy_batched`` on the non-zero
    slices."""
    cf, rb, w = _case(c, cout, d, kernel, c + cout + d + sz)
    got, sites = plan_apply(cf, rb, w, kernel, d, c, sz, pz, dtype)
    ref = tcsp.column_conv_dz(cf, rb, w, kernel, d, c, sz, pz, dtype)
    scale = float(ref.abs().max())
    assert scale > 0
    torch.testing.assert_close(got.float(), ref, atol=1e-5 * scale, rtol=1e-5)
    assert not got[1, 7].any() and not ref[1, 7].any()
    occ = tcsp.column_occupancy_batched(row_masks(cf.to(dtype), d, c), rb, kernel,
                                        sz, pz)
    assert sites == int(occ.sum()) > 0
    zero = ~occ.repeat_interleave(w.shape[1], dim=-1)
    assert not ref[zero].any()


def test_mma_plan_tap_order_matters():
    """The taps laid out k2*kz + dz (the FMA kernel's bit order) against
    the weight's dz*K2 + k2 give another result, so the test above pins the
    order."""
    args = (32, 32, 21, (3, 3, 3), 1, 1)
    cf, rb, w = _case(*args[:4], 5)
    ref = tcsp.column_conv_dz(cf, rb, w, args[3], args[2], args[0], *args[4:])
    got, _ = plan_apply(cf, rb, w, args[3], args[2], args[0], *args[4:],
                        torch.float32, swap=True)
    assert float((got.float() - ref).abs().max()) > 0.1 * float(ref.abs().max())


@pytest.mark.parametrize("kernel,sz,pz", [((3, 3, 3), 1, 1), ((3, 1, 1), 2, 0)])
def test_mma_plan_matches_pallas_kernel(kernel, sz, pz):
    """The plan's product, bf16 as on the tensor cores, against the TPU
    kernel B3 itself (interpret mode): the tolerance of
    tests/test_torch_column.py, 2e-2 of the scale."""
    c, cout, d = 32, 32, 11
    cf, rb, w = _case(c, cout, d, kernel, 9, n=40, m=45)
    ref = np.asarray(column_conv_pallas(
        jnp.asarray(cf.numpy(), jnp.bfloat16), jnp.asarray(rb.numpy()),
        jnp.asarray(w.numpy()), kernel, d, c, sz, pz, block_cols=128))
    got, _ = plan_apply(cf, rb, w, kernel, d, c, sz, pz, torch.bfloat16)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2 * scale, rtol=2e-2)
