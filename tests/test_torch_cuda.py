"""The port's CUDA kernels (zwin_conv, gather_gemm, gather_rows,
column_conv, zwin_align_v1, zwin_align_v3, ball_query, voxel_query, fps,
bn_relu) against their plain PyTorch versions, on the card, also inside
the training autograd functions (SubmConvFn / DownConvFn, ColumnConvFn,
DensifyFn), the column scales' conversions' backward, PV-RCNN's
inference and training on both backends on the card against the CPU, and
two ranks on one card against one process. Every test here needs a CUDA
device and skips without one. This file imports nothing of JAX, so it
also runs on a GPU host without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from vision3d_tpu_torch.ops import column_conv as tcc
from vision3d_tpu_torch.ops import column_sparse as tcsp
from vision3d_tpu_torch.ops import fps as tfps
from vision3d_tpu_torch.ops import sparse as tsp
from vision3d_tpu_torch.ops import zwin_conv as tzw
from vision3d_tpu_torch.ops.column_conv import column_conv
from vision3d_tpu_torch.ops.gather_gemm import gather_gemm, route_of
from vision3d_tpu_torch.ops.gather_rows import gather_rows, gather_rows_plain

pytestmark = pytest.mark.cuda
COUT = {4: 16, 16: 32, 32: 64}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(c, seed, dev, b=2, n=300, m=1000, cout=None):
    """Random rulebook as in tests/test_pallas_kernels.py: starts in
    [0, N], so windows reach the zero rows past N."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, n, c)).astype(np.float32)
    start = rng.integers(0, n + 1, (b, m * 9)).astype(np.int32)
    pattern = np.where(start == n, 0, rng.integers(0, 8, (b, m * 9))).astype(np.int32)
    w = rng.normal(size=(27 * c, cout or COUT[c])).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (feats, start, pattern, w)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [4, 16, 32])
def test_zwin_kernel_matches_plain(c, dtype, cuda_device):
    """Both sum exact products of compute-dtype inputs in float32, in
    different orders: 1e-5 of the output scale."""
    feats, start, pattern, w = _case(c, 3, cuda_device)
    before = tzw.LAUNCHES["zwin_conv"]
    got = tzw.zwin_conv(feats, start, pattern, w, (3, 3, 3), dtype)
    torch.cuda.synchronize()
    assert tzw.LAUNCHES["zwin_conv"] == before + 1
    ref = tsp.conv_zwin_apply(feats, start, pattern, w, (3, 3, 3), dtype)
    scale = float(ref.abs().max())
    torch.testing.assert_close(got, ref, atol=1e-5 * scale, rtol=1e-5)


def test_zwin_kernel_rejects_bad_input(cuda_device):
    feats, start, pattern, w = _case(16, 4, cuda_device)
    with pytest.raises(TypeError):
        tzw.zwin_conv(feats, start.long(), pattern, w)
    with pytest.raises(ValueError):
        tzw.zwin_conv(feats, start, pattern, w[:-1])
    with pytest.raises(ValueError):
        tzw.zwin_conv(feats.transpose(1, 2).contiguous().transpose(1, 2),
                      start, pattern, w)
    with pytest.raises(ValueError):
        tzw.zwin_conv(feats, start, pattern, w, (3, 3, 3), torch.bfloat16, route="wgmma")


def _zw_counts():
    return [tzw.LAUNCHES[k] for k in ("zwin_conv", "zwin_conv.fma", "zwin_conv.mma")]


def _zw_check(feats, start, pattern, w, dtype, route=None):
    """One launch against the plain version, 1e-5 of the output scale,
    counted once in all and once on its route."""
    route_used = route or route_of(dtype, feats.shape[2], w.shape[1])
    before = _zw_counts()
    got = tzw.zwin_conv(feats, start, pattern, w, (3, 3, 3), dtype, route=route)
    torch.cuda.synchronize()
    after = _zw_counts()
    assert after[0] == before[0] + 1
    assert after[1:] == [before[1] + (route_used == "fma"), before[2] + (route_used == "mma")]
    ref = tsp.conv_zwin_apply(feats, start, pattern, w, (3, 3, 3), dtype)
    assert float(ref.abs().max()) > 0
    torch.testing.assert_close(got, ref, atol=1e-5 * float(ref.abs().max()), rtol=1e-5)
    return got


@pytest.mark.parametrize("cout", [16, 32, 64, 128])
@pytest.mark.parametrize("c", [16, 32, 64])
def test_zwin_mma_route_matches_plain(c, cout, cuda_device):
    """The tensor-core route (bf16, rulebook built per tile from (start,
    pattern)) at every C x Cout it takes on the path and beyond: 1e-5 of
    the output scale, counted on "mma". B*M = 2000 is no multiple of the
    64-site tile, and the tile of sites 960-1023 spans the two frames."""
    assert route_of(torch.bfloat16, c, cout) == "mma"
    _zw_check(*_case(c, c + cout, cuda_device, cout=cout), torch.bfloat16)


@pytest.mark.parametrize("c,cout", [(16, 32), (32, 64)])
def test_zwin_fma_route_forced_and_float32(c, cout, cuda_device):
    """The FMA kernel forced in bf16 agrees with the plain version and is
    counted on "fma"; float32 takes "fma" by default, bit for bit the
    forced call; "mma" refuses float32 and C = 4, launching nothing."""
    feats, start, pattern, w = _case(c, 21, cuda_device, cout=cout)
    _zw_check(feats, start, pattern, w, torch.bfloat16, route="fma")
    got = _zw_check(feats, start, pattern, w, torch.float32)
    forced = tzw.zwin_conv(feats, start, pattern, w, (3, 3, 3), torch.float32, route="fma")
    torch.cuda.synchronize()
    assert torch.equal(got, forced)
    before = _zw_counts()
    with pytest.raises(ValueError):
        tzw.zwin_conv(feats, start, pattern, w, (3, 3, 3), torch.float32, route="mma")
    with pytest.raises(ValueError):
        tzw.zwin_conv(feats[..., :4].contiguous(), start, pattern, w[: 27 * 4],
                      (3, 3, 3), torch.bfloat16, route="mma")
    assert _zw_counts() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zwin_kernel_runs_the_311_conv(dtype, cuda_device):
    """The (3, 1, 1) strided conv of the all-sparse stage 3 (64 -> 128),
    embedded in the (3, 3, 3) kernel (``embed_333``): one launch, against
    the plain (3, 1, 1) conv at 1e-5 of the output scale."""
    rng = np.random.default_rng(31)
    b, n, m, c, cout = 2, 3000, 2500, 64, 128
    feats = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).to(cuda_device)
    start = rng.integers(0, n + 1, (b, m)).astype(np.int32)
    pattern = np.where(start == n, 0, rng.integers(0, 8, (b, m))).astype(np.int32)
    start, pattern = (torch.from_numpy(a).to(cuda_device) for a in (start, pattern))
    w = torch.from_numpy(rng.normal(size=(3 * c, cout)).astype(np.float32)).to(cuda_device)
    before = tzw.LAUNCHES["zwin_conv"]
    got = tzw.zwin_conv(feats, start, pattern, w, (3, 1, 1), dtype)
    torch.cuda.synchronize()
    assert tzw.LAUNCHES["zwin_conv"] == before + 1 and got.shape == (b, m, cout)
    ref = tsp.conv_zwin_apply(feats, start, pattern, w, (3, 1, 1), dtype)
    torch.testing.assert_close(got, ref, atol=1e-5 * float(ref.abs().max()), rtol=1e-5)


def test_zwin_mma_sparse_tiles_and_past_n(cuda_device):
    """Tiles whose taps are extreme: sites 128-255 of frame 0 (two whole
    tiles) have empty windows and come out exactly zero; site 300 has one
    tap only; in frame 1 every window starts at N - 1 with all three bits
    set, so tap dz = 0 reads row N - 1 and taps 1 and 2 reach past N:
    misses that must read nothing."""
    feats, start, pattern, w = _case(32, 7, cuda_device, n=200, m=410)
    n = feats.shape[1]
    st = start.reshape(2, 410, 9).clone()
    pt = pattern.reshape(2, 410, 9).clone()
    pt[0, 128:256] = 0
    pt[0, 300] = 0
    pt[0, 300, 4], st[0, 300, 4] = 0b100, 17
    st[1] = n - 1
    pt[1] = 0b111
    got = _zw_check(feats, st.reshape(2, -1).contiguous(), pt.reshape(2, -1).contiguous(),
                    w, torch.bfloat16)
    assert not got[0, 128:256].any()
    assert got[0, 300].any()


def test_zwin_mma_unaligned_bf16_view(cuda_device):
    """A bf16 ``feats`` view off 16-byte alignment (what ``cp.async``
    needs) is copied by the wrapper, not read askew: bit for bit the
    aligned input's result."""
    feats, start, pattern, w = _case(32, 13, cuda_device, cout=32)
    x = feats.bfloat16()
    odd = torch.cat([x.new_zeros((1,)), x.reshape(-1)])[1:].reshape(x.shape)
    assert odd.data_ptr() % 16 != 0 and odd.is_contiguous()
    ref = tzw.zwin_conv(x, start, pattern, w, (3, 3, 3), torch.bfloat16)
    got = tzw.zwin_conv(odd, start, pattern, w, (3, 3, 3), torch.bfloat16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


def _gg_case(c, cout, kd, seed, dev, b=2, n=300, m=700):
    """Random full-tap rulebook: rows in [0, N], N (a miss) most often."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, n, c)).astype(np.float32)
    rb = rng.integers(0, n + 1, (b, m * kd)).astype(np.int32)
    rb[rng.uniform(size=rb.shape) < 0.6] = n
    w = (rng.normal(size=(kd * c, cout)) / np.sqrt(kd * c)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (feats, rb, w)]


def _gg_counts():
    return [tzw.LAUNCHES[k] for k in ("gather_gemm", "gather_gemm.fma", "gather_gemm.mma")]


def _gg_check(feats, rb, w, dtype, route=None):
    """One launch against the plain version, 1e-5 of the output scale,
    counted once in all and once on its route."""
    route_used = route or route_of(dtype, feats.shape[2], w.shape[1])
    before = _gg_counts()
    got = gather_gemm(feats, rb, w, dtype, route=route)
    torch.cuda.synchronize()
    after = _gg_counts()
    assert after[0] == before[0] + 1
    assert after[1:] == [before[1] + (route_used == "fma"), before[2] + (route_used == "mma")]
    ref = tsp.conv_rulebook_apply(feats, rb, w, dtype)
    torch.testing.assert_close(got, ref, atol=1e-5 * float(ref.abs().max()), rtol=1e-5)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,cout,kd", [(4, 16, 27), (16, 16, 27), (16, 32, 27),
                                       (32, 16, 27), (32, 32, 27), (32, 64, 27),
                                       (64, 32, 27), (64, 64, 27), (64, 64, 3),
                                       (64, 128, 27), (128, 64, 27), (16, 4, 27),
                                       (16, 8, 27), (80, 16, 3)])
def test_gather_gemm_kernel_matches_plain(c, cout, kd, dtype, cuda_device):
    """Every forward and dX width of the training path (K = 27 and 3), 64x128
    and 128x64, Cout 8 and a C of two channel chunks (80), on the route the
    rule picks: in bf16 the tensor-core route for all but C = 4 and Cout = 4.
    Both sum exact products of compute-dtype inputs in float32, in other
    orders: 1e-5 of the output scale. B*M = 1400 is no multiple of the
    64-site tile, and the tile of sites 640-703 spans the two frames."""
    feats, rb, w = _gg_case(c, cout, kd, c + cout, cuda_device)
    _gg_check(feats, rb, w, dtype)


@pytest.mark.parametrize("c,cout", [(16, 32), (64, 64)])
def test_gather_gemm_fma_route_in_bf16(c, cout, cuda_device):
    """The float32-FMA design, forced in bf16 where the rule picks the
    tensor cores, agrees with the plain version and is counted on its own
    route; the tensor-core route refuses float32 and C = 4."""
    feats, rb, w = _gg_case(c, cout, 27, 11, cuda_device)
    _gg_check(feats, rb, w, torch.bfloat16, route="fma")
    before = _gg_counts()
    with pytest.raises(ValueError):
        gather_gemm(feats, rb, w, torch.float32, route="mma")
    with pytest.raises(ValueError):
        gather_gemm(feats[..., :4].contiguous(), rb, w[: 27 * 4], torch.bfloat16,
                    route="mma")
    assert _gg_counts() == before


def test_gather_gemm_sparse_tiles(cuda_device):
    """Tiles of 64 sites whose tap lists are extreme: sites 128-255 (two
    whole tiles) miss every tap and come out exactly zero; in the tile of
    sites 256-319 tap 5 is hit by one site only and every other tap by
    none; frame 1 has hits in its first 3 sites only, in the tile of sites
    384-447 that also holds the end of frame 0 (M = 410)."""
    rng = np.random.default_rng(5)
    b, n, m, c, cout, kd = 2, 50, 410, 32, 64, 27
    feats = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy((rng.normal(size=(kd * c, cout)) / 30).astype(np.float32)).to(
        cuda_device)
    rb = rng.integers(0, n + 1, (b, m, kd)).astype(np.int32)
    rb[0, 128:384] = n
    rb[0, 300, 5] = 17
    rb[1, 3:] = n
    rb = torch.from_numpy(rb.reshape(b, m * kd)).to(cuda_device)
    for dtype in (torch.bfloat16, torch.float32):
        got = _gg_check(feats, rb, w, dtype)
        assert not got[0, 128:300].any() and not got[0, 301:384].any()
        assert not got[1, 3:].any()
        assert got[0, 300].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_gemm_kernel_treats_out_of_range_rows_as_misses(dtype, cuda_device):
    """Negative rows and rows > N give bit for bit what rows = N give, on
    either route."""
    feats, rb, w = _gg_case(16, 32, 27, 9, cuda_device)
    n = feats.shape[1]
    ref = gather_gemm(feats, rb, w, dtype)
    wild = torch.where(rb == n, torch.full_like(rb, -1), rb)
    wild[0, ::7] = torch.where(wild[0, ::7] < 0, n + 5, wild[0, ::7])
    wild[1, ::5] = torch.where(wild[1, ::5] < 0, 2 ** 31 - 1, wild[1, ::5])
    wild[1, 1::5] = torch.where(wild[1, 1::5] < 0, -(2 ** 31), wild[1, 1::5])
    torch.testing.assert_close(gather_gemm(feats, wild, w, dtype), ref, atol=0, rtol=0)


def test_gather_gemm_unaligned_bf16_view(cuda_device):
    """A bf16 ``feats`` view whose storage offset is not 16-byte aligned
    (what ``cp.async`` needs) is copied by the wrapper, not read askew: the
    result equals the aligned input's bit for bit."""
    feats, rb, w = _gg_case(32, 32, 27, 13, cuda_device)
    x = feats.bfloat16()
    odd = torch.cat([x.new_zeros((1,)), x.reshape(-1)])[1:].reshape(x.shape)
    assert odd.data_ptr() % 16 != 0 and odd.is_contiguous()
    ref = gather_gemm(x, rb, w, torch.bfloat16)
    got = gather_gemm(odd, rb, w, torch.bfloat16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


def test_gather_gemm_kernel_rejects_bad_input(cuda_device):
    feats, rb, w = _gg_case(16, 32, 27, 4, cuda_device)
    with pytest.raises(TypeError):
        gather_gemm(feats, rb.long(), w)
    with pytest.raises(TypeError):
        gather_gemm(feats, rb, w, torch.float16)
    with pytest.raises(ValueError):
        gather_gemm(feats, rb, w[:-1])
    with pytest.raises(ValueError):
        gather_gemm(feats, rb, w[:, :24])          # Cout 24 has no instance
    with pytest.raises(ValueError):
        gather_gemm(feats, rb, w, torch.bfloat16, route="wgmma")
    with pytest.raises(ValueError):
        gather_gemm(feats, rb.cpu(), w)
    with pytest.raises(ValueError):
        gather_gemm(feats.transpose(1, 2).contiguous().transpose(1, 2), rb, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [4, 16, 32, 64, 5])
def test_gather_rows_kernel_matches_plain(c, dtype, cuda_device):
    """A copy: exactly equal, at every row width of the path (8 to 256
    bytes), an odd width, any Q, and from a base that is only row-aligned."""
    rng = np.random.default_rng(c)
    table = torch.from_numpy(rng.normal(size=(501, c)).astype(np.float32)).to(
        cuda_device).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 500, (10007,)).astype(np.int32)).to(cuda_device)
    before = tzw.LAUNCHES["gather_rows"]
    for tab in (table, table[1:]):
        got = gather_rows(tab, idx)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert torch.equal(got, gather_rows_plain(tab, idx))
        assert torch.equal(got, torch.index_select(tab, 0, idx))
    assert tzw.LAUNCHES["gather_rows"] == before + 2
    assert gather_rows(table, idx[:0]).shape == (0, c)


def test_gather_rows_kernel_rejects_bad_input(cuda_device):
    table = torch.zeros((10, 8), device=cuda_device)
    idx = torch.zeros((4,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        gather_rows(table, idx.long())
    with pytest.raises(TypeError):
        gather_rows(table.half(), idx)
    with pytest.raises(ValueError):
        gather_rows(table.T, idx)
    with pytest.raises(ValueError):
        gather_rows(table, idx.cpu())
    with pytest.raises(ValueError):
        gather_rows(table[None], idx)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_conv_fn_gradients_card_vs_cpu(dtype, tol, cuda_device):
    """SubmConvFn / DownConvFn on the card (kernels) against the CPU (plain
    versions) on a real plan: outputs, dX and dW."""
    rng = np.random.default_rng(0)
    grid = (11, 20, 18)
    d, h, w_ = grid
    keys = np.stack([np.sort(rng.choice(d * h * w_, 400, replace=False)).astype(np.int32)
                     for _ in range(2)])
    mask = np.ones((2, 400), bool)
    plan = tsp.plan_stage_train_batched(torch.from_numpy(keys), torch.from_numpy(mask),
                                        grid, (3, 3, 3), (2, 2, 2), (0, 1, 1), 600,
                                        subm_kernel=(3, 3, 3))
    rbs, rbd, rbt = plan[:3]
    x = torch.from_numpy(rng.normal(size=(2, 400, 16)).astype(np.float32))
    w1 = torch.from_numpy((rng.normal(size=(27 * 16, 16)) / 20).astype(np.float32))
    w2 = torch.from_numpy((rng.normal(size=(27 * 16, 32)) / 20).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(2, 600, 32)).astype(np.float32))
    res = []
    for dev in (cuda_device, torch.device("cpu")):
        xs, a, b = (t.to(dev).requires_grad_() for t in (x, w1, w2))
        y = tsp.SubmConvFn.apply(xs, rbs.to(dev), a, dtype)
        z = tsp.DownConvFn.apply(y, rbd.to(dev), rbt.to(dev), b, dtype)
        (z * r.to(dev)).sum().backward()
        res.append([t.detach().cpu() for t in (z, xs.grad, a.grad, b.grad)])
    for got, ref in zip(*res):
        torch.testing.assert_close(got, ref, atol=tol * float(ref.abs().max()), rtol=tol)


@pytest.mark.parametrize("kernel,stride,pad,c,cout,d", [
    ((3, 3, 3), (1, 1, 1), (1, 1, 1), 16, 16, 41), ((3, 3, 3), (2, 2, 2), (1, 1, 1), 16, 32, 41),
    ((3, 3, 3), (2, 2, 2), (0, 1, 1), 64, 64, 12), ((3, 1, 1), (2, 1, 1), (0, 0, 0), 64, 64, 6)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_column_conv_fn_gradients_card_vs_cpu(kernel, stride, pad, c, cout, d, dtype, tol,
                                              cuda_device):
    """ColumnConvFn on the card (the column_conv kernel forward and for dX
    over the transposed rulebook, gather_rows for the dW regather) against
    the CPU (plain versions, the same decomposition) on a real column
    plan: the output, dX and dW; 2 column_conv and 1 gather_rows launches."""
    rng = np.random.default_rng(c + d)
    hw = (30, 26)
    kyx, syx, pyx = kernel[1:], stride[1:], pad[1:]
    keys = np.stack([np.sort(rng.choice(hw[0] * hw[1], 250, replace=False)).astype(np.int32)
                     for _ in range(2)])
    keys, mask = torch.from_numpy(keys), torch.ones((2, 250), dtype=torch.bool)
    out_hw = tuple((hw[i] + 2 * pyx[i] - kyx[i]) // syx[i] + 1 for i in range(2))
    if kyx == (1, 1):
        ok, om = keys, mask
    else:
        ok, om, _ = tcsp.downsample_bev_columns(keys, mask, hw, kyx, syx, pyx, 400, out_hw)
    rb = tcsp.build_bev_rulebook_batched(keys, mask, hw, kyx, syx, pyx, ok, om, out_hw)
    rbt = tcsp.transpose_bev_rulebook_batched(keys, mask, hw, kyx, syx, pyx, ok, om, out_hw)
    k = kernel[0] * kyx[0] * kyx[1]
    x = torch.from_numpy((rng.normal(size=(2, 250, d, c))
                          * (rng.uniform(size=(2, 250, d, 1)) < 0.3)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(k * c, cout)) / np.sqrt(k * c)).astype(np.float32))
    d_out = (d + 2 * pad[0] - kernel[0]) // stride[0] + 1
    r = torch.from_numpy(rng.normal(size=(2, ok.shape[1], d_out * cout)).astype(np.float32))
    res = []
    for dev in (cuda_device, torch.device("cpu")):
        xs = x.reshape(2, 250, d * c).to(dev).requires_grad_()
        ws = w.to(dev).requires_grad_()
        before = (tzw.LAUNCHES["column_conv"], tzw.LAUNCHES["gather_rows"])
        y = tcc.ColumnConvFn.apply(xs, rb.to(dev), rbt.to(dev), ws, kernel, d, c,
                                   stride[0], pad[0], dtype)
        (y * r.to(dev)).sum().backward()
        launched = (tzw.LAUNCHES["column_conv"] - before[0],
                    tzw.LAUNCHES["gather_rows"] - before[1])
        assert launched == ((2, 1) if dev.type == "cuda" else (0, 0))
        res.append([t.detach().cpu() for t in (y, xs.grad, ws.grad)])
    for got, ref in zip(*res):
        assert float(ref.abs().max()) > 0
        torch.testing.assert_close(got, ref, atol=tol * float(ref.abs().max()), rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_densify_fn_card_vs_cpu(dtype, cuda_device):
    """DensifyFn (the dense cutover's gather and its own-cell backward) on
    the gather_rows kernel against the plain version: bit-equal both ways,
    2 launches."""
    rng = np.random.default_rng(1)
    own = torch.from_numpy(rng.permutation(5000)[:801].astype(np.int32))
    live = torch.from_numpy(rng.uniform(size=801) < 0.8)
    idx = torch.full((5000,), 800, dtype=torch.int32)
    idx[own[live].long()] = torch.arange(801, dtype=torch.int32)[live]
    table = torch.from_numpy(rng.normal(size=(801, 64)).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(size=(5000, 64)).astype(np.float32)).to(dtype)
    res = []
    for dev in (cuda_device, torch.device("cpu")):
        t = table.to(dev).requires_grad_()
        before = tzw.LAUNCHES["gather_rows"]
        out = tsp.DensifyFn.apply(t, idx.to(dev), own.to(dev), live.to(dev))
        out.backward(g.to(dev))
        assert tzw.LAUNCHES["gather_rows"] - before == (2 if dev.type == "cuda" else 0)
        res.append((out.detach().cpu(), t.grad.cpu()))
    for got, ref in zip(*res):
        assert torch.equal(got, ref)


def _cc_case(c, cout, d, kernel, seed, dev, b=2, n=200, m=531, sparse_z=True):
    """Random column rulebook: rows in [0, N], N (a miss) for about a
    third, one all-miss column; rows active at a few z only, as a column
    of voxels is."""
    rng = np.random.default_rng(seed)
    k2 = kernel[1] * kernel[2]
    cf = rng.normal(size=(b, n, d, c)).astype(np.float32)
    if sparse_z:
        cf *= (rng.uniform(size=(b, n, d, 1)) < 0.25)
    rb = rng.integers(0, n + 1, (b, m * k2)).astype(np.int32)
    rb[rng.uniform(size=rb.shape) < 0.3] = n
    rb[1, 7 * k2: 8 * k2] = n
    w = (rng.normal(size=(kernel[0] * k2 * c, cout)) / np.sqrt(27 * c)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (cf.reshape(b, n, d * c), rb, w)]


COLUMN_SHAPES = [
    (4, 16, 41, (3, 3, 3), 1, 1), (16, 16, 41, (3, 3, 3), 1, 1),
    (16, 32, 41, (3, 3, 3), 2, 1), (32, 32, 21, (3, 3, 3), 1, 1),
    (32, 64, 21, (3, 3, 3), 2, 1), (64, 64, 11, (3, 3, 3), 1, 1),
    (64, 64, 11, (3, 3, 3), 2, 0), (64, 64, 5, (3, 3, 3), 1, 1),
    (64, 64, 5, (3, 1, 1), 2, 0), (32, 32, 21, (3, 3, 3), 2, 0)]


def _cc_counts():
    return [tzw.LAUNCHES[k] for k in ("column_conv", "column_conv.fma", "column_conv.mma")]


def _cc_check(cf, rb, w, kernel, d, c, sz, pz, dtype, route=None):
    """One launch against the plain version, 1e-5 of the output scale,
    counted once in all and once on its route; the output sites that no
    tap reaches with a non-zero input slice are exactly zero."""
    route_used = route or route_of(dtype, c, w.shape[1])
    before = _cc_counts()
    got = column_conv(cf, rb, w, kernel, d, c, sz, pz, dtype, route=route)
    torch.cuda.synchronize()
    after = _cc_counts()
    assert after[0] == before[0] + 1
    assert after[1:] == [before[1] + (route_used == "fma"), before[2] + (route_used == "mma")]
    ref = tcsp.column_conv_dz(cf, rb, w, kernel, d, c, sz, pz, dtype)
    scale = float(ref.abs().max())
    assert scale > 0
    torch.testing.assert_close(got, ref, atol=1e-5 * scale, rtol=1e-5)
    b, n, _ = cf.shape
    nz = (cf.to(dtype).reshape(b, n, d, c) != 0).any(-1)
    occ = tcsp.column_occupancy_batched(nz, rb, kernel, sz, pz)
    assert not got[~occ.repeat_interleave(w.shape[1], dim=-1)].any()
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,cout,d,kernel,sz,pz", COLUMN_SHAPES)
def test_column_conv_kernel_matches_plain(c, cout, d, kernel, sz, pz, dtype, cuda_device):
    """Every (C, Cout, D, kernel, stride_z, pad_z) of the column path, M
    not a multiple of any tile, on the route the rule picks (in bf16 the
    tensor cores for all but C = 4). Both sum exact products of
    compute-dtype inputs in float32, in other orders: 1e-5 of the output
    scale. An all-miss column gives exact zeros. With M = 531 and D_out
    up to 41, M*D_out is no multiple of 64, and the "mma" route's run of
    columns 512-575 spans the two frames."""
    cf, rb, w = _cc_case(c, cout, d, kernel, c + cout + d, cuda_device)
    got = _cc_check(cf, rb, w, kernel, d, c, sz, pz, dtype)
    assert not got[1, 7].any()


@pytest.mark.parametrize("c,cout,d,kernel,sz,pz", COLUMN_SHAPES[1:])
def test_column_mma_route_dense_rows(c, cout, d, kernel, sz, pz, cuda_device):
    """The tensor-core route where every z of every row is active (every
    output site of a hit column listed, no tap skipped for a zero slice)."""
    assert route_of(torch.bfloat16, c, cout) == "mma"
    cf, rb, w = _cc_case(c, cout, d, kernel, 3 * c + d, cuda_device, sparse_z=False)
    got = _cc_check(cf, rb, w, kernel, d, c, sz, pz, torch.bfloat16)
    assert not got[1, 7].any()


@pytest.mark.parametrize("cols", [1, 7, 128])
def test_column_mma_any_run_of_columns(cols, cuda_device, monkeypatch):
    """The result does not depend on the columns a block owns: runs of 1
    (sites of one column only), 7 (runs across frame ends at odd places)
    and 128 (up to 128 * 21 listed sites a block)."""
    monkeypatch.setattr(tcc, "COLS_PER_BLOCK", cols)
    cf, rb, w = _cc_case(32, 64, 21, (3, 3, 3), 17, cuda_device)
    _cc_check(cf, rb, w, (3, 3, 3), 21, 32, 2, 1, torch.bfloat16)


def test_column_mma_extreme_columns(cuda_device):
    """Columns whose sites are extreme: frame 0's columns 64-191 (two whole
    runs) miss every tap and come out exactly zero; column 200 hits one
    row, active at z = 0 and z = D - 1 only, so only output z 0, 1 and
    D - 2, D - 1 (pad_z 1) are non-zero; frame 1's rows are active at every
    z; a row of -0.0 values counts as zero."""
    d, c = 21, 32
    cf, rb, w = _cc_case(c, 32, d, (3, 3, 3), 23, cuda_device, n=150, m=300)
    n = cf.shape[1]
    cf = cf.reshape(2, n, d, c)
    cf[1] = torch.randn_like(cf[1])
    cf[0, 5] = 0.0
    cf[0, 5, 0] = 1.0
    cf[0, 5, d - 1] = -2.0
    cf[0, 6] = -0.0
    cf = cf.reshape(2, n, d * c).contiguous()
    rb = rb.reshape(2, 300, 9).clone()
    rb[0, 64:192] = n
    rb[0, 200] = n
    rb[0, 200, 4] = 5
    rb[0, 201] = 6
    got = _cc_check(cf, rb.reshape(2, -1).contiguous(), w, (3, 3, 3), d, c, 1, 1,
                    torch.bfloat16)
    assert not got[0, 64:192].any() and not got[0, 201].any()
    zs = got[0, 200].reshape(d, 32).abs().sum(-1).nonzero().flatten().tolist()
    assert zs == [0, 1, d - 2, d - 1]


@pytest.mark.parametrize("c,cout,d", [(16, 32, 41), (64, 64, 11)])
def test_column_fma_route_forced_and_float32(c, cout, d, cuda_device):
    """The FMA kernel forced in bf16 agrees with the plain version and is
    counted on "fma"; float32 takes "fma" by default, bit for bit the
    forced call; "mma" refuses float32 and C = 4, launching nothing."""
    cf, rb, w = _cc_case(c, cout, d, (3, 3, 3), 31, cuda_device)
    args = ((3, 3, 3), d, c, 1, 1)
    _cc_check(cf, rb, w, *args, torch.bfloat16, route="fma")
    got = _cc_check(cf, rb, w, *args, torch.float32)
    forced = column_conv(cf, rb, w, *args, torch.float32, route="fma")
    torch.cuda.synchronize()
    assert torch.equal(got, forced)
    before = _cc_counts()
    with pytest.raises(ValueError):
        column_conv(cf, rb, w, *args, torch.float32, route="mma")
    cf4, rb4, w4 = _cc_case(4, 16, 41, (3, 3, 3), 31, cuda_device)
    with pytest.raises(ValueError):
        column_conv(cf4, rb4, w4, (3, 3, 3), 41, 4, 1, 1, torch.bfloat16, route="mma")
    with pytest.raises(ValueError):
        column_conv(cf, rb, w, *args, torch.bfloat16, route="wgmma")
    assert _cc_counts() == before


def test_column_mma_unaligned_bf16_view_and_wild_rows(cuda_device):
    """A bf16 view off 16-byte alignment (what ``cp.async`` needs) is
    copied by the wrapper, not read askew; negative rows and rows > N are
    misses: both bit for bit the plain call's result."""
    cf, rb, w = _cc_case(32, 32, 21, (3, 3, 3), 13, cuda_device)
    x = cf.bfloat16()
    args = ((3, 3, 3), 21, 32, 1, 1, torch.bfloat16)
    ref = column_conv(x, rb, w, *args)
    odd = torch.cat([x.new_zeros((1,)), x.reshape(-1)])[1:].reshape(x.shape)
    assert odd.data_ptr() % 16 != 0 and odd.is_contiguous()
    n = cf.shape[1]
    wild = torch.where(rb == n, torch.full_like(rb, -1), rb)
    wild[0, ::7] = torch.where(wild[0, ::7] < 0, n + 5, wild[0, ::7])
    for got in (column_conv(odd, rb, w, *args), column_conv(x, wild, w, *args)):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, atol=0, rtol=0)


def test_column_conv_kernel_dense_rows_and_unaligned_base(cuda_device):
    """Rows with every z active (no tap skipped), and a table whose base is
    only row-aligned (C = 4 bf16 rows are 8 bytes: narrower loads)."""
    cf, rb, w = _cc_case(4, 16, 41, (3, 3, 3), 1, cuda_device, sparse_z=False)
    for dtype in (torch.float32, torch.bfloat16):
        ref = tcsp.column_conv_dz(cf, rb, w, (3, 3, 3), 41, 4, 1, 1, dtype)
        got = column_conv(cf, rb, w, (3, 3, 3), 41, 4, 1, 1, dtype)
        torch.testing.assert_close(got, ref, atol=1e-5 * float(ref.abs().max()), rtol=1e-5)
    odd = torch.cat([cf.new_zeros((1,)), cf.reshape(-1)])[1:].reshape(cf.shape)
    assert odd.data_ptr() % 16 != 0 and odd.is_contiguous()
    got = column_conv(odd, rb, w, (3, 3, 3), 41, 4, 1, 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tcsp.column_conv_dz(cf, rb, w, (3, 3, 3), 41, 4, 1, 1),
                               atol=1e-5 * float(ref.abs().max()), rtol=1e-5)


def test_column_conv_kernel_treats_out_of_range_rows_as_misses(cuda_device):
    cf, rb, w = _cc_case(16, 32, 21, (3, 3, 3), 9, cuda_device)
    n = cf.shape[1]
    ref = column_conv(cf, rb, w, (3, 3, 3), 21, 16)
    wild = torch.where(rb == n, torch.full_like(rb, -1), rb)
    wild[0, ::7] = torch.where(wild[0, ::7] < 0, n + 5, wild[0, ::7])
    torch.testing.assert_close(column_conv(cf, wild, w, (3, 3, 3), 21, 16), ref,
                               atol=0, rtol=0)


def test_column_conv_kernel_rejects_bad_input(cuda_device):
    cf, rb, w = _cc_case(16, 32, 21, (3, 3, 3), 4, cuda_device)
    args = ((3, 3, 3), 21, 16)
    with pytest.raises(TypeError):
        column_conv(cf, rb.long(), w, *args)
    with pytest.raises(TypeError):
        column_conv(cf, rb, w, *args, compute_dtype=torch.float16)
    with pytest.raises(ValueError):
        column_conv(cf, rb, w[:-1], *args)
    with pytest.raises(ValueError):
        column_conv(cf, rb, w[:, :24], *args)            # Cout 24 has no instance
    with pytest.raises(ValueError):
        column_conv(cf, rb, w, (3, 3, 3), 7, 48)           # C not a power of two
    with pytest.raises(ValueError):
        column_conv(cf, rb.cpu(), w, *args)
    with pytest.raises(ValueError):
        column_conv(cf.transpose(1, 2).contiguous().transpose(1, 2), rb, w, *args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["v1", "v3"])
@pytest.mark.parametrize("c", [4, 16, 32])
def test_zwin_align_kernels_match_plain_and_zwin_conv(c, variant, dtype, cuda_device):
    """The kernels on gathered windows against their plain versions and
    against the z-window kernel on the same rulebook: 1e-5 of the scale."""
    feats, start, pattern, w = _case(c, 5, cuda_device, m=1003)
    m = start.shape[1] // 9
    g_km = tzw.gather_windows_km(feats, start, dtype)
    name = f"zwin_align_{variant}"
    before = tzw.LAUNCHES[name]
    if variant == "v1":
        masks = tzw.pair_masks(pattern, m, dtype)
        got = tzw.zwin_align_gemm_v1(g_km, masks, w)
        ref = tzw.zwin_align_gemm_v1_plain(g_km, masks, w)
        via = tzw.conv_zwin_apply_v1(feats, start, pattern, w, (3, 3, 3), dtype)
    else:
        masks = tzw.shift_masks(pattern, m, dtype)
        got = tzw.zwin_align_gemm_v3(g_km, masks, w)
        ref = tzw.zwin_align_gemm_v3_plain(g_km, masks, w)
        via = tzw.conv_zwin_apply_v3(feats, start, pattern, w, (3, 3, 3), dtype)
    torch.cuda.synchronize()
    assert tzw.LAUNCHES[name] == before + 2
    tol = dict(atol=1e-5 * float(ref.abs().max()), rtol=1e-5)
    torch.testing.assert_close(got, ref, **tol)
    assert torch.equal(via, got)
    torch.testing.assert_close(got, tzw.zwin_conv(feats, start, pattern, w, (3, 3, 3), dtype),
                               **tol)


def test_zwin_align_kernels_reject_bad_input(cuda_device):
    feats, start, pattern, w = _case(16, 6, cuda_device)
    m = start.shape[1] // 9
    g_km = tzw.gather_windows_km(feats, start, torch.float32)
    m1 = tzw.pair_masks(pattern, m, torch.float32)
    m3 = tzw.shift_masks(pattern, m, torch.float32)
    with pytest.raises(TypeError):
        tzw.zwin_align_gemm_v1(g_km, m1.bfloat16(), w)
    with pytest.raises(TypeError):
        tzw.zwin_align_gemm_v3(g_km.half(), m3.half(), w)
    with pytest.raises(ValueError):
        tzw.zwin_align_gemm_v1(g_km, m3, w)                 # the other layout
    with pytest.raises(ValueError):
        tzw.zwin_align_gemm_v3(g_km, m3, w[:-1])
    with pytest.raises(ValueError):
        tzw.zwin_align_gemm_v3(g_km, m3.cpu(), w)
    with pytest.raises(ValueError):
        tzw.zwin_align_gemm_v1(g_km.transpose(1, 2).contiguous().transpose(1, 2), m1, w)


def _za_case(c, cout, seed, dev, dtype=torch.bfloat16, n=300, m=1003):
    """Windows and both mask layouts of a random rulebook (starts reach N)
    in ``dtype``; B*M = 2006 is no multiple of the 64-site tile, and the
    tile of sites 960-1023 spans the two frames."""
    feats, start, pattern, w = _case(c, seed, dev, n=n, m=m, cout=cout)
    masks = {"v1": tzw.pair_masks(pattern, m, dtype),
             "v3": tzw.shift_masks(pattern, m, dtype)}
    return tzw.gather_windows_km(feats, start, dtype), masks, w


ALIGN = {"v1": (tzw.zwin_align_gemm_v1, tzw.zwin_align_gemm_v1_plain),
         "v3": (tzw.zwin_align_gemm_v3, tzw.zwin_align_gemm_v3_plain)}


def _za_counts(variant):
    name = f"zwin_align_{variant}"
    return [tzw.LAUNCHES[k] for k in (name, f"{name}.fma", f"{name}.mma")]


def _za_check(variant, g_km, masks, w, route=None, tol=1e-5):
    """One launch against the plain version, ``tol`` of the output scale,
    counted once in all and once on its route."""
    fn, plain = ALIGN[variant]
    route_used = route or route_of(g_km.dtype, g_km.shape[3] // 3, w.shape[1])
    before = _za_counts(variant)
    got = fn(g_km, masks, w, route=route)
    torch.cuda.synchronize()
    after = _za_counts(variant)
    assert after[0] == before[0] + 1
    assert after[1:] == [before[1] + (route_used == "fma"), before[2] + (route_used == "mma")]
    ref = plain(g_km, masks, w)
    assert float(ref.abs().max()) > 0
    torch.testing.assert_close(got, ref, atol=tol * float(ref.abs().max()), rtol=tol)
    return got


@pytest.mark.parametrize("variant", ["v1", "v3"])
@pytest.mark.parametrize("cout", [16, 32, 64])
@pytest.mark.parametrize("c", [16, 32])
def test_zwin_align_mma_route_matches_plain(c, cout, variant, cuda_device):
    """The tensor-core route (bf16; the tile's rulebook built from the
    masks) at every Cout the kernels take: exact products summed in f32,
    1e-5 of the output scale, counted on "mma"."""
    assert route_of(torch.bfloat16, c, cout) == "mma"
    g_km, masks, w = _za_case(c, cout, c + cout, cuda_device)
    _za_check(variant, g_km, masks[variant], w)


@pytest.mark.parametrize("variant", ["v1", "v3"])
def test_zwin_align_mma_sparse_tiles(variant, cuda_device):
    """Sites 128-255 of frame 0 (two whole tiles) have no mask set and come
    out exactly zero; site 300 has one candidate only; in frame 1 every
    window starts at N - 1 with all three bits set, so two of its rows are
    the zero rows past N."""
    n, m = 200, 410
    feats, start, pattern, w = _case(32, 7, cuda_device, n=n, m=m, cout=32)
    st = start.reshape(2, m, 9).clone()
    pt = pattern.reshape(2, m, 9).clone()
    pt[0, 128:256] = 0
    pt[0, 300] = 0
    pt[0, 300, 4], st[0, 300, 4] = 0b100, 17
    st[1] = n - 1
    pt[1] = 0b111
    st, pt = st.reshape(2, -1), pt.reshape(2, -1)
    g_km = tzw.gather_windows_km(feats, st, torch.bfloat16)
    make = tzw.pair_masks if variant == "v1" else tzw.shift_masks
    got = _za_check(variant, g_km, make(pt, m, torch.bfloat16), w)
    assert not got[0, 128:256].any()
    assert got[0, 300].any()


def _extra_masks(variant, masks, kind):
    """doubled: tap dz = 1 of every window also takes candidates 0 and 1;
    tripled: every candidate j <= dz goes to every tap dz."""
    out = masks.clone()
    for dz, j in ([(1, 0), (1, 1)] if kind == "doubled" else tzw.PAIRS):
        if variant == "v1":
            out[..., tzw.PAIRS.index((dz, j))] = 1
        else:
            out.view(3, *out.shape[1:3], 9, 3)[dz - j, ..., j] = 1
    return out


@pytest.mark.parametrize("kind", ["doubled", "tripled"])
@pytest.mark.parametrize("variant", ["v1", "v3"])
def test_zwin_align_doubled_and_tripled_masks(variant, kind, cuda_device):
    """Masks that route two or three candidates to one (site, k2, dz): the
    tensor-core route runs the tile again on them and adds, against the
    plain version to 2e-2 of the scale in bf16 (v1's plain version rounds
    a tap's summed candidates to bf16 first); the FMA route in float32 to
    1e-5."""
    for dtype, route, tol in ((torch.bfloat16, None, 2e-2), (torch.float32, None, 1e-5),
                              (torch.bfloat16, "fma", 2e-2)):
        g_km, masks, w = _za_case(16, 32, 17, cuda_device, dtype)
        _za_check(variant, g_km, _extra_masks(variant, masks[variant], kind), w,
                  route=route, tol=tol)


@pytest.mark.parametrize("variant", ["v1", "v3"])
def test_zwin_align_mma_unaligned_bf16_view(variant, cuda_device):
    """A bf16 ``g_km`` view off 16-byte alignment is copied by the wrapper,
    not read askew: bit for bit the aligned input's result."""
    g_km, masks, w = _za_case(32, 32, 13, cuda_device)
    odd = torch.cat([g_km.new_zeros((1,)), g_km.reshape(-1)])[1:].reshape(g_km.shape)
    assert odd.data_ptr() % 16 != 0 and odd.is_contiguous()
    fn = ALIGN[variant][0]
    ref = fn(g_km, masks[variant], w)
    got = fn(odd, masks[variant], w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.mark.parametrize("variant", ["v1", "v3"])
def test_zwin_align_fma_route_forced_and_float32(variant, cuda_device):
    """The FMA kernel forced in bf16 agrees with the plain version and is
    counted on "fma"; float32 takes "fma" by default; "mma" refuses float32
    and C = 4, launching nothing."""
    g_km, masks, w = _za_case(32, 64, 21, cuda_device)
    _za_check(variant, g_km, masks[variant], w, route="fma")
    g32, m32, _ = _za_case(32, 64, 21, cuda_device, torch.float32)
    _za_check(variant, g32, m32[variant], w)
    g4, m4, w4 = _za_case(4, 16, 22, cuda_device)
    fn = ALIGN[variant][0]
    before = _za_counts(variant)
    with pytest.raises(ValueError):
        fn(g32, m32[variant], w, route="mma")
    with pytest.raises(ValueError):
        fn(g4, m4[variant], w4, route="mma")
    with pytest.raises(ValueError):
        fn(g_km, masks[variant], w, route="wgmma")
    assert _za_counts(variant) == before


def test_pvrcnn_card_matches_cpu(cuda_device):
    """PV-RCNN two-stage inference at small geometry, float32 with TF32 off,
    card against CPU on one set of weights and CPU-drawn grid points
    (``chip_smoke.py`` phase 8b, which raises on any difference): keypoint
    and ball-query indices equal (the card's from the ball_query kernel),
    point features, proposals, refined boxes and scores within 1e-4 of
    their scale, detections paired, 6 zwin_conv launches on the card, all
    on the FMA route, and 22 ball_query (the forward's 12, the ten checked
    apart)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    with chip_smoke.full_float32():
        out = chip_smoke.pvrcnn_reference_phase(cuda_device)
    assert out["keypoints_equal"] and out["ball_query_equal"]
    assert out["ball_queries"] == 10 and out["detections"]["n_a"] > 0


def test_pvrcnn_training_card_matches_cpu(cuda_device):
    """One PV-RCNN training step of each mode at small geometry, float32
    with TF32 off, card against CPU on one set of weights and batch
    (``chip_smoke.py`` phase 9b, which raises on any difference): keypoint
    and ball-query indices equal, losses to 1e-5 relative, gradients to
    1e-4 of their max on the card's ReLU gates, running statistics and
    parameters after the step within phase 9b's bounds, 27 gather_gemm (all
    on the FMA route), 14 gather_rows and 10 / 12 ball_query launches on
    the card."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    with chip_smoke.full_float32():
        out = chip_smoke.pvrcnn_training_reference_phase(cuda_device)
    assert out["pvrcnn"]["index_sets"] == 11 and out["pvrcnn2"]["index_sets"] == 13
    assert out["pvrcnn2"]["losses_cpu"]["refine_reg_loss"] > 0


def _column_tensor(dev, seed, b=2, n=300, grid=(11, 40, 36), c=16):
    """A random ColumnTensor on ``dev``, about half of each column's z
    active, and its flat rows taking gradient."""
    from vision3d_tpu_torch.models.sparse_cnn import ColumnTensor

    rng = np.random.default_rng(seed)
    d, h, w = grid
    keys = np.full((b, n), h * w, np.int32)
    mask = np.zeros((b, n), bool)
    for i, k in enumerate((n - 20, n - 60)):
        keys[i, :k] = np.sort(rng.choice(h * w, k, replace=False))
        mask[i, :k] = True
    zmask = (rng.uniform(size=(b, n, d)) < 0.5) & mask[..., None]
    feats = (rng.normal(size=(b, n, d, c)) * zmask[..., None]).astype(np.float32)
    feats = torch.from_numpy(feats.reshape(b, n, d * c)).to(dev).requires_grad_()
    t = [torch.from_numpy(a).to(dev) for a in (zmask, keys, mask)]
    return ColumnTensor(feats=feats, zmask=t[0], keys=t[1], mask=t[2], grid=grid, c=c)


@pytest.mark.parametrize("how", ["to_voxel_sparse", "dense_from_columns"])
@pytest.mark.parametrize("cap", [0, 2000])
def test_column_conversions_backward_card_matches_cpu(how, cap, cuda_device):
    """PV-RCNN's column scales read as voxels, ``ColumnTensor.to_voxel_sparse``
    and ``dense_from_columns(keep_keys=True)`` read back at its keys (the
    latter's rows through ``DensifyFn`` on the gather_rows kernel on the
    card), at a capacity that holds every site (0: N * D) and at one that
    truncates: keys, masks and features equal, and the gradient of the
    column rows equal to the CPU's (each site is read once: no sum)."""
    from vision3d_tpu_torch.models import sparse_cnn as tscnn

    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        ct = _column_tensor(dev, 7)
        if how == "to_voxel_sparse":
            vs = ct.to_voxel_sparse(cap or ct.feats.shape[1] * ct.grid[0])
        else:
            vs = tscnn.dense_from_columns(ct, keep_keys=True, voxel_cap=cap).to_voxel_sparse()
        g = torch.from_numpy(np.random.default_rng(8).normal(
            size=tuple(vs.feats.shape)).astype(np.float32)).to(dev)
        vs.feats.backward(g)
        runs.append([t.detach().cpu() for t in (vs.keys, vs.mask, vs.feats, ct.feats.grad)])
    (gk, gm, gf, gg), (ck, cm, cf, cg) = runs
    assert torch.equal(gk, ck) and torch.equal(gm, cm)
    assert (int(cm.sum()) < int(ct.zmask.sum())) == (cap > 0)
    assert torch.equal(gf, cf) and torch.equal(gg, cg)
    assert float(cg.abs().max()) > 0


def test_pvrcnn_columns_card_matches_cpu(cuda_device):
    """PV-RCNN on the column backend at small geometry, float32 with TF32
    off, card against CPU (``chip_smoke.py`` phase 11b, which raises on any
    difference): two-stage inference (6 column_conv launches, all on the FMA
    route) and one two-stage training step (27 column_conv, 14
    gather_rows), indices equal, floats and gradients within its bounds."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    with chip_smoke.full_float32():
        inf = chip_smoke.pvrcnn_reference_phase(cuda_device, "column")
        out = chip_smoke.pvrcnn_training_reference_phase(cuda_device, "column", ("pvrcnn2",))
    assert inf["keypoints_equal"] and inf["ball_query_equal"]
    assert out["pvrcnn2"]["index_sets"] == 13


def test_two_gloo_ranks_on_one_card_match_one_process(cuda_device):
    """Two ranks on the card over gloo against one process on the whole
    batch (``chip_smoke.py`` phase 11d, which raises on any difference):
    SECOND on voxels and on columns, PV-RCNN two-stage."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    with chip_smoke.full_float32():
        out = chip_smoke.ddp_check(chip_smoke.small_geometry_cfg(), "cuda", 2, "gloo",
                                   batch_size=4, points=chip_smoke.PV_REF_POINTS)
    assert set(out) == set(chip_smoke.DDP_FORMS)


def _bq_module():
    import importlib

    return importlib.import_module("vision3d_tpu_torch.ops.ball_query")


def _bq_equal(src, mask, ctr, radius, nsample):
    """The kernel's indices and valid flags against the plain version's on
    the same card tensors, bit for bit; one launch counted."""
    bq = _bq_module()
    before = bq.LAUNCHES["ball_query"]
    idx, valid = bq.ball_query(src, mask, ctr, radius, nsample)
    torch.cuda.synchronize()
    assert bq.LAUNCHES["ball_query"] == before + 1
    ref_idx, ref_valid = bq.ball_query_plain(src, mask, ctr, radius, nsample)
    assert idx.dtype == torch.int64 and valid.dtype == torch.bool
    assert torch.equal(idx, ref_idx) and torch.equal(valid, ref_valid)
    return ref_idx, ref_valid


# the set abstraction's sources on the main path: rows of each source (batch
# 8 of 18,000-point frames), its two radii (nsample 16 and 32), 2,048
# keypoints a frame
BQ_SOURCES = {"points": (18000, (0.4, 0.8)), "scale1": (20000, (0.4, 0.8)),
              "scale2": (60000, (0.8, 1.2)), "scale3": (64000, (1.2, 2.4)),
              "scale4": (38000, (2.4, 4.8))}


@pytest.mark.parametrize("source", list(BQ_SOURCES))
def test_ball_query_kernel_matches_plain_main_shapes(source, cuda_device):
    """Seeded KITTI-like clouds at the main path's shapes, B 8, M 2,048,
    each row masked out with p = 0.1 (not a prefix), the centres drawn from
    each frame's rows: both radii, indices and valid bit-equal."""
    from vision3d_tpu_torch.synthetic import kitti_like_batch

    n, radii = BQ_SOURCES[source]
    rng = np.random.default_rng(n)
    pts, _ = kitti_like_batch(n % 97, 8, n)
    src = np.ascontiguousarray(pts[..., :3])
    mask = rng.uniform(size=(8, n)) >= 0.1
    ctr = np.stack([src[i, rng.choice(n, 2048, replace=False)] for i in range(8)])
    t = [torch.from_numpy(a).to(cuda_device) for a in (src, mask, ctr)]
    for radius, nsample in zip(radii, (16, 32)):
        _, valid = _bq_equal(*t, radius, nsample)
        assert bool(valid[..., 0].any())


def _boundary_case(dev, seed, b=3, m=70, radius=0.8, ring=40):
    """Centres with ``ring`` rows each at radius * (1 + k 2^-24), k in
    [-ring/2, ring/2), in random directions (so squared distances land on
    r2 and on each of its float32 neighbours), shuffled among 3001 random
    rows (N = 5801: no multiple of a tile); 8 centres far from every row;
    rows masked out with p = 0.2; frame 2 wholly masked out."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-5, 5, (b, m, 3)).astype(np.float32)
    u = rng.normal(size=(b, m, ring, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    k = np.arange(-ring // 2, ring // 2)[None, None, :, None]
    rows = (ctr[:, :, None] + u * radius * (1 + k * 2.0 ** -24)).astype(np.float32)
    src = np.concatenate([rows.reshape(b, -1, 3),
                          rng.uniform(-6, 6, (b, 3001, 3)).astype(np.float32)], axis=1)
    src = np.ascontiguousarray(src[:, rng.permutation(src.shape[1])])
    ctr = np.concatenate([ctr, rng.uniform(40, 50, (b, 8, 3)).astype(np.float32)], axis=1)
    mask = rng.uniform(size=src.shape[:2]) >= 0.2
    mask[2] = False
    return [torch.from_numpy(a).to(dev) for a in (src, mask, ctr)]


def test_ball_query_kernel_at_the_radius(cuda_device):
    """Rows at exactly r2 and one float32 ulp either side of it (in the
    plain version's rounding), masked-out rows inside balls, groups below,
    at and above nsample, empty balls (far centres, a wholly masked frame),
    M = 78 and N = 5801 off every block and tile size: bit-equal."""
    from vision3d_tpu_torch.ops.fps import squared_distance

    radius = 0.8
    src, mask, ctr = _boundary_case(cuda_device, 11, radius=radius)
    d = squared_distance(ctr[:, :, None], src[:, None])
    r2 = torch.tensor(float(np.float32(radius) * np.float32(radius)), device=cuda_device)
    for near in (r2, torch.nextafter(r2, r2 - 1), torch.nextafter(r2, r2 + 1)):
        assert int((d == near).sum()) > 0
    in_ball = d < r2
    assert bool((in_ball & ~mask[:, None]).any())
    count = (in_ball & mask[:, None]).sum(-1)[:2, :70]
    for nsample in (1, 5, 20, 32, 40):
        _, valid = _bq_equal(src, mask, ctr, radius, nsample)
        assert not bool(valid[2].any()) and not bool(valid[:, 70:].any())
    assert bool((count < 20).any() and (count == 20).any() and (count > 20).any())


@pytest.mark.parametrize("b,n,m", [(1, 1, 1), (1, 255, 257), (2, 257, 33), (5, 1000, 9),
                                   (1, 300, 2048)])
def test_ball_query_kernel_any_size(b, n, m, cuda_device):
    """Sizes off the tile (32 x warps a block) and the block, B = 1, and a
    grid small enough for two warps a block: bit-equal."""
    rng = np.random.default_rng(b * 1000 + n + m)
    src = rng.uniform(-2, 2, (b, n, 3)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) < 0.7
    ctr = rng.uniform(-2, 2, (b, m, 3)).astype(np.float32)
    t = [torch.from_numpy(a).to(cuda_device) for a in (src, mask, ctr)]
    for nsample in (4, 16):
        _bq_equal(*t, 1.0, nsample)


def test_ball_query_kernel_empty_source(cuda_device):
    """No source rows at all: every ball empty, indices 0, valid False."""
    bq = _bq_module()
    idx, valid = bq.ball_query(torch.zeros((2, 0, 3), device=cuda_device),
                               torch.zeros((2, 0), dtype=torch.bool, device=cuda_device),
                               torch.ones((2, 5, 3), device=cuda_device), 1.0, 4)
    assert tuple(idx.shape) == (2, 5, 4) and int(idx.abs().sum()) == 0
    assert not bool(valid.any())


def test_ball_query_kernel_rejects_bad_input(cuda_device):
    bq = _bq_module()
    src, mask, ctr = _boundary_case(cuda_device, 12)
    before = bq.LAUNCHES["ball_query"]
    with pytest.raises(TypeError):
        bq.ball_query(src.double(), mask, ctr, 0.8, 16)
    with pytest.raises(TypeError):
        bq.ball_query(src, mask, ctr.half(), 0.8, 16)
    with pytest.raises(TypeError):
        bq.ball_query(src, mask.to(torch.uint8), ctr, 0.8, 16)
    with pytest.raises(ValueError):
        bq.ball_query(src, mask.cpu(), ctr, 0.8, 16)
    with pytest.raises(ValueError):
        bq.ball_query(src, mask, ctr.cpu(), 0.8, 16)
    with pytest.raises(ValueError):
        bq.ball_query(torch.stack([src, src], -1)[..., 0], mask, ctr, 0.8, 16)
    with pytest.raises(ValueError):
        bq.ball_query(src, torch.stack([mask, mask], -1)[..., 0], ctr, 0.8, 16)
    with pytest.raises(ValueError):
        bq.ball_query(src, mask, ctr[:, :, :2], 0.8, 16)
    with pytest.raises(ValueError):
        bq.ball_query(src, mask, ctr, 0.8, 0)
    assert bq.LAUNCHES["ball_query"] == before


def _point_launches(dev):
    """The launches of each kernel in one forward of PV-RCNN's two stages,
    of its BEV branch alone and of SECOND, at small geometry on the card."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from vision3d_tpu_torch import kernels
    from vision3d_tpu_torch.models.pvrcnn import create_pvrcnn
    from vision3d_tpu_torch.models.second import create_second
    from vision3d_tpu_torch.synthetic import kitti_like_batch

    cfg = chip_smoke.pvrcnn_cfg(chip_smoke.small_geometry_cfg())
    pts, num = chip_smoke.crop_to_grid(cfg, kitti_like_batch(1, 2, 60000)[0])
    pts, num = pts[:, :chip_smoke.PV_REF_POINTS], np.minimum(num, chip_smoke.PV_REF_POINTS)
    points, num_t = torch.from_numpy(pts).to(dev), torch.from_numpy(num).to(dev)
    model, anchors = create_pvrcnn(cfg, device=dev)
    second, _ = create_second(cfg, device=dev)
    runs = {"pvrcnn2": lambda: model.inference_two_stage(
                points, num_t, anchors, generator=torch.Generator().manual_seed(0)),
            "pvrcnn_bev": lambda: model.inference(points, num_t, anchors),
            "second": lambda: second.inference(points, num_t, anchors)}
    launched = {}
    with torch.no_grad():
        for name, fn in runs.items():
            kernels.reset_launches()
            fn()
            torch.cuda.synchronize()
            launched[name] = dict(kernels.LAUNCHES)
    return launched, chip_smoke


def test_ball_query_launches_per_forward(cuda_device):
    """12 ball_query launches a PV-RCNN two-stage forward (five sources x
    two radii, the grid pool's two), none for its BEV branch alone or for
    SECOND, at small geometry on the card."""
    launched, chip_smoke = _point_launches(cuda_device)
    assert {k: v["ball_query"] for k, v in launched.items()} == {
        "pvrcnn2": chip_smoke.BALL_QUERIES["pvrcnn2"], "pvrcnn_bev": 0, "second": 0}
    assert chip_smoke.BALL_QUERIES["pvrcnn2"] == 12


# ------------------------------------------- furthest point sampling (K3)

def _fps_equal(xyz, mask, k):
    """K3's indices against the plain version's on the same card tensors,
    bit for bit; one launch counted, on the route ``plan`` names. Returns
    (indices, route, cluster size)."""
    b, n = mask.shape
    route, cluster = tfps.plan(b, n, xyz.device)
    before = (tfps.LAUNCHES["fps"], tfps.LAUNCHES[f"fps.{route}"])
    idx = tfps.furthest_point_sample(xyz, mask, k)
    torch.cuda.synchronize()
    assert (tfps.LAUNCHES["fps"], tfps.LAUNCHES[f"fps.{route}"]) == (before[0] + 1,
                                                                      before[1] + 1)
    ref = tfps.furthest_point_sample_plain(xyz, mask, k)
    assert idx.dtype == torch.int64 and tuple(idx.shape) == (b, k)
    assert torch.equal(idx, ref)
    return ref, route, cluster


def _fps_clouds(dev, seed, b, n, valid_share=1.0):
    """``b`` seeded KITTI-like clouds of ``n`` rows (duplicated rows where
    a frame is padded by resampling); every other frame keeps only its first
    ``valid_share`` of rows valid, the tail zeros."""
    from vision3d_tpu_torch.synthetic import kitti_like_batch

    rng = np.random.default_rng(seed)
    pts, _ = kitti_like_batch(seed, b, n)
    xyz = np.ascontiguousarray(pts[..., :3])
    mask = np.ones((b, n), bool)
    for i in range(1, b, 2):
        keep = int(n * valid_share) - int(rng.integers(0, max(1, n // 10)))
        mask[i, max(1, keep):] = False
        xyz[i, max(1, keep):] = 0.0
    return torch.from_numpy(xyz).to(dev), torch.from_numpy(mask).to(dev)


def test_fps_kernel_matches_plain_cell_shape(cuda_device):
    """The benchmark cell's shape: B 8, N 18,000, K 2,048, KITTI-like
    clouds, four of them with padded tails: bit-equal, 2,048 distinct
    keypoints a frame."""
    xyz, mask = _fps_clouds(cuda_device, 8, 8, 18000, valid_share=0.9)
    idx, route, _ = _fps_equal(xyz, mask, 2048)
    assert route == "reg"
    assert all(len(torch.unique(r)) == 2048 for r in idx)
    assert bool(mask.gather(1, idx).all())


@pytest.mark.parametrize("b,n,k", [(2, 1, 4), (3, 100, 50), (2, 255, 255), (4, 5801, 300),
                                   (2, 4097, 64), (1, 18000, 2048), (3, 500, 700)])
def test_fps_kernel_any_size(b, n, k, cuda_device):
    """N of one point, under one block's threads, off every slice and
    thread count; B 1 at the cell's N (the widest cluster); K above the
    valid count (the first valid point repeats): bit-equal."""
    rng = np.random.default_rng(b * 100000 + n + k)
    xyz = rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) < 0.8
    t = [torch.from_numpy(a).to(cuda_device) for a in (xyz, mask)]
    idx, _, cluster = _fps_equal(*t, k)
    if b == 1:
        assert cluster == tfps.plan(1, n, cuda_device)[1] >= tfps.plan(8, n, cuda_device)[1]
    if k > n:
        first = mask.argmax(1)
        assert (idx[:, -1].cpu().numpy() == first).all()


def test_fps_kernel_edge_clouds(cuda_device):
    """One batch of: a cloud with no valid point (every index 0); every
    point twice (point i + 1500 is point i) on a 0.1 m lattice, so many
    running distances tie (the lower index wins); valid points only from
    row 777 on (the first keypoint 777); K 512 above the 400 valid points
    of the last cloud (repeats)."""
    rng = np.random.default_rng(21)
    n = 3000
    xyz = rng.uniform(-5, 5, (4, n, 3)).astype(np.float32)
    xyz[1, 1500:] = xyz[1, :1500] = np.round(xyz[1, :1500], 1)
    mask = np.ones((4, n), bool)
    mask[0] = False
    mask[2, :777] = False
    mask[3] = False
    mask[3, rng.choice(n, 400, replace=False)] = True
    t = [torch.from_numpy(a).to(cuda_device) for a in (xyz, mask)]
    idx, _, _ = _fps_equal(*t, 512)
    idx = idx.cpu().numpy()
    assert (idx[0] == 0).all() and idx[2, 0] == 777
    assert (idx[1] < 1500).all() and len(set(idx[3])) == 400


@pytest.mark.parametrize("b,n,route", [(8, 18000, "reg"), (64, 4000, "reg"),
                                       (200, 10000, "smem"), (200, 20000, "global")])
def test_fps_kernel_routes_and_clusters(b, n, route, cuda_device):
    """Batches large enough to shrink the cluster (every cloud's cluster
    resident at once), down to one block a cloud, whose slice then leaves
    the registers for shared memory, then device memory: bit-equal, on the
    route named, with a smaller cluster than the cell's."""
    xyz, mask = _fps_clouds(cuda_device, b + n, b, n, valid_share=0.95)
    _, got_route, cluster = _fps_equal(xyz, mask, 2048 if b == 8 else 64)
    assert got_route == route
    if b > 8:
        assert cluster < tfps.plan(8, 18000, cuda_device)[1]


def test_fps_kernel_rejects_bad_input(cuda_device):
    xyz, mask = _fps_clouds(cuda_device, 3, 2, 1000)
    before = tfps.LAUNCHES["fps"]
    with pytest.raises(TypeError):
        tfps.furthest_point_sample(xyz.double(), mask, 16)
    with pytest.raises(TypeError):
        tfps.furthest_point_sample(xyz, mask.to(torch.uint8), 16)
    with pytest.raises(ValueError):
        tfps.furthest_point_sample(xyz[..., :2], mask, 16)
    with pytest.raises(ValueError):
        tfps.furthest_point_sample(xyz, mask[:, :999], 16)
    with pytest.raises(ValueError):
        tfps.furthest_point_sample(torch.stack([xyz, xyz], -1)[..., 0], mask, 16)
    with pytest.raises(ValueError):
        tfps.furthest_point_sample(xyz, torch.stack([mask, mask], -1)[..., 0], 16)
    with pytest.raises(ValueError):
        tfps.furthest_point_sample(xyz, mask.cpu(), 16)
    with pytest.raises(ValueError):
        tfps.furthest_point_sample(xyz.cpu(), mask, 16)
    with pytest.raises(ValueError):
        tfps.furthest_point_sample(xyz, mask, 0)
    assert tfps.LAUNCHES["fps"] == before


def test_fps_launches_per_forward(cuda_device):
    """One fps launch a PV-RCNN two-stage forward (its keypoints), none for
    its BEV branch alone or for SECOND, at small geometry on the card."""
    launched, _ = _point_launches(cuda_device)
    assert {k: v["fps"] for k, v in launched.items()} == {
        "pvrcnn2": 1, "pvrcnn_bev": 0, "second": 0}
    assert launched["pvrcnn2"]["fps.reg"] == 1


# ------------------------------------------------------------ voxel query (K2)

def _vq_scale(dev, seed, b=2, grid=(21, 200, 176), per_frame=25000):
    """A scale of a KITTI-like grid: per frame up to ``per_frame`` distinct
    voxels, most on a sloped ground sheet a few cells thick, the rest
    anywhere in z; (keys (B, N) sorted column-major, sentinel padded,
    mask)."""
    rng = np.random.default_rng(seed)
    d, h, w = grid
    n = per_frame + 1000
    keys = np.full((b, n), d * h * w, np.int64)
    for i in range(b):
        y, x = rng.integers(0, h, 3 * per_frame), rng.integers(0, w, 3 * per_frame)
        z = np.clip((5 + x // 60 + rng.integers(0, 3, 3 * per_frame)), 0, d - 1)
        tall = rng.uniform(size=3 * per_frame) < 0.3
        z = np.where(tall, rng.integers(0, d, 3 * per_frame), z)
        k = np.unique((y * w + x) * d + z)[:per_frame]
        k = k[rng.permutation(len(k))][:per_frame - 1000 * i]
        keys[i, :len(k)] = np.sort(k)
    keys = torch.from_numpy(keys.astype(np.int32)).to(dev)
    return keys, keys < d * h * w


def _vq_equal(vmap, grid, pts, lo, step, ranges, radius, nsample):
    """The kernel's rows against the plain version's on the same card
    tensors, bit for bit; one launch counted."""
    from vision3d_tpu_torch.ops import voxel_query as vq

    before = vq.LAUNCHES["voxel_query"]
    got = vq.voxel_query(vmap, grid, pts, lo, step, ranges, radius, nsample)
    torch.cuda.synchronize()
    assert vq.LAUNCHES["voxel_query"] == before + 1
    want = vq.voxel_query_plain(vmap, grid, pts, lo, step, ranges, radius, nsample)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    return want


@pytest.mark.parametrize("stride,radius", [(2, 0.4), (4, 0.8), (8, 1.6)])
def test_voxel_query_kernel_matches_plain(stride, radius, cuda_device):
    """A mid-size scale (B 2, 24-25k voxels a frame on a (21, 200, 176)
    grid) and 2 x 50 x 216 grid points over it and a little beyond its
    edges, at each pooled scale's step and radius: rows bit-equal, some
    balls non-empty, some full."""
    from vision3d_tpu_torch.ops import voxel_query as vq

    grid = (21, 200, 176)
    keys, mask = _vq_scale(cuda_device, stride)
    lo, step = vq.geometry((0.05, 0.05, 0.1), (0.0, -40.0, -3.0, 70.4, 40.0, 1.0), stride)
    rng = np.random.default_rng(stride)
    span = np.array([176, 200, 21], np.float32) * step
    pts = lo + rng.uniform(-0.05, 1.05, (2, 50 * 216, 3)).astype(np.float32) * span
    pts = torch.from_numpy(pts.astype(np.float32)).to(cuda_device).contiguous()
    rows = _vq_equal(vq.row_map(keys, mask, grid), grid, pts, lo, step, (4, 4, 4), radius, 16)
    assert bool((rows[..., 0] >= 0).any()) and bool((rows[..., -1] != rows[..., 0]).any())


def test_voxel_query_kernel_at_the_radius(cuda_device):
    """Grid points on the quarter-cell lattice of a 0.5 m grid: squared
    distances to voxel centres are exact, and many equal r2 = 1.0 (taken),
    others lie a float32 step beyond it (points moved by one ulp); points
    outside the grid and NaN; window ranges that differ by axis and
    nsample 1, 5, 20, 40: bit-equal."""
    from vision3d_tpu_torch.ops import voxel_query as vq

    grid = (8, 24, 28)
    d, h, w = grid
    rng = np.random.default_rng(9)
    k = np.sort(rng.choice(d * h * w, 2000, replace=False))
    keys = torch.from_numpy(np.concatenate([k, [d * h * w] * 5])[None].astype(np.int32))
    keys = keys.to(cuda_device)
    mask = keys < d * h * w
    lo, step = np.zeros(3, np.float32), np.full(3, 0.5, np.float32)
    q = rng.integers(-8, 4 * 30, (1, 3000, 3)).astype(np.float32) * 0.125
    q[0, :500] = np.nextafter(q[0, :500], np.float32(100))
    q[0, 500:510, 0] = np.nan
    pts = torch.from_numpy(q).to(cuda_device).contiguous()
    vmap = vq.row_map(keys, mask, grid)
    for ranges, nsample in (((4, 4, 4), 1), ((1, 2, 3), 5), ((3, 3, 1), 20), ((4, 4, 4), 40)):
        _vq_equal(vmap, grid, pts, lo, step, ranges, 1.0, nsample)


def test_voxel_query_kernel_rejects_bad_input(cuda_device):
    from vision3d_tpu_torch.ops import voxel_query as vq

    grid = (2, 3, 4)
    vmap = torch.full((2 * 24 + 1,), -1, dtype=torch.int32, device=cuda_device)
    pts = torch.zeros((2, 5, 3), device=cuda_device)
    lo, step = np.zeros(3, np.float32), np.ones(3, np.float32)
    with pytest.raises(TypeError):
        vq.voxel_query(vmap, grid, pts.double(), lo, step, (1, 1, 1), 1.0, 4)
    with pytest.raises(ValueError):
        vq.voxel_query(vmap[:-1], grid, pts, lo, step, (1, 1, 1), 1.0, 4)
    with pytest.raises(ValueError):
        vq.voxel_query(vmap, grid, pts[:, :, :2], lo, step, (1, 1, 1), 1.0, 4)
    assert bool((vq.voxel_query(vmap, grid, pts, lo, step, (1, 1, 1), 1.0, 4) == -1).all())


def test_voxel_rcnn_card_launches_and_rows(cuda_device):
    """Voxel R-CNN at a small geometry in float32 on the card, its batch
    norms calibrated on the batch by the plain reference
    (``tests/plain_voxel_rcnn.py``, on the CPU): three voxel_query launches
    a forward, and the card's rows equal to the plain version's on the
    card's own RoIs and scales, most balls non-empty."""
    import dataclasses
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import plain_voxel_rcnn as plain
    from vision3d_tpu_torch import kernels
    from vision3d_tpu_torch.config import Config
    from vision3d_tpu_torch.models import voxel_rcnn as vr
    from vision3d_tpu_torch.ops import voxel_query as vq
    from vision3d_tpu_torch.synthetic import kitti_like_points

    cfg = Config()
    cfg = vr.voxel_rcnn_config(cfg.replace(
        max_voxels=4096, voxel_size=(0.2, 0.2, 0.1),
        grid_bounds=(0.0, -12.8, -3.0, 25.6, 12.8, 1.0),
        num_classes=1, anchors=cfg.anchors[:1], proposal=dataclasses.replace(cfg.proposal, topk=8)))
    rng = np.random.default_rng(3)
    frames = []
    for _ in range(2):
        p = kitti_like_points(rng, 50000)
        frames.append(p[(p[:, 0] < 25.6) & (np.abs(p[:, 1]) < 12.8)][:2500])
    pts, num = torch.from_numpy(np.stack(frames)), torch.tensor([2500, 2200])
    model, anchors = vr.create_voxel_rcnn(cfg, device="cpu")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    plain.forward(plain.Ctx("calib"), sd, dataclasses.asdict(cfg), pts, num, anchors)
    card, anchors = vr.create_voxel_rcnn(cfg, device=cuda_device, state_dict=sd)
    pts, num = pts.to(cuda_device), num.to(cuda_device)
    with torch.no_grad():
        kernels.reset_launches()
        out, _ = card.two_stage(pts, num, anchors)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["voxel_query"] == 3
        assert kernels.LAUNCHES["bn_relu"] == kernels.LAUNCHES["bn_relu.f32"] == 12
        *_, scales = card.trunk(pts, num, need_scales=True)
        grid = vr.roi_grid_points(out["rois"], cfg.voxel_rcnn.grid_size)
        grid = grid.reshape(2, -1, 3).contiguous()
        for k, si in enumerate(cfg.voxel_rcnn.scales):
            st = scales[si]
            lo, step = vq.geometry(cfg.voxel_size, cfg.grid_bounds, cfg.strides[si])
            want = vq.voxel_query_plain(vq.row_map(st.keys, st.mask, st.grid), st.grid, grid,
                                        lo, step, cfg.voxel_rcnn.query_range,
                                        cfg.voxel_rcnn.pool_radius[k], cfg.voxel_rcnn.nsample)
            assert torch.equal(out["rows"][k], want)
    assert float((out["rows"][1][..., 0] >= 0).float().mean()) > 0.5


# ------------------------------------------------------ conv epilogue (K4)

_EPILOGUE_LAYOUTS = {"dense": ((2, None, 5, 33, 41), 1), "rows": ((3, 1237, None), -1),
                     "columns": ((2, 301, 7, None), -1)}
_DT = {"bf16": torch.bfloat16, "f32": torch.float32}


def _epilogue_case(dev, layout, dtype, c, seed):
    """A conv output in ``layout`` (a channels-last-3d volume, (B, N, C) or
    (B, Ncol, D, C) rows; row counts 13,530, 3,711 and 4,214, none a
    multiple of a block's rows), half its sites masked off, and statistics
    whose weights are half negative, so that about half the active
    pre-activations are below 0."""
    rng = np.random.default_rng(seed)
    shape, channel_dim = _EPILOGUE_LAYOUTS[layout]
    shape = tuple(c if n is None else n for n in shape)
    x = torch.from_numpy(3 * rng.normal(size=shape).astype(np.float32)).to(dev, dtype)
    if layout == "dense":
        x = x.contiguous(memory_format=torch.channels_last_3d)
    site_shape = [n for i, n in enumerate(shape) if i != channel_dim % len(shape)]
    site = torch.from_numpy(rng.uniform(size=site_shape) < 0.5).to(dev)
    stats = [rng.normal(size=c), rng.uniform(0.05, 4, size=c), rng.normal(size=c),
             rng.normal(size=c)]
    return x, site, [torch.from_numpy(s.astype(np.float32)).to(dev) for s in stats], channel_dim


@pytest.mark.parametrize("c", [16, 64, 128])
@pytest.mark.parametrize("dtypes", [("bf16", "bf16"), ("f32", "bf16"), ("f32", "f32")])
@pytest.mark.parametrize("layout", list(_EPILOGUE_LAYOUTS))
def test_bn_relu_kernel_matches_plain(layout, dtypes, c, cuda_device):
    """K4 against ``bn_relu_plain`` on the same card tensors, bit for bit:
    written over its input where the dtypes agree, into a new tensor of the
    input's strides otherwise; one launch, on the input dtype's route."""
    from vision3d_tpu_torch.ops import bn_relu as ep

    din, dout = (_DT[d] for d in dtypes)
    x, site, stats, cd = _epilogue_case(cuda_device, layout, din, c, c + len(layout))
    want = ep.bn_relu_plain(x, site, *stats, 1e-3, cd, dout)
    counts = ("bn_relu", f"bn_relu.{dtypes[0]}")
    before = [ep.LAUNCHES[k] for k in counts]
    inp = x.clone(memory_format=torch.preserve_format)
    got = ep.bn_relu(inp, site, *stats, 1e-3, cd, dout)
    torch.cuda.synchronize()
    assert [ep.LAUNCHES[k] for k in counts] == [n + 1 for n in before]
    assert (got.data_ptr() == inp.data_ptr()) == (din == dout)
    assert got.dtype == dout and got.shape == x.shape and got.stride() == x.stride()
    bits = torch.int16 if dout == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
    active = site.unsqueeze(cd).expand_as(want)
    assert bool((want[~active] == 0).all())
    assert 0.2 < float((want[active] == 0).float().mean()) < 0.8   # ReLU cuts about half


def test_bn_relu_kernel_rejects_bad_input(cuda_device):
    from vision3d_tpu_torch.ops import bn_relu as ep

    x, site, stats, _ = _epilogue_case(cuda_device, "rows", torch.bfloat16, 16, 0)
    with pytest.raises(ValueError):     # 12 bf16 channels: no whole 16-byte load
        ep.bn_relu(x[..., :12].contiguous(), site, *[s[:12] for s in stats], 1e-3)
    with pytest.raises(ValueError):     # channels not last in memory
        ep.bn_relu(x.transpose(1, 2).contiguous(), site, *stats, 1e-3, 1)
    with pytest.raises(ValueError):
        ep.bn_relu(x, site[:, 1:], *stats, 1e-3)
    with pytest.raises(ValueError):
        ep.bn_relu(x, site, *[s.double() for s in stats], 1e-3)
    with pytest.raises(TypeError):
        ep.bn_relu(x.half(), site, *stats, 1e-3)
    with pytest.raises(RuntimeError):   # no backward
        ep.bn_relu(x.float().requires_grad_(), site, *stats, 1e-3)


def test_bn_relu_launches_per_forward_and_step(cuda_device):
    """K4 ends every conv of the middle extractor in inference: 14 launches
    a SECOND forward and a PV-RCNN forward (10 submanifold + 4 strided
    convs; float32 here, so all on the "f32" route), none in a training
    step, whose epilogue takes the batch's statistics in PyTorch."""
    from vision3d_tpu_torch import kernels
    from vision3d_tpu_torch.synthetic import kitti_like_train_batch
    from vision3d_tpu_torch.training.train import create_train_state, make_train_step

    launched, chip_smoke = _point_launches(cuda_device)
    assert {k: (v["bn_relu"], v["bn_relu.f32"], v["bn_relu.bf16"])
            for k, v in launched.items()} == {
        "pvrcnn2": (14, 14, 0), "pvrcnn_bev": (14, 14, 0), "second": (14, 14, 0)}
    cfg = chip_smoke.small_geometry_cfg()
    b = kitti_like_train_batch(1, 2, 60000, max_gt=8, cfg=cfg)
    b["points"], b["num_points"] = chip_smoke.crop_to_grid(cfg, b["points"])
    model, tx, state = create_train_state(cfg, steps_per_epoch=10, device=cuda_device)
    step = make_train_step(model, tx, cfg)
    kernels.reset_launches()
    state, losses = step(state, {k: torch.from_numpy(v).to(cuda_device) for k, v in b.items()})
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bn_relu"] == 0 and kernels.LAUNCHES["gather_gemm"] > 0
    assert all(np.isfinite(float(v)) for v in losses.values())
