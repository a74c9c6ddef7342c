"""The two routes of the z-window kernels on gathered windows (B6
``zwin_align_gemm_v1``, B7 ``zwin_align_gemm_v3``), on the CPU.

On the card both pick their kernel with the rule of the rulebook
gather-GEMM (``ops.gather_gemm.route_of``). Their tensor-core route reads
``g_km`` (B, 9, M, 3*C) as one flat table of C-wide rows (candidate j of
window (b, k2, m) is row ((b*9 + k2)*M + m)*3 + j), builds each tile's
27-tap rulebook from the masks in shared memory (tap k = dz*9 + k2 reads
the first candidate that the masks route to it), and then computes what
``sp.conv_rulebook_apply`` computes on that rulebook; where masks route a
second or third candidate to one tap, the tile runs again on those and
adds. The helper ``align_tile_rows`` below builds the same rulebooks in
plain PyTorch, so these tests hold that step (the row numbering, the tap
order, the passes) against the plain versions and against the TPU kernels
``zwin_conv_gemm`` / ``zwin_conv_gemm_v3`` (interpret mode, as
tests/test_pallas_kernels.py runs them). The kernels themselves are held
against the plain versions in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision3d_tpu.ops.pallas import zwin_conv as jzw
from vision3d_tpu_torch.ops import sparse as tsp
from vision3d_tpu_torch.ops import zwin_conv as tzw
from vision3d_tpu_torch.ops.gather_gemm import route_of

K3 = (3, 3, 3)
# (C, Cout) of the six z-window convs of one SECOND forward (stages 0-1)
PATH_WIDTHS = [(4, 16), (16, 16), (16, 32), (32, 32), (32, 32), (32, 64)]
PLAIN = {"v1": tzw.zwin_align_gemm_v1_plain, "v3": tzw.zwin_align_gemm_v3_plain}


def _candidates(masks, variant, m):
    """cand[dz][j]: (B, 9, M) bool, the masks route candidate j to tap dz."""
    if variant == "v1":
        on = masks != 0                                            # (B, 9, M, 6)
        return [[on[..., tzw.PAIRS.index((dz, j))] for j in range(dz + 1)]
                for dz in range(3)]
    b = masks.shape[1]
    on = (masks != 0).reshape(3, b, m, 9, 3).transpose(2, 3)       # (s, B, 9, M, j)
    return [[on[dz - j, ..., j] for j in range(dz + 1)] for dz in range(3)]


def align_tile_rows(masks, variant, m):
    """What the "mma" kernel builds in shared memory, one rulebook per
    pass: (passes, B*M*27) int32, per flattened site b*M + m the row of the
    flat window table that tap k = dz*9 + k2 reads in pass p (the p-th
    candidate the masks route to it, in j order), -1 for none. A pass past
    the first exists only where some (site, k2, dz) has that many
    candidates."""
    cand = _candidates(masks, variant, m)
    b = cand[0][0].shape[0]
    win = torch.arange(b * 9 * m, dtype=torch.int64).reshape(b, 9, m)
    passes = []
    for p in range(3):
        rows = torch.full((b, 9, m, 3), -1, dtype=torch.int64)
        for dz in range(3):
            seen = torch.zeros((b, 9, m), dtype=torch.int64)
            for j in range(dz + 1):
                hit = cand[dz][j] & (seen == p)
                rows[..., dz] = torch.where(hit, win * 3 + j, rows[..., dz])
                seen = seen + cand[dz][j].long()
        passes.append(rows.permute(0, 2, 3, 1).reshape(-1))       # (B, M, dz, k2)
    rows = torch.stack(passes)
    n = 1 + int((rows[1:] >= 0).any(dim=1).sum())
    return rows[:n].to(torch.int32)


def table_apply(g_km, rows, w):
    """``conv_rulebook_apply`` of each pass's rulebook on the flat window
    table (one frame of B*9*M*3 rows; a miss is that count), summed."""
    b, _, m, kzc = g_km.shape
    table = g_km.reshape(1, -1, kzc // 3)
    n = table.shape[1]
    out = 0.0
    for r in rows:
        rb = torch.where(r < 0, n, r)[None]
        out = out + tsp.conv_rulebook_apply(table, rb, w, g_km.dtype)
    return out.reshape(b, m, -1)


def _case(c, cout, seed, dtype, b=2, n=300, m=260):
    """Windows and masks of a random rulebook (starts in [0, N], so windows
    reach the zero rows past N), weights with no symmetry between taps."""
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32))
    start = torch.from_numpy(rng.integers(0, n + 1, (b, m * 9)).astype(np.int32))
    pattern = torch.from_numpy(np.where(start.numpy() == n, 0, rng.integers(
        0, 8, (b, m * 9))).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=(27 * c, cout)).astype(np.float32))
    g_km = tzw.gather_windows_km(feats, start, dtype)
    masks = {"v1": tzw.pair_masks(pattern, m, dtype),
             "v3": tzw.shift_masks(pattern, m, dtype)}
    return g_km, masks, w


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    assert tuple(got.shape) == ref.shape
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), ref, atol=tol * scale, rtol=tol)


def _pallas(variant, g_km, masks, w):
    jg = jnp.asarray(g_km.float().numpy(), jnp.bfloat16)
    jm = jnp.asarray(masks.float().numpy(), jnp.bfloat16)
    if variant == "v1":
        return jzw.zwin_conv_gemm(jg, jm, jnp.asarray(w.numpy()), K3)
    return jzw.zwin_conv_gemm_v3(jg, jm, jnp.asarray(w.numpy()), K3, block_sites=128)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, {"mma": 5, "fma": 1}),
                                        (torch.float32, {"mma": 0, "fma": 6})])
def test_route_rule_on_the_forward(dtype, want):
    """Over the forward's six z-window layers a bf16 run of either variant
    takes the tensor cores 5 times and FMA for s0 subm 4x16; float32 (the
    card-vs-CPU checks) takes FMA all six times. Every Cout is one the
    kernels take."""
    routes = [route_of(dtype, c, cout) for c, cout in PATH_WIDTHS]
    assert {r: routes.count(r) for r in ("mma", "fma")} == want
    assert all(cout in tzw._ALIGN_COUTS for _, cout in PATH_WIDTHS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,cout", [(16, 16), (16, 32), (32, 64)])
@pytest.mark.parametrize("variant", ["v1", "v3"])
def test_tile_rows_equal_plain(variant, c, cout, dtype):
    """On masks from a rulebook's patterns the tile rulebook has one pass,
    reads no row twice, and equals the plain version: exact products of
    the same values summed in float32 in another order, 1e-5 of the
    scale."""
    g_km, masks, w = _case(c, cout, c + cout, dtype)
    rows = align_tile_rows(masks[variant], variant, 260)
    assert rows.shape == (1, 2 * 260 * 27)
    hit = rows[rows >= 0]
    assert hit.numel() == hit.unique().numel() > 0
    assert int(hit.max()) < 2 * 9 * 260 * 3
    got = table_apply(g_km, rows, w)
    _close(got, PLAIN[variant](g_km, masks[variant], w), 1e-5)


@pytest.mark.parametrize("c,cout", [(16, 32), (32, 64)])
@pytest.mark.parametrize("variant", ["v1", "v3"])
def test_tile_rows_match_pallas_kernel(variant, c, cout):
    """The rulebook form in bf16, as on the tensor cores, against the TPU
    kernel itself on the same windows and masks: the tolerance of
    tests/test_pallas_kernels.py, 2e-2 of the scale."""
    g_km, masks, w = _case(c, cout, 9, torch.bfloat16)
    got = table_apply(g_km, align_tile_rows(masks[variant], variant, 260), w)
    _close(got, _pallas(variant, g_km, masks[variant], w), 2e-2)


@pytest.mark.parametrize("variant", ["v1", "v3"])
def test_tile_rows_tap_order_matters(variant):
    """The taps in k2*3 + dz order (the two tap indices swapped) give
    another result on these weights, so the test above pins k = dz*9 +
    k2."""
    g_km, masks, w = _case(16, 32, 5, torch.float32)
    rows = align_tile_rows(masks[variant], variant, 260)
    swapped = rows.reshape(1, -1, 3, 9).transpose(2, 3).reshape(1, -1)
    ref = PLAIN[variant](g_km, masks[variant], w)
    err = float((table_apply(g_km, swapped, w) - ref).abs().max())
    assert err > 0.1 * float(ref.abs().max())


def _extra_masks(kind, variant, masks, seed):
    """Masks that route more than one candidate to a tap. doubled: tap
    dz = 1 of every window takes candidates 0 and 1 (2 passes); tripled:
    every candidate j <= dz goes to every tap dz (3 passes); random: each
    entry set with probability 1/2 (3 passes), including v3 entries that
    name no tap (j + s > 2), which every version ignores."""
    out = masks.clone()
    if kind == "random":
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.integers(0, 2, masks.shape).astype(np.float32)).to(
            masks.dtype)
    pairs = [(1, 0), (1, 1)] if kind == "doubled" else tzw.PAIRS
    for dz, j in pairs:
        if variant == "v1":
            out[..., tzw.PAIRS.index((dz, j))] = 1
        else:
            out.view(3, *out.shape[1:3], 9, 3)[dz - j, ..., j] = 1
    return out


@pytest.mark.parametrize("kind,passes", [("doubled", 2), ("tripled", 3), ("random", 3)])
@pytest.mark.parametrize("variant", ["v1", "v3"])
def test_tile_rows_sum_every_routed_candidate(variant, kind, passes):
    """Masks that route two or three candidates to one (site, k2, dz):
    the function, the plain versions and the TPU kernels sum every one, and
    so do the tile rulebook's passes. In float32 against the plain version
    to 1e-5 of the scale; in bf16 against the TPU kernel to 2e-2 (v1 rounds
    the sum of a tap's candidates to bf16 before its product)."""
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        g_km, masks, w = _case(16, 32, 11, dtype)
        extra = _extra_masks(kind, variant, masks[variant], 12)
        rows = align_tile_rows(extra, variant, 260)
        assert rows.shape[0] == passes
        got = table_apply(g_km, rows, w)
        if dtype == torch.float32:
            _close(got, PLAIN[variant](g_km, extra, w), tol)
            first = table_apply(g_km, rows[:1], w)
            assert float((first - got).abs().max()) > 0.1 * float(got.abs().max())
        else:
            _close(got, _pallas(variant, g_km, extra, w), tol)
