"""The z-window conv's two routes, on the CPU.

On the card, ``zwin_conv`` picks its kernel with the rule of the rulebook
gather-GEMM (``ops.gather_gemm.route_of``). Its tensor-core route builds
each tile's 27-tap rulebook in shared memory from ``(start, pattern)`` and
then computes what ``sp.conv_rulebook_apply`` computes on that rulebook.
The helper ``tile_rows`` below builds the same rulebook in plain PyTorch,
so these tests hold that step (tap order k = dz*9 + j2, the ``row < N``
rule) against the plain z-window conv and against the TPU kernel B1
(``conv_zwin_apply_pallas2``, interpret mode, as its own tests run it).
The kernel itself is held against the plain version in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision3d_tpu.ops.pallas.zwin_conv import conv_zwin_apply_pallas2
from vision3d_tpu_torch.ops import sparse as tsp
from vision3d_tpu_torch.ops.gather_gemm import route_of

# (C, Cout) of the six z-window convs of one SECOND forward (stages 0-1)
PATH_WIDTHS = [(4, 16), (16, 16), (16, 32), (32, 32), (32, 32), (32, 64)]


def tile_rows(start, pattern, n):
    """What the "mma" kernel builds in shared memory: (B, M*27) int32, per
    site the row that tap k = dz*9 + j2 reads, -1 for a miss."""
    b = start.shape[0]
    rows = tsp.zwin_taps(start, pattern, n)                  # (B, M*9, dz)
    return rows.reshape(b, -1, 9, 3).transpose(2, 3).reshape(b, -1).to(torch.int32)


def _case(c, cout, seed, b=2, n=300, m=260):
    """Starts in [0, N], so windows run into the zero rows past N; weights
    with no symmetry between taps."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, n, c)).astype(np.float32)
    start = rng.integers(0, n + 1, (b, m * 9)).astype(np.int32)
    pattern = np.where(start == n, 0, rng.integers(0, 8, (b, m * 9))).astype(np.int32)
    w = rng.normal(size=(27 * c, cout)).astype(np.float32)
    return [torch.from_numpy(a) for a in (feats, start, pattern, w)]


def _rulebook_apply(feats, rows, w, dtype):
    """``conv_rulebook_apply`` on kernel rows: its plain version takes N,
    not -1, for a miss."""
    n = feats.shape[1]
    return tsp.conv_rulebook_apply(feats, torch.where(rows < 0, n, rows), w, dtype)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, {"mma": 5, "fma": 1}),
                                        (torch.float32, {"mma": 0, "fma": 6})])
def test_route_rule_on_the_forward(dtype, want):
    """A bf16 forward runs 5 launches on the tensor cores and s0 subm 4x16
    on FMA; float32 (the card-vs-CPU checks) runs all six on FMA."""
    routes = [route_of(dtype, c, cout) for c, cout in PATH_WIDTHS]
    assert {r: routes.count(r) for r in ("mma", "fma")} == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,cout", [(16, 16), (16, 32), (32, 64)])
def test_tile_rulebook_equals_zwin_conv(c, cout, dtype):
    """The rulebook form equals the plain z-window conv: the same gathered
    values in the same (dz, j2, c) column order through one product,
    exactly. Taps read past N (starts reach N) are misses."""
    feats, start, pattern, w = _case(c, cout, c + cout)
    n = feats.shape[1]
    rows = tile_rows(start, pattern, n)
    assert rows.shape == (2, 260 * 27) and int(rows.max()) < n
    assert bool((start + 2 >= n).any()) and bool((rows < 0).any())
    ref = tsp.conv_zwin_apply(feats, start, pattern, w, (3, 3, 3), dtype)
    assert torch.equal(_rulebook_apply(feats, rows, w, dtype), ref)


def test_tile_rulebook_tap_order_matters():
    """The rows in j2*3 + dz order (a swap of the two tap indices) give
    another result on these weights, so the test above pins k = dz*9 + j2."""
    feats, start, pattern, w = _case(16, 32, 5)
    n = feats.shape[1]
    swapped = tsp.zwin_taps(start, pattern, n).reshape(2, -1).to(torch.int32)
    ref = tsp.conv_zwin_apply(feats, start, pattern, w, (3, 3, 3))
    err = float((_rulebook_apply(feats, swapped, w, torch.float32) - ref).abs().max())
    assert err > 0.1 * float(ref.abs().max())


@pytest.mark.parametrize("c,cout", [(16, 32), (32, 64)])
def test_tile_rulebook_matches_pallas_kernel(c, cout):
    """The rulebook form, bf16 as on the tensor cores, against the TPU
    kernel B1 itself (interpret mode): the tolerance of
    tests/test_torch_zwin.py, 2e-2 of the scale."""
    feats, start, pattern, w = _case(c, cout, 9)
    ref = np.asarray(conv_zwin_apply_pallas2(
        jnp.asarray(feats.numpy()), jnp.asarray(start.numpy()),
        jnp.asarray(pattern.numpy()), jnp.asarray(w.numpy()), (3, 3, 3),
        block_sites=128))
    got = _rulebook_apply(feats, tile_rows(start, pattern, feats.shape[1]), w,
                          torch.bfloat16)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2 * scale, rtol=2e-2)
