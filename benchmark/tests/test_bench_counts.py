"""The benchmark's operation and byte counts against the port's
``chip_smoke.py`` bound arithmetic on the same rulebook."""

import math

import pytest
import torch

from harness import counts


def _chip_smoke():
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("b,n,m,c,cout,kd,hits", [(2, 1000, 900, 16, 32, 27, 5000),
                                                  (8, 60000, 64000, 32, 64, 27, 10 ** 6),
                                                  (1, 500, 500, 64, 64, 3, 1200)])
def test_gather_gemm_bound_equals_chip_smoke(b, n, m, c, cout, kd, hits):
    cs = _chip_smoke()
    want_ms, _ = cs.gather_gemm_bound_ms(b, n, m, c, cout, kd, hits, torch.bfloat16)
    nbytes = counts.conv_bytes(b * n, b * m, c, cout, kd, index_bytes=b * m * kd * counts.INDEX)
    got = counts.least_s(counts.conv_flops(c, cout, hits), nbytes)
    assert math.isclose(1e3 * got, want_ms, rel_tol=1e-12)


def test_zwin_bound_equals_chip_smoke():
    cs = _chip_smoke()
    from vision3d_tpu_torch.ops import sparse as sp

    gen = torch.Generator().manual_seed(0)
    b, n, m, c, cout = 2, 300, 280, 16, 32
    start = torch.randint(0, n + 5, (b, m * 9), generator=gen, dtype=torch.int32)
    pattern = torch.randint(0, 8, (b, m * 9), generator=gen, dtype=torch.int32)
    want_ms, _, taps = cs.zwin_bound_ms(b, n, c, cout, start, pattern, torch.bfloat16)
    assert taps == int((sp.zwin_taps(start, pattern, n) >= 0).sum())
    nbytes = counts.conv_bytes(b * n, b * m, c, cout, 27, index_bytes=2 * start.numel() * 4)
    got = counts.least_s(counts.conv_flops(c, cout, taps), nbytes)
    assert math.isclose(1e3 * got, want_ms, rel_tol=1e-12)


def test_train_flops_is_three_forwards_less_first_dx():
    uc = [dict(name="subm0", stage=0, n_in=10, n_out=10, cin=4, cout=16, kvol=27, hits=50),
          dict(name="down0", stage=0, n_in=10, n_out=6, cin=16, cout=32, kvol=27, hits=40),
          dict(name="rpn0", flops=1000)]
    fwd = 2 * 4 * 16 * 50 + 2 * 16 * 32 * 40 + 1000
    assert counts.forward_flops(uc) == fwd
    assert counts.train_flops(uc) == 3 * fwd - 2 * 4 * 16 * 50
