"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one. This
file imports nothing of JAX, so it also runs on a GPU host without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from vision3d_tpu_torch.ops import sparse as tsp
from vision3d_tpu_torch.ops import zwin_conv as tzw

pytestmark = pytest.mark.cuda
COUT = {4: 16, 16: 32, 32: 64}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(c, seed, dev, b=2, n=300, m=1000):
    """Random rulebook as in tests/test_pallas_kernels.py: starts in
    [0, N], so windows reach the zero rows past N."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, n, c)).astype(np.float32)
    start = rng.integers(0, n + 1, (b, m * 9)).astype(np.int32)
    pattern = np.where(start == n, 0, rng.integers(0, 8, (b, m * 9))).astype(np.int32)
    w = rng.normal(size=(27 * c, COUT[c])).astype(np.float32)
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
