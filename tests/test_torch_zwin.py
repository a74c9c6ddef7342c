"""The z-window sparse conv: the port's plain version against the JAX
package's XLA version (``sp.conv_zwin_apply``) and its Pallas kernel
(``conv_zwin_apply_pallas2``, interpret mode on the CPU). The CUDA
kernel is held against the plain version in tests/test_torch_cuda.py.

Random rulebooks as in tests/test_pallas_kernels.py: starts in [0, N]
(so windows run into the zero rows past N) and random 3-bit patterns.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision3d_tpu.ops import sparse as jsp
from vision3d_tpu.ops.pallas.zwin_conv import conv_zwin_apply_pallas2
from vision3d_tpu_torch.ops import sparse as tsp
from vision3d_tpu_torch.ops import zwin_conv as tzw

COUT = {4: 16, 16: 32, 32: 64}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(c, seed=0, b=2, n=300, m=260):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, n, c)).astype(np.float32)
    start = rng.integers(0, n + 1, (b, m * 9)).astype(np.int32)
    pattern = np.where(start == n, 0, rng.integers(0, 8, (b, m * 9))).astype(np.int32)
    w = rng.normal(size=(27 * c, COUT[c])).astype(np.float32)
    return feats, start, pattern, w


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [4, 16, 32])
def test_plain_matches_jax_xla(c, dtype):
    """Both round inputs to the compute dtype and sum exact products in
    float32, in different orders: 1e-5 of the output scale."""
    jdt, tdt = DTYPES[dtype]
    feats, start, pattern, w = _case(c)
    ref = np.asarray(jsp.conv_zwin_apply(jnp.asarray(feats), jnp.asarray(start),
                                         jnp.asarray(pattern), jnp.asarray(w),
                                         (3, 3, 3), compute_dtype=jdt))
    got = tsp.conv_zwin_apply(*_torch(feats, start, pattern, w), (3, 3, 3), tdt)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * scale, rtol=1e-5)


@pytest.mark.parametrize("c", [4, 16, 32])
def test_plain_matches_pallas_kernel(c):
    """The TPU kernel B1 itself (interpret mode), bf16 as in production.
    The tolerance of tests/test_pallas_kernels.py: 2e-2 of the scale."""
    feats, start, pattern, w = _case(c, seed=1)
    ref = np.asarray(conv_zwin_apply_pallas2(
        jnp.asarray(feats), jnp.asarray(start), jnp.asarray(pattern),
        jnp.asarray(w), (3, 3, 3), block_sites=128))
    got = tsp.conv_zwin_apply(*_torch(feats, start, pattern, w), (3, 3, 3),
                              torch.bfloat16)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2 * scale, rtol=2e-2)


def test_wrapper_cpu_runs_plain_version_without_launch():
    feats, start, pattern, w = _torch(*_case(16, seed=2))
    before = tzw.LAUNCHES["zwin_conv"]
    got = tzw.zwin_conv(feats, start, pattern, w, (3, 3, 3), torch.bfloat16)
    ref = tsp.conv_zwin_apply(feats, start, pattern, w, (3, 3, 3), torch.bfloat16)
    assert torch.equal(got, ref)
    assert tzw.LAUNCHES["zwin_conv"] == before


def test_wrapper_rejects_other_devices():
    feats, start, pattern, w = (t.to("meta") for t in _torch(*_case(4)))
    with pytest.raises(ValueError):
        tzw.zwin_conv(feats, start, pattern, w)
