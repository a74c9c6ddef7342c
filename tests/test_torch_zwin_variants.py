"""The two z-window variants on gathered windows: the port's plain
versions of ``zwin_align_gemm_v1`` / ``_v3`` and their wrappers
``conv_zwin_apply_v1`` / ``_v3`` against the JAX package's Pallas kernels
``zwin_conv_gemm`` (v1) / ``zwin_conv_gemm_v3`` (interpret mode on the
CPU) and against the port's own ``conv_zwin_apply``. The CUDA kernels are
held against the plain versions in tests/test_torch_cuda.py.

Random rulebooks as in tests/test_pallas_kernels.py: starts in [0, N]
(so windows run into the zero rows past N) and random 3-bit patterns.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision3d_tpu.ops.pallas import zwin_conv as jzw
from vision3d_tpu_torch.ops import sparse as tsp
from vision3d_tpu_torch.ops import zwin_conv as tzw

K3 = (3, 3, 3)
V1_SHAPES = [(16, 16), (16, 32)]            # tests/test_pallas_kernels.py:62
V3_SHAPES = [(4, 16), (32, 32), (64, 64)]   # tests/test_pallas_kernels.py:24


def _case(c, cout, seed=0, b=2, n=300, m=260):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, n, c)).astype(np.float32)
    start = rng.integers(0, n + 1, (b, m * 9)).astype(np.int32)
    pattern = np.where(start == n, 0, rng.integers(0, 8, (b, m * 9))).astype(np.int32)
    w = rng.normal(size=(27 * c, cout)).astype(np.float32)
    return feats, start, pattern, w


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, ref, tol):
    ref = np.asarray(ref)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("c,cout", V1_SHAPES)
def test_apply_v1_matches_pallas(c, cout):
    """Wrapper against ``conv_zwin_apply_pallas``, bf16 as the TPU kernel
    computes: the tolerance of tests/test_pallas_kernels.py, 2e-2 of the
    scale."""
    case = _case(c, cout)
    ref = jzw.conv_zwin_apply_pallas(*[jnp.asarray(a) for a in case], K3)
    _close(tzw.conv_zwin_apply_v1(*_torch(*case), K3, torch.bfloat16), ref, 2e-2)


@pytest.mark.parametrize("c,cout", V3_SHAPES)
def test_apply_v3_matches_pallas(c, cout):
    case = _case(c, cout, seed=1)
    ref = jzw.conv_zwin_apply_pallas3(*[jnp.asarray(a) for a in case], K3,
                                      block_sites=128)
    _close(tzw.conv_zwin_apply_v3(*_torch(*case), K3, torch.bfloat16), ref, 2e-2)


@pytest.mark.parametrize("variant", ["v1", "v3"])
def test_bare_plain_matches_pallas_on_same_windows(variant):
    """The bare functions on the same gathered windows and masks, which the
    port builds (and which must then be what the JAX wrappers build)."""
    c, cout = 16, 32
    feats, start, pattern, w = _torch(*_case(c, cout, seed=2))
    m = start.shape[1] // 9
    g_km = tzw.gather_windows_km(feats, start, torch.bfloat16)
    jg = jnp.asarray(g_km.float().numpy(), jnp.bfloat16)
    if variant == "v1":
        masks = tzw.pair_masks(pattern, m, torch.bfloat16)
        assert tuple(masks.shape) == (2, 9, m, 6)
        ref = jzw.zwin_conv_gemm(jg, jnp.asarray(masks.float().numpy(), jnp.bfloat16),
                                 jnp.asarray(w.numpy()), K3)
        got = tzw.zwin_align_gemm_v1_plain(g_km, masks, w)
    else:
        masks = tzw.shift_masks(pattern, m, torch.bfloat16)
        assert tuple(masks.shape) == (3, 2, m, 27)
        ref = jzw.zwin_conv_gemm_v3(jg, jnp.asarray(masks.float().numpy(), jnp.bfloat16),
                                    jnp.asarray(w.numpy()), K3, block_sites=128)
        got = tzw.zwin_align_gemm_v3_plain(g_km, masks, w)
    _close(got, ref, 2e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("fn", ["conv_zwin_apply_v1", "conv_zwin_apply_v3"])
@pytest.mark.parametrize("c,cout", [(4, 16), (32, 64)])
def test_variants_match_port_zwin(c, cout, fn, dtype, tol):
    """All three variants compute one function: exact products of
    compute-dtype inputs summed in float32 in other orders, 1e-5 of the
    output scale."""
    feats, start, pattern, w = _torch(*_case(c, cout, seed=3))
    ref = tsp.conv_zwin_apply(feats, start, pattern, w, K3, dtype)
    _close(getattr(tzw, fn)(feats, start, pattern, w, K3, dtype), ref.numpy(), tol)


def test_wrappers_cpu_run_plain_versions_without_launch():
    feats, start, pattern, w = _torch(*_case(16, 16, seed=4))
    before = dict(tzw.LAUNCHES)
    g_km = tzw.gather_windows_km(feats, start, torch.float32)
    m = start.shape[1] // 9
    for fn, plain, masks in (
            (tzw.zwin_align_gemm_v1, tzw.zwin_align_gemm_v1_plain,
             tzw.pair_masks(pattern, m, torch.float32)),
            (tzw.zwin_align_gemm_v3, tzw.zwin_align_gemm_v3_plain,
             tzw.shift_masks(pattern, m, torch.float32))):
        assert torch.equal(fn(g_km, masks, w), plain(g_km, masks, w))
    assert dict(tzw.LAUNCHES) == before


def test_wrappers_reject_bad_input():
    feats, start, pattern, w = _torch(*_case(4, 16))
    with pytest.raises(ValueError):
        tzw.conv_zwin_apply_v1(feats, start, pattern, w, (3, 1, 1))
    with pytest.raises(TypeError):
        tzw.conv_zwin_apply_v3(feats, start, pattern, w, K3, torch.float16)
    with pytest.raises(ValueError):
        tzw.conv_zwin_apply_v3(feats, start, pattern[:, :-9], w)
    g_km = tzw.gather_windows_km(feats, start, torch.float32).to("meta")
    with pytest.raises(ValueError):
        tzw.zwin_align_gemm_v1(g_km, g_km, w.to("meta"))
