"""PyTorch port vs the JAX package: the training path's sparse ops. Full-tap
rulebooks and transpose rulebooks (integers, exactly equal), the rulebook
conv against JAX's and against the TPU kernels run in interpret mode, the
row gather, the conv-as-backward autograd functions against ``jax.grad`` of
the custom VJPs, and the plan's column caps under overflow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision3d_tpu.ops import sparse as jsp
from vision3d_tpu.ops.pallas.gather import gather_rows as j_gather_rows
from vision3d_tpu.ops.pallas.sparse_conv import fused_gather_gemm
from vision3d_tpu_torch.ops import sparse as tsp
from vision3d_tpu_torch.ops.gather_gemm import gather_gemm, route_of
from vision3d_tpu_torch.ops.gather_rows import gather_rows

from test_torch_sparse import STAGES, _tiny_sparse
from torch_parity import sorted_key_sets

K3 = (3, 3, 3)


def _t(x):
    return torch.from_numpy(np.array(x))


def _compare_train_plan(keys, mask, grid, spec, out_cap, subm):
    k, s, p = spec
    ref = jax.jit(lambda kk, mm: jsp.plan_stage_train_batched(
        kk, mm, grid, k, s, p, out_cap, subm_kernel=subm))(
        jnp.asarray(keys), jnp.asarray(mask))
    got = tsp.plan_stage_train_batched(_t(keys), _t(mask), grid, k, s, p,
                                       out_cap, subm_kernel=subm)
    assert (got[0] is None) == (ref[0] is None) == (subm is None)
    for r, g in zip(ref, got):
        if r is not None:
            assert g.dtype in (torch.int32, torch.bool)
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    return got


def test_train_plan_tiny_z_chain(tiny_cfg):
    """The 41 -> 21 -> 11 -> 5 -> 2 chain on JAX's compact-column branch
    (every grid has D <= 48); stage 2 is the k3s2p0 clamp and stage 3 the
    (3, 1, 1) kernel, K = 3."""
    feats, coords, mask = _tiny_sparse(tiny_cfg)
    grid = tiny_cfg.grid_shape_zyx
    _, keys, mask = jax.vmap(lambda f, c, m: jsp.make_sorted(f, c, m, grid))(
        feats, coords, mask)
    keys, mask = np.asarray(keys), np.asarray(mask)
    for si, spec in enumerate(STAGES):
        got = _compare_train_plan(keys, mask, grid, spec,
                                  tiny_cfg.stage_voxel_capacity(si + 1), K3)
        assert int(got[5].sum()) == 0
        n, m = keys.shape[1], got[3].shape[1]
        kd = int(np.prod(spec[0]))
        assert got[1].shape[1] == m * kd and got[2].shape[1] == n * kd
        assert int((got[1] < n).sum()) > 0 and int((got[2] < m).sum()) > 0
        keys, mask = got[3].numpy(), got[4].numpy()
        grid = tsp.out_grid_shape(grid, *spec)
    assert grid[0] == 2


@pytest.mark.parametrize("grid,subm", [((21, 32, 32), K3),     # compact branch
                                       ((60, 24, 20), K3),     # D > 48: dense table
                                       ((60, 24, 20), None)])
def test_train_plan_truncation_both_jax_branches(grid, subm):
    """out_cap below the dilated active set, so outputs are dropped and
    the transpose rulebook meets inactive outputs, on both JAX lookup
    branches."""
    rng = np.random.default_rng(4)
    keys, mask = sorted_key_sets(rng, grid, 3, 700, 450, 690)
    got = _compare_train_plan(keys, mask, grid, STAGES[1], 300, subm)
    assert (got[5].numpy() > 0).all()


def test_train_plan_311_stage():
    rng = np.random.default_rng(5)
    keys, mask = sorted_key_sets(rng, (5, 20, 18), 2, 400, 250, 390)
    got = _compare_train_plan(keys, mask, (5, 20, 18), STAGES[3], 500, K3)
    assert got[1].shape[1] == 500 * 3


def test_plan_column_cap_overflow():
    """Step 0: on JAX's huge-BEV branch, column caps small enough to
    overflow: sites of columns beyond the cap get empty windows and the
    dropped columns are counted, bit for bit as the JAX plan."""
    grid = (41, 1000, 1010)
    assert grid[1] * grid[2] > jsp.DENSE_SHIFT_MAX_BEV_CELLS
    assert tsp.DENSE_SHIFT_MAX_BEV_CELLS == jsp.DENSE_SHIFT_MAX_BEV_CELLS
    rng = np.random.default_rng(7)
    d, h, w = grid
    keys, mask = [], []
    n = 1600
    for nact in (1200, 1550):
        cy = rng.integers(100, 140, nact)
        cx = rng.integers(500, 540, nact)
        z = rng.integers(0, d, nact)
        k = np.unique((cy * w + cx) * d + z).astype(np.int32)
        keys.append(np.concatenate([k, np.full(n - len(k), d * h * w, np.int32)]))
        mask.append(np.arange(n) < len(k))
    keys, mask = np.stack(keys), np.stack(mask)
    k, s, p = STAGES[0]
    caps = dict(subm_col_cap=300, down_col_cap=150)
    ref = jax.jit(lambda kk, mm: jsp.plan_stage_batched(
        kk, mm, grid, k, s, p, 4000, subm_kernel=K3, **caps))(
        jnp.asarray(keys), jnp.asarray(mask))
    got = tsp.plan_stage_batched(_t(keys), _t(mask), grid, k, s, p, 4000,
                                 subm_kernel=K3, **caps)
    uncapped = tsp.plan_stage_batched(_t(keys), _t(mask), grid, k, s, p, 4000,
                                      subm_kernel=K3)
    for r, g in zip(ref[0] + ref[1] + ref[2:], got[0] + got[1] + got[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert (got[4].numpy() > 0).all() and int(uncapped[4].sum()) == 0
    assert not torch.equal(got[0][1], uncapped[0][1])
    assert not torch.equal(got[1][1], uncapped[1][1])


def test_plan_ignores_column_caps_off_the_huge_bev_branch():
    """The dense-shift branch (BEV <= DENSE_SHIFT_MAX_BEV_CELLS) ignores
    the caps in the JAX plan; so does the port."""
    rng = np.random.default_rng(8)
    grid = (21, 32, 32)
    keys, mask = sorted_key_sets(rng, grid, 2, 500, 300, 480)
    k, s, p = STAGES[1]
    ref = jax.jit(lambda kk, mm: jsp.plan_stage_batched(
        kk, mm, grid, k, s, p, 900, subm_kernel=K3, subm_col_cap=10,
        down_col_cap=10))(jnp.asarray(keys), jnp.asarray(mask))
    got = tsp.plan_stage_batched(_t(keys), _t(mask), grid, k, s, p, 900,
                                 subm_kernel=K3, subm_col_cap=10, down_col_cap=10)
    for r, g in zip(ref[0] + ref[1] + ref[2:], got[0] + got[1] + got[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _conv_case(seed, c, cout, kd=27, b=2, n=150, m=170):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, n, c)).astype(np.float32)
    rb = rng.integers(0, n + 1, (b, m * kd)).astype(np.int32)
    rb[rng.uniform(size=rb.shape) < 0.6] = n          # most taps miss
    w = (rng.normal(size=(kd * c, cout)) / np.sqrt(kd * c)).astype(np.float32)
    return feats, rb, w


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("c,cout,kd", [(4, 16, 27), (16, 32, 27), (64, 64, 3)])
def test_conv_rulebook_apply_matches_jax(c, cout, kd, dtype, tol):
    """f32: both sum the same products in other orders, 1e-5 of the scale.
    bf16: inputs rounded alike, f32 sums; held at the Pallas tests' bf16
    tolerance, 2e-2."""
    feats, rb, w = _conv_case(c + kd, c, cout, kd)
    ref = np.asarray(jsp.conv_rulebook_apply(
        jnp.asarray(feats), jnp.asarray(rb), jnp.asarray(w),
        compute_dtype=getattr(jnp, dtype)), np.float32)
    got = gather_gemm(_t(feats), _t(rb), _t(w), getattr(torch, dtype))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("dtype,c,cout,route", [
    (torch.bfloat16, 16, 16, "mma"), (torch.bfloat16, 64, 128, "mma"),
    (torch.bfloat16, 128, 8, "mma"), (torch.bfloat16, 4, 16, "fma"),
    (torch.bfloat16, 16, 4, "fma"), (torch.bfloat16, 24, 16, "fma"),
    (torch.float32, 64, 64, "fma"), (torch.float32, 16, 16, "fma")])
def test_gather_gemm_route_rule(dtype, c, cout, route):
    """The card's kernel for a call follows from (dtype, C, Cout) alone:
    tensor cores for bf16 with C % 16 == 0 and Cout % 8 == 0, FMA else."""
    assert route_of(dtype, c, cout) == route


def test_conv_rulebook_apply_matches_tpu_kernel_interpreted():
    """The plain version against the TPU kernel B2 itself (interpret mode)
    on its own contract: one flat table whose last row is the zero row.
    The interpreted kernel agrees with take + dot to 3e-5; same bound."""
    feats, rb, w = _conv_case(11, 16, 32, b=1)
    n = feats.shape[1]
    table = np.concatenate([feats[0], np.zeros((1, 16), np.float32)])
    ref = np.asarray(fused_gather_gemm(jnp.asarray(table),
                                       jnp.asarray(rb.reshape(-1, 27)),
                                       jnp.asarray(w), interpret=True))
    got = tsp.conv_rulebook_apply(_t(feats), _t(rb), _t(w))[0]
    assert rb.max() == n
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-5 * float(np.abs(ref).max()),
                               rtol=3e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [4, 64])
def test_gather_rows_matches_tpu_kernels(c, dtype):
    """Exactly equal to B4 (``gather_rows``, interpret mode) and to
    ``jnp.take``, the function of B5 (``dma_gather_rows`` has no interpret
    switch); Q is no multiple of any tile."""
    rng = np.random.default_rng(c)
    table = rng.normal(size=(300, c)).astype(np.float32)
    idx = rng.integers(0, 300, (1001,)).astype(np.int32)
    jt = jnp.asarray(table).astype(getattr(jnp, dtype))
    tt = _t(table).to(getattr(torch, dtype))
    got = gather_rows(tt, _t(idx))
    assert got.dtype == tt.dtype and tuple(got.shape) == (1001, c)
    take = np.asarray(jnp.take(jt, jnp.asarray(idx), axis=0).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), take)
    if dtype == "float32":   # the interpreted TPU kernel, f32 as its tests run it
        ref = np.asarray(j_gather_rows(jt, jnp.asarray(idx), tile=256, interpret=True))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_flip_transpose_weight_equal():
    w = np.random.default_rng(0).normal(size=(27 * 8, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        tsp.flip_transpose_weight(_t(w), 8).numpy(),
        np.asarray(jsp._flip_transpose_weight(jnp.asarray(w), 8)))


def _real_plan(seed, spec, grid=(11, 20, 18)):
    keys, mask = sorted_key_sets(np.random.default_rng(seed), grid, 2, 400, 250, 390)
    k, s, p = spec
    return (keys, mask) + tuple(tsp.plan_stage_train_batched(
        _t(keys), _t(mask), grid, k, s, p, 600, subm_kernel=K3))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_subm_conv_fn_gradients_match_jax(dtype, tol):
    """dX and dW of SubmConvFn against jax.grad of make_subm_conv_vjp on a
    real submanifold rulebook: 1e-4 of each tensor's max in f32 (sums in
    other orders); bf16 rounds g and the inputs alike, 2e-2."""
    keys, mask, rbs = _real_plan(3, STAGES[2])[:3]
    rng = np.random.default_rng(1)
    c, cout = 8, 16
    x = rng.normal(size=(2, 400, c)).astype(np.float32) * mask[..., None]
    w = (rng.normal(size=(27 * c, cout)) / 10).astype(np.float32)
    r = rng.normal(size=(2, 400, cout)).astype(np.float32)
    f = jsp.make_subm_conv_vjp(getattr(jnp, dtype))
    jrb = jnp.asarray(rbs.numpy())
    gx, gw = jax.grad(lambda a, b: (f(a, jrb, b) * jnp.asarray(r)).sum(),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = _t(x).requires_grad_()
    tw = _t(w).requires_grad_()
    (tsp.SubmConvFn.apply(tx, rbs, tw, getattr(torch, dtype)) * _t(r)).sum().backward()
    for got, ref in ((tx.grad, gx), (tw.grad, gw)):
        ref = np.asarray(ref)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=tol * float(np.abs(ref).max()),
                                   rtol=tol)


@pytest.mark.parametrize("spec", [STAGES[2], STAGES[3]])
def test_down_conv_fn_gradients_match_jax(spec):
    """DownConvFn (dX over the transpose rulebook) on the k3s2p0 stage and
    on the (3, 1, 1) stage, f32, 1e-4 of each tensor's max; and the first
    conv's case: no dX when the input needs no gradient."""
    keys, mask, _, rbd, rbt, ok, om, _ = _real_plan(6, spec)
    rng = np.random.default_rng(2)
    c, cout, kd = 8, 16, int(np.prod(spec[0]))
    x = rng.normal(size=(2, 400, c)).astype(np.float32) * mask[..., None]
    w = (rng.normal(size=(kd * c, cout)) / 10).astype(np.float32)
    r = rng.normal(size=(2, 600, cout)).astype(np.float32)
    f = jsp.make_down_conv_vjp(jnp.float32)
    jrb, jrbt = jnp.asarray(rbd.numpy()), jnp.asarray(rbt.numpy())
    gx, gw = jax.grad(lambda a, b: (f(a, jrb, jrbt, b) * jnp.asarray(r)).sum(),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = _t(x).requires_grad_()
    tw = _t(w).requires_grad_()
    (tsp.DownConvFn.apply(tx, rbd, rbt, tw, torch.float32) * _t(r)).sum().backward()
    for got, ref in ((tx.grad, gx), (tw.grad, gw)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * float(np.abs(ref).max()),
                                   rtol=1e-4)
    tw2 = _t(w).requires_grad_()
    x2 = _t(x)
    (tsp.DownConvFn.apply(x2, rbd, rbt, tw2, torch.float32) * _t(r)).sum().backward()
    assert x2.grad is None
    np.testing.assert_array_equal(tw2.grad.numpy(), tw.grad.numpy())


def test_to_dense_matches_jax_and_backward_is_a_gather():
    grid = (3, 6, 5)
    keys, mask = sorted_key_sets(np.random.default_rng(3), grid, 2, 40, 20, 38)
    feats = np.random.default_rng(4).normal(size=(2, 40, 4)).astype(np.float32)
    ref = jax.vmap(lambda f, k, m: jsp.to_dense(f, k, m, grid))(
        jnp.asarray(feats), jnp.asarray(keys), jnp.asarray(mask))
    tf = _t(feats).requires_grad_()
    got = tsp.to_dense(tf, _t(keys), _t(mask), grid)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    up = torch.from_numpy(np.random.default_rng(5).normal(size=got.shape).astype(np.float32))
    (got * up).sum().backward()
    coords = tsp.keys_to_coords(_t(keys).long(), grid)
    for b in range(2):
        for i in range(40):
            z, y, x = coords[b, i].tolist()
            want = up[b, z, y, x] if mask[b, i] else torch.zeros(4)
            torch.testing.assert_close(tf.grad[b, i], want)
