"""PyTorch port vs the JAX package: key-sorted sparse tensors, stage
plans (active sets + z-window rulebooks), densify, dense stage ops and
the BEV collapse. All integer outputs must be exactly equal."""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision3d_tpu.core.voxelize import mean_vfe as j_mean_vfe
from vision3d_tpu.core.voxelize import voxelize_batch as j_voxelize_batch
from vision3d_tpu.models import sparse_cnn as jscnn
from vision3d_tpu.ops import sparse as jsp
from vision3d_tpu_torch.models import sparse_cnn as tscnn
from vision3d_tpu_torch.ops import sparse as tsp

from torch_parity import port_cfg, sorted_key_sets, uniform_points

STAGES = [  # SpMiddleFHD's strided convs: kernel, stride, pad
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (0, 1, 1)),   # k3s2p0 in z: the pad clamp
    ((3, 1, 1), (2, 1, 1), (0, 0, 0)),
]


def _t(x):
    return torch.from_numpy(np.array(x))


def _tiny_sparse(tiny_cfg, n_points=420, seed=0):
    """Voxelizer output of the tiny config, key-sorted (JAX side)."""
    pts, num = uniform_points(tiny_cfg, np.random.default_rng(seed), 2, n_points)
    vox = j_voxelize_batch(jnp.asarray(pts), jnp.asarray(num), tiny_cfg)
    feats = j_mean_vfe(vox["features"], vox["occupancy"])
    return feats, vox["coords"], vox["voxel_mask"]


def test_make_sorted_equal(tiny_cfg):
    feats, coords, mask = _tiny_sparse(tiny_cfg, n_points=900)
    grid = tiny_cfg.grid_shape_zyx
    ref = jax.vmap(lambda f, c, m: jsp.make_sorted(f, c, m, grid))(feats, coords, mask)
    got = tsp.make_sorted(_t(feats), _t(coords), _t(mask), grid)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _compare_plan(keys, mask, grid, spec, out_cap, subm, **jax_kw):
    k, s, p = spec
    plan = jax.jit(lambda kk, mm: jsp.plan_stage_batched(
        kk, mm, grid, k, s, p, out_cap, subm_kernel=subm, **jax_kw))
    ref = plan(jnp.asarray(keys), jnp.asarray(mask))
    got = tsp.plan_stage_batched(_t(keys), _t(mask), grid, k, s, p, out_cap,
                                 subm_kernel=subm)
    if subm is None:
        assert got[0] is None and ref[0] is None
    else:
        for r, g in zip(ref[0], got[0]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for r, g in zip(ref[1], got[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for r, g in zip(ref[2:], got[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    return got


def test_plan_tiny_z_chain(tiny_cfg):
    """The whole 41 -> 21 -> 11 -> 5 -> 2 chain of the tiny config, each
    stage planned on the previous stage's active set; the third stage is
    the k3s2p0 pad clamp."""
    feats, coords, mask = _tiny_sparse(tiny_cfg)
    grid = tiny_cfg.grid_shape_zyx
    _, keys, mask = jax.vmap(lambda f, c, m: jsp.make_sorted(f, c, m, grid))(
        feats, coords, mask)
    keys, mask = np.asarray(keys), np.asarray(mask)
    for si, spec in enumerate(STAGES):
        subm = (3, 3, 3) if si < 3 else None
        got = _compare_plan(keys, mask, grid, spec,
                            tiny_cfg.stage_voxel_capacity(si + 1), subm)
        assert int(got[4].sum()) == 0
        keys, mask = got[2].numpy(), got[3].numpy()
        grid = tsp.out_grid_shape(grid, *spec)
    assert grid[0] == 2


def test_plan_capacity_truncation(tiny_cfg):
    """out_cap below the dilated active set: the lowest keys are kept and
    the drop count equals JAX's."""
    rng = np.random.default_rng(4)
    grid = (21, 32, 32)
    keys, mask = sorted_key_sets(rng, grid, 3, 700, 450, 690)
    got = _compare_plan(keys, mask, grid, STAGES[1], 300, (3, 3, 3))
    assert (got[4].numpy() > 0).all()


def test_plan_cached_branch_big_bev():
    """A grid whose BEV exceeds DENSE_SHIFT_MAX_BEV_CELLS, so the JAX plan
    takes its column-cache branch (the branch stage 0 of KITTI takes)."""
    grid = (41, 1000, 1010)
    assert grid[1] * grid[2] > jsp.DENSE_SHIFT_MAX_BEV_CELLS
    rng = np.random.default_rng(7)
    d, h, w = grid
    keys, mask = [], []
    n = 1600
    for nact in (1200, 1550):
        # clustered columns (neighbours exist) with a few z each
        cy = rng.integers(100, 140, nact)
        cx = rng.integers(500, 540, nact)
        z = rng.integers(0, d, nact)
        k = np.unique((cy * w + cx) * d + z).astype(np.int32)
        keys.append(np.concatenate([k, np.full(n - len(k), d * h * w, np.int32)]))
        mask.append(np.arange(n) < len(k))
    keys, mask = np.stack(keys), np.stack(mask)
    _compare_plan(keys, mask, grid, STAGES[0], 4000, (3, 3, 3),
                  subm_col_cap=1600, down_col_cap=4000)


def _densify_input(rng, c=16):
    grid = (11, 20, 18)
    keys, mask = sorted_key_sets(rng, grid, 3, 500, 300, 480)
    feats = rng.normal(size=(3, 500, c)).astype(np.float32) * mask[..., None]
    return grid, keys, mask, feats


@pytest.mark.parametrize("ncol_cap", [500, 120])
def test_dense_from_sparse_cols(ncol_cap):
    """Values, occupancy and the column-cap drop count (120 truncates)."""
    grid, keys, mask, feats = _densify_input(np.random.default_rng(2))
    st = jscnn.SparseTensor(feats=jnp.asarray(feats), keys=jnp.asarray(keys),
                            mask=jnp.asarray(mask), grid=grid)
    ref, rdrop = jscnn.dense_from_sparse_cols(st, keep_keys=False, ncol_cap=ncol_cap)
    got, gdrop = tscnn.dense_from_sparse_cols(
        tscnn.SparseTensor(_t(feats), _t(keys), _t(mask), grid), ncol_cap)
    np.testing.assert_array_equal(gdrop.numpy(), np.asarray(rdrop))
    assert (gdrop.numpy() > 0).any() == (ncol_cap < 300)
    np.testing.assert_array_equal(got.occ.numpy(), np.asarray(ref.occ))
    # JAX keeps the densify gather's (B, H, W, D, C) order (hwdc)
    np.testing.assert_array_equal(got.feats.permute(0, 3, 4, 2, 1).numpy(),
                                  np.asarray(ref.feats))


@pytest.mark.parametrize("hwdc", [True, False])
def test_to_bev_both_jax_layouts(hwdc):
    """to_bev's c-major (C, D) channel order, held against JAX's hwdc and
    z-major DenseTensor (the hwdc branch has no test in the JAX package)."""
    rng = np.random.default_rng(9)
    b, c, d, h, w = 2, 8, 3, 6, 5
    feats = rng.normal(size=(b, c, d, h, w)).astype(np.float32)
    occ = rng.uniform(size=(b, d, h, w)) > 0.5
    zmajor = np.transpose(feats, (0, 2, 3, 4, 1))
    jf = np.transpose(feats, (0, 3, 4, 2, 1)) if hwdc else zmajor
    ref = jscnn.to_bev(jscnn.DenseTensor(feats=jnp.asarray(jf), occ=jnp.asarray(occ),
                                         grid=(d, h, w), hwdc=hwdc))
    got = tscnn.to_bev(tscnn.DenseTensor(_t(feats), _t(occ), (d, h, w)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_to_bev_sparse_input():
    """A stage left sparse (dense_from_stage = 4) collapses the same way."""
    grid, keys, mask, feats = _densify_input(np.random.default_rng(6), c=8)
    ref = jscnn.to_bev(jscnn.SparseTensor(feats=jnp.asarray(feats), keys=jnp.asarray(keys),
                                          mask=jnp.asarray(mask), grid=grid))
    got = tscnn.to_bev(tscnn.SparseTensor(_t(feats), _t(keys), _t(mask), grid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("spec", [((3, 3, 3), (1, 1, 1), (1, 1, 1))] + STAGES[2:])
def test_dense_conv_and_dilation(spec):
    """conv3d with the shared (K*Cin, Cout) weight layout and the strided
    active-set dilation, f32. Tolerance: two libraries' f32 convs sum 27*8
    products in different orders (~1e-6 relative)."""
    kernel, stride, pad = spec
    rng = np.random.default_rng(1)
    b, cin, cout, grid = 2, 8, 6, (7, 10, 9)
    x = rng.normal(size=(b, cin) + grid).astype(np.float32)
    occ = rng.uniform(size=(b,) + grid) > 0.7
    kv = int(np.prod(kernel))
    wgt = rng.normal(size=(kv * cin, cout)).astype(np.float32)
    ref = jscnn._dense_conv(jnp.asarray(np.transpose(x, (0, 2, 3, 4, 1))),
                            jnp.asarray(wgt), kernel, stride, pad, jnp.float32)
    got = tscnn._dense_conv(_t(x), _t(wgt), kernel, stride, pad, torch.float32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tscnn.dense_dilate_occ(_t(occ), kernel, stride, pad).numpy(),
        np.asarray(jscnn.dense_dilate_occ(jnp.asarray(occ), kernel, stride, pad)))


@pytest.mark.parametrize("backend", ["voxel", "column"])
def test_conv_outputs_are_freed_before_the_relu(tiny_cfg, backend, monkeypatch):
    """The epilogue (``bn_relu``) drops a conv's float32 output after the
    batch norm, so in inference no z-window or dense conv output is alive
    at any ReLU of the middle extractor: a dense stage's output volume sets
    the forward's peak memory."""
    made, alive = [], []

    def tracked(fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            made.append(weakref.ref(out))
            return out
        return run

    relu = torch.nn.functional.relu

    def counted_relu(x, inplace=False):
        alive.append(sum(r() is not None for r in made))
        return relu(x, inplace)

    monkeypatch.setattr(tscnn, "zwin_conv", tracked(tscnn.zwin_conv))
    monkeypatch.setattr(tscnn, "_dense_conv", tracked(tscnn._dense_conv))
    monkeypatch.setattr(torch.nn.functional, "relu", counted_relu)
    cfg = port_cfg(tiny_cfg).replace(sparse_backend=backend, dense_from_stage=2)
    feats, coords, mask = (_t(a) for a in _tiny_sparse(tiny_cfg))
    grid = cfg.grid_shape_zyx
    st = (tscnn.from_voxels_columns(feats, coords, mask, grid, cfg.max_voxels)[0]
          if backend == "column" else tscnn.from_voxels(feats, coords, mask, grid))
    with torch.no_grad():
        tscnn.SpMiddleFHD(cfg).eval()(st)
    assert len(alive) == 14 and made and not any(alive), alive


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["dense", "rows", "columns"])
def test_epilogue_on_compute_dtype_equals_float32_chain(layout, dtype, mode):
    """``bn_relu`` on a conv output in the compute dtype (the dense stages'
    cuDNN output, no longer cast to float32 by ``_dense_conv``) equals the
    chain it replaced bit for bit: the output upcast to float32, then
    ``MaskedBatchNorm``, ReLU, the site mask and the cast; in training with
    the same running statistics after. In eval mode ``ops/bn_relu.bn_relu``
    (on the CPU ``bn_relu_plain``, kernel K4's reference) gives those bits
    too."""
    from vision3d_tpu_torch.ops import bn_relu as epilogue

    rng = np.random.default_rng(7)
    c = 16
    shape, channel_dim = {"dense": ((2, c, 3, 4, 5), 1), "rows": ((2, 37, c), -1),
                          "columns": ((2, 9, 5, c), -1)}[layout]
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    if layout == "dense":
        x = x.contiguous(memory_format=torch.channels_last_3d)
    site_shape = [n for i, n in enumerate(shape) if i != channel_dim % len(shape)]
    site = torch.from_numpy(rng.uniform(size=site_shape) < 0.6)
    bns = []
    for _ in range(2):
        bn = tscnn.MaskedBatchNorm(c).train(mode == "train")
        with torch.no_grad():
            bn.running_mean.copy_(_t(rng.normal(size=c).astype(np.float32)))
            bn.running_var.copy_(_t(rng.uniform(0.1, 3, size=c).astype(np.float32)))
            bn.weight.copy_(_t(rng.normal(size=c).astype(np.float32)))
            bn.bias.copy_(_t(rng.normal(size=c).astype(np.float32)))
        bns.append(bn)
    bns[1].load_state_dict(bns[0].state_dict())
    m = site.unsqueeze(channel_dim)
    with torch.no_grad():
        want = torch.where(m, torch.nn.functional.relu(bns[1](x.float(), site, channel_dim)),
                           0.0).to(dtype)
        got = tscnn.bn_relu(bns[0], x.clone(), site, channel_dim, dtype)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert got.dtype == dtype and torch.equal(got.view(bits), want.view(bits))
    for a, b in zip(bns[0].state_dict().values(), bns[1].state_dict().values()):
        assert torch.equal(a, b)
    if mode == "eval":
        plain = epilogue.bn_relu(x, site, bns[0].running_mean, bns[0].running_var,
                                 bns[0].weight, bns[0].bias, bns[0].eps, channel_dim, dtype)
        assert torch.equal(plain.view(bits), want.view(bits))
