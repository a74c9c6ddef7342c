"""The column backend (sparse in BEV, dense in z): the port's
``ops/column_sparse.py``, ``ops/column_conv.py`` (its plain version on the
CPU), the ColumnTensor arms of ``models/sparse_cnn.py`` and
``Second.inference`` with ``sparse_backend="column"``, against the JAX
package on the same seeded numpy inputs. Integer outputs must be exactly
equal. The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision3d_tpu.config import Config
from vision3d_tpu.core.anchors import make_anchors
from vision3d_tpu.core.voxelize import voxelize_batch as j_voxelize_batch
from vision3d_tpu.models import sparse_cnn as jscnn
from vision3d_tpu.models.head import head_inference as j_head_inference
from vision3d_tpu.models.second import Second, build_middle_input
from vision3d_tpu.ops import column_sparse as jcsp
from vision3d_tpu.ops.pallas.column_conv import column_conv_pallas
from vision3d_tpu_torch import convert
from vision3d_tpu_torch.core.voxelize import voxelize_batch as t_voxelize_batch
from vision3d_tpu_torch.models import second as tsecond
from vision3d_tpu_torch.models import sparse_cnn as tscnn
from vision3d_tpu_torch.ops import column_conv as tcc
from vision3d_tpu_torch.ops import column_sparse as tcsp

from torch_parity import WEIGHTS, YAML, kitti_like_frames, port_cfg, uniform_points

GRID = (7, 12, 10)
K3 = (3, 3, 3)


def _t(x):
    return torch.from_numpy(np.array(x))


def _equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def random_voxels(rng, grid, n_active, cap, c, batch=2):
    """Batched random active voxels: (feats (B, cap, C), coords ZYX, mask)."""
    d, h, w = grid
    feats, coords, mask = [], [], []
    for _ in range(batch):
        lin = rng.choice(d * h * w, size=n_active, replace=False)
        co = np.stack([lin // (h * w), (lin // w) % h, lin % w], -1).astype(np.int32)
        coords.append(np.concatenate([co, np.zeros((cap - n_active, 3), np.int32)]))
        f = rng.normal(size=(n_active, c)).astype(np.float32)
        feats.append(np.concatenate([f, np.zeros((cap - n_active, c), np.float32)]))
        mask.append(np.arange(cap) < n_active)
    return np.stack(feats), np.stack(coords), np.stack(mask)


@pytest.fixture(scope="module")
def columns():
    """One column tensor, built by the JAX package, as numpy arrays."""
    feats, coords, mask = random_voxels(np.random.default_rng(0), GRID, 90, 128, 4)
    out = jcsp.columns_from_voxels_batched(jnp.asarray(feats), jnp.asarray(coords),
                                           jnp.asarray(mask), GRID, 128)
    return [np.asarray(a) for a in out[:4]]


@pytest.mark.parametrize("cap", [128, 40])   # 40 < the ~60 active columns
def test_columns_from_voxels_equal(cap):
    feats, coords, mask = random_voxels(np.random.default_rng(0), GRID, 90, 128, 4)
    ref = jcsp.columns_from_voxels_batched(jnp.asarray(feats), jnp.asarray(coords),
                                           jnp.asarray(mask), GRID, cap)
    got = tcsp.columns_from_voxels_batched(_t(feats), _t(coords), _t(mask), GRID, cap)
    _equal(got, ref)
    assert (int(got[4].sum()) > 0) == (cap == 40)


STRIDED = ((3, 3), (2, 2), (1, 1))


@pytest.mark.parametrize("out_cap", [64, 10])
def test_downsample_bev_columns_equal(columns, out_cap):
    _, _, ck, cm = columns
    out_hw = (6, 5)
    ref = jax.vmap(lambda k, m: jcsp.downsample_bev_columns(
        k, m, GRID, *STRIDED, out_cap, out_hw))(jnp.asarray(ck), jnp.asarray(cm))
    got = tcsp.downsample_bev_columns(_t(ck), _t(cm), GRID[1:], *STRIDED, out_cap,
                                      out_hw)
    _equal(got, ref)
    assert (int(got[2].sum()) > 0) == (out_cap == 10)


@pytest.mark.parametrize("case", ["subm", "strided", "identity"])
def test_bev_rulebook_equal(columns, case):
    _, _, ck, cm = columns
    hw = GRID[1:]
    if case == "subm":
        args, outs = ((3, 3), (1, 1), (1, 1)), ()
    elif case == "identity":       # the (3, 1, 1) stage: K2 = 1, same columns
        args, outs = ((1, 1), (1, 1), (0, 0)), (ck, cm, hw)
    else:
        args = STRIDED
        ok, om, _ = tcsp.downsample_bev_columns(_t(ck), _t(cm), hw, *STRIDED, 64, (6, 5))
        outs = (ok.numpy(), om.numpy(), (6, 5))
    ref = jcsp.build_bev_rulebook_batched(
        jnp.asarray(ck), jnp.asarray(cm), hw, *args,
        *[jnp.asarray(o) if isinstance(o, np.ndarray) else o for o in outs])
    got = tcsp.build_bev_rulebook_batched(
        _t(ck), _t(cm), hw, *args,
        *[_t(o) if isinstance(o, np.ndarray) else o for o in outs])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    n = ck.shape[1]
    assert int(got.max()) == n and int(got.min()) >= 0
    if case == "identity":
        np.testing.assert_array_equal(got.numpy(), np.where(cm, np.arange(n), n))


@pytest.mark.parametrize("kernel,sz,pz", [(K3, 1, 1), (K3, 2, 1), (K3, 2, 0),
                                          ((3, 1, 1), 2, 0)])
def test_column_conv_matches_pallas_and_xla(kernel, sz, pz):
    """The wrapper on the CPU (the plain version) against the TPU kernel in
    interpret mode, bf16, at the tolerance of tests/test_pallas_kernels.py
    (2e-2 of the scale), and against ``column_conv_dz`` in float32: exact
    products summed in other orders, 1e-5 of the scale."""
    rng = np.random.default_rng(0)
    B, N, D, C, Cout, M = 2, 200, 21, 32, 32, 130
    k2 = kernel[1] * kernel[2]
    cf = rng.normal(size=(B, N, D * C)).astype(np.float32)
    cf = np.asarray(jnp.asarray(cf, jnp.bfloat16).astype(jnp.float32))
    rb = rng.integers(0, N + 1, (B, M * k2)).astype(np.int32)
    rb[1, -k2:] = N                                   # an all-miss column
    w = rng.normal(size=(3 * k2 * C, Cout)).astype(np.float32)
    before = tcc.LAUNCHES["column_conv"]
    ref = np.asarray(column_conv_pallas(jnp.asarray(cf, jnp.bfloat16), jnp.asarray(rb),
                                        jnp.asarray(w), kernel, D, C, sz, pz,
                                        block_cols=128))
    got = tcc.column_conv(_t(cf), _t(rb), _t(w), kernel, D, C, sz, pz, torch.bfloat16)
    d_out = (D + 2 * pz - 3) // sz + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, M, d_out * Cout)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2 * scale, rtol=2e-2)
    assert not got[1, -1].any()
    ref32 = np.asarray(jcsp.column_conv_dz(jnp.asarray(cf), jnp.asarray(rb),
                                           jnp.asarray(w), kernel, D, C, sz, pz))
    got32 = tcc.column_conv(_t(cf), _t(rb), _t(w), kernel, D, C, sz, pz)
    np.testing.assert_allclose(got32.numpy(), ref32, atol=1e-5 * scale, rtol=1e-5)
    assert tcc.LAUNCHES["column_conv"] == before


def test_column_conv_rejects_other_devices():
    cf = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(ValueError):
        tcc.column_conv(cf, torch.zeros((1, 9), dtype=torch.int32, device="meta"),
                        torch.zeros((54, 16), device="meta"), K3, 4, 2)


def test_occupancy_bev_and_voxels_equal(columns):
    cf, zm, ck, cm = columns
    d, c = GRID[0], 4
    rb = tcsp.build_bev_rulebook_batched(_t(ck), _t(cm), GRID[1:], (3, 3), (1, 1), (1, 1))
    for sz, pz in ((1, 1), (2, 1), (2, 0)):
        ref = jcsp.column_occupancy_batched(jnp.asarray(zm), jnp.asarray(rb.numpy()),
                                            K3, sz, pz)
        got = tcsp.column_occupancy_batched(_t(zm), rb, K3, sz, pz)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = jcsp.columns_to_bev_batched(*[jnp.asarray(a) for a in columns], GRID, c)
    got = tcsp.columns_to_bev_batched(*[_t(a) for a in columns], GRID, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_array_equal(
        tcsp.expand_site_mask(_t(zm), c).numpy(),
        np.asarray(jcsp.expand_site_mask(jnp.asarray(zm), c)))
    jct = jscnn.ColumnTensor(*[jnp.asarray(a) for a in columns], grid=GRID, c=c)
    tct = tscnn.ColumnTensor(*[_t(a) for a in columns], grid=GRID, c=c)
    jv, tv = jct.to_voxel_sparse(100), tct.to_voxel_sparse(100)
    _equal((tv.feats, tv.keys, tv.mask), (jv.feats, jv.keys, jv.mask))


def test_dense_from_columns_equal(columns):
    """feats as z-major (B, C, D, H, W) against JAX's hwdc (B, H, W, D, C)."""
    jct = jscnn.ColumnTensor(*[jnp.asarray(a) for a in columns], grid=GRID, c=4)
    tct = tscnn.ColumnTensor(*[_t(a) for a in columns], grid=GRID, c=4)
    ref, got = jscnn.dense_from_columns(jct, keep_keys=False), tscnn.dense_from_columns(tct)
    assert ref.hwdc
    np.testing.assert_array_equal(got.occ.numpy(), np.asarray(ref.occ))
    np.testing.assert_allclose(got.feats.numpy(),
                               np.transpose(np.asarray(ref.feats), (0, 4, 3, 1, 2)),
                               atol=1e-6)
    assert got.feats.is_contiguous(memory_format=torch.channels_last_3d)


def small_cfg(**kw):
    """The small geometry of tests/test_column_sparse.py:132-142."""
    return Config().replace(
        max_voxels=256, voxel_size=(0.4, 0.4, 0.1),
        grid_bounds=(0.0, -12.8, -3.0, 25.6, 12.8, 1.0), num_classes=1,
        anchors=Config().anchors[:1],
        capacity=Config().capacity.__class__(stage_capacity=(8.0,) * 5), **kw)


@contextlib.contextmanager
def quick_compile():
    """XLA's optimisation passes off while the whole-model graphs compile
    (the column model's per-z products make them large): the compile is
    the cost of these tests, the run is nothing."""
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", False)


def random_like(tree, seed):
    """Seeded numpy weights shaped like a flax variable tree: BN scales and
    variances in [0.5, 1.5], everything else normal at the spread of a
    fan-in init, so that activations keep a sane scale."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if path[-1].key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        std = (2.0 / max(int(np.prod(x.shape[:-1])), 1)) ** 0.5 if x.ndim > 1 else 0.1
        return (rng.normal(size=x.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _middle_inputs(cfg):
    f, c, m = random_voxels(np.random.default_rng(1), cfg.grid_shape_zyx, 200, 256, 4)
    f[1] *= 0.5
    return f, c, m


def _jax_diag(mutated):
    return {"/".join(str(p.key) for p in path[1:]): int(np.asarray(leaf).sum())
            for path, leaf in jax.tree_util.tree_flatten_with_path(mutated)[0]}


def _middle_state_dict(variables):
    """The flax variables of a bare middle extractor under the port's
    state-dict names (convert.py's renames, without the ``cnn.`` prefix)."""
    sd = {}
    for flax_name, kind in (("SubMConv", "subm"), ("SparseConvDown", "down")):
        for name, p in variables["params"].items():
            if not name.startswith(flax_name + "_"):
                continue
            prefix = f"{kind}.{name.rsplit('_', 1)[1]}"
            stats = variables["batch_stats"][name]["MaskedBatchNorm_0"]
            sd[f"{prefix}.weight"] = p["kernel"]
            sd[f"{prefix}.bn.weight"] = p["MaskedBatchNorm_0"]["scale"]
            sd[f"{prefix}.bn.bias"] = p["MaskedBatchNorm_0"]["bias"]
            sd[f"{prefix}.bn.running_mean"] = stats["mean"]
            sd[f"{prefix}.bn.running_var"] = stats["var"]
    return {k: _t(v) for k, v in sd.items()}


def _jax_middle(cfg, jst, seed):
    """Run the JAX middle extractor ``cfg.cnn`` on ``jst`` with seeded
    random variables: (variables, bev, diagnostics)."""
    model = jscnn.CNN_FACTORY[cfg.cnn](cfg)
    shapes = jax.eval_shape(lambda s: model.init(jax.random.PRNGKey(0), s, False), jst)
    variables = random_like({k: v for k, v in shapes.items() if k != "diagnostics"}, seed)
    with quick_compile():
        (_, bev), mutated = jax.jit(lambda v, s: model.apply(
            v, s, False, need_scales=False, mutable=["diagnostics"]))(variables, jst)
    return variables, np.asarray(bev), _jax_diag(mutated)


def _bev_close(got, ref):
    """f32 sums in other orders through up to 14 conv layers: 1e-4 of the
    map's max."""
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * float(np.abs(ref).max()),
                               rtol=1e-4)


def test_spmiddle_all_column_stages_matches_jax():
    """SpMiddleFHD on a ColumnTensor with ``dense_from_stage = 4`` (all 14
    convs on columns, the BEV map straight from the columns), float32,
    random weights: the BEV map and every counter. ``dense_from_stage = 2``
    is held at the same geometry in test_column_inference_matches_jax."""
    cfg = small_cfg(dense_from_stage=4)
    f, c, m = _middle_inputs(cfg)
    grid = cfg.grid_shape_zyx
    jst, ndrop = jscnn.from_voxels_columns(jnp.asarray(f), jnp.asarray(c),
                                           jnp.asarray(m), grid, cfg.max_voxels)
    variables, ref, jdiag = _jax_middle(cfg, jst, seed=0)
    tm = tscnn.SpMiddleFHD(port_cfg(cfg)).eval()
    tm.load_state_dict(_middle_state_dict(variables), strict=True)
    tst, tdrop = tscnn.from_voxels_columns(_t(f), _t(c), _t(m), grid, cfg.max_voxels)
    np.testing.assert_array_equal(tdrop.numpy(), np.asarray(ndrop))
    with torch.no_grad():
        got, tdiag = tm(tst)
    assert float(np.abs(ref).max()) > 0
    _bev_close(got, ref)
    assert sorted(tdiag) == [f"stage{i + 1}_columns_dropped" for i in range(4)]
    for i in range(4):
        assert int(tdiag[f"stage{i + 1}_columns_dropped"].sum()) == jdiag[
            f"SparseConvDown_{i}/columns_dropped"]


@pytest.mark.parametrize("backend", ["voxel", "column"])
def test_lite_variant_matches_jax(backend):
    """SpMiddleFHDLite (strided convs only) on both backends, float32,
    random weights: shapes and the BEV map."""
    cfg = small_cfg(cnn="SpMiddleFHDLite", sparse_backend=backend)
    f, c, m = _middle_inputs(cfg)
    grid = cfg.grid_shape_zyx
    if backend == "column":
        jst, _ = jscnn.from_voxels_columns(jnp.asarray(f), jnp.asarray(c),
                                           jnp.asarray(m), grid, cfg.max_voxels)
        tst, _ = tscnn.from_voxels_columns(_t(f), _t(c), _t(m), grid, cfg.max_voxels)
    else:
        jst = jscnn.from_voxels(jnp.asarray(f), jnp.asarray(c), jnp.asarray(m), grid)
        tst = tscnn.from_voxels(_t(f), _t(c), _t(m), grid)
    variables, ref, _ = _jax_middle(cfg, jst, seed=1)
    tm = tscnn.CNN_FACTORY[cfg.cnn](port_cfg(cfg)).eval()
    assert len(tm.subm) == 0 and len(tm.down) == 4
    tm.load_state_dict(_middle_state_dict(variables), strict=True)
    with torch.no_grad():
        got, _ = tm(tst)
    ny, nx = cfg.bev_shape
    assert ref.shape == (2, ny, nx, 128) and float(np.abs(ref).max()) > 0
    _bev_close(got, ref)


def test_column_training_is_refused():
    """Training on the column backend is ported (the name is the test's
    from before, when it raised): in train mode the column batch norms take
    the batch's statistics, not the running ones, so the BEV map and every
    running statistic equal those of the train-mode voxel backend on the
    same voxels and weights (1e-4 of the map's max; statistics to 1e-5)."""
    cfg = small_cfg()
    f, c, m = _middle_inputs(cfg)
    grid = cfg.grid_shape_zyx
    tcol, _ = tscnn.from_voxels_columns(_t(f), _t(c), _t(m), grid, 256)
    tvox = tscnn.from_voxels(_t(f), _t(c), _t(m), grid)
    sd = tscnn.SpMiddleFHD(port_cfg(cfg)).state_dict()
    for k in sd:
        if k.endswith("weight") and sd[k].dim() == 2:
            sd[k] = torch.randn(sd[k].shape, generator=torch.Generator().manual_seed(
                sd[k].shape[0])) * (2.0 / sd[k].shape[0]) ** 0.5
    out = []
    for st in (tcol, tvox):
        tm = tscnn.SpMiddleFHD(port_cfg(cfg))
        tm.load_state_dict(sd)
        with torch.no_grad():
            bev, _ = tm.train()(st)
        out.append((bev, tm.state_dict()))
    (bev_c, sd_c), (bev_v, sd_v) = out
    assert float(bev_v.abs().max()) > 0
    _bev_close(bev_c, bev_v.numpy())
    for k, v in sd_v.items():
        if "running_" in k:
            assert not torch.equal(v, sd[k]), k
            np.testing.assert_allclose(sd_c[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_lite_state_dict_is_a_subset_and_converts_both_ways(tiny_cfg):
    full = tsecond.Second(port_cfg(tiny_cfg)).state_dict()
    for backend in ("voxel", "column"):
        cfg = port_cfg(tiny_cfg.replace(cnn="SpMiddleFHDLite", sparse_backend=backend))
        lite = tsecond.init_second(tsecond.Second(cfg), torch.Generator().manual_seed(0))
        sd = lite.state_dict()
        assert set(sd) < set(full) and not any(k.startswith("cnn.subm") for k in sd)
        tree = convert.flax_from_state_dict(sd)
        assert sorted(tree["params"]["cnn"]) == [f"SparseConvDown_{i}" for i in range(4)]
        back = convert.state_dict_from_flax(tree)
        assert set(back) == set(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v), k
        tsecond.Second(cfg).load_state_dict(back, strict=True)


@pytest.fixture(scope="module")
def trained():
    return convert.load_npz(WEIGHTS)


@pytest.fixture(scope="module")
def cfg3(tiny_cfg):
    """tiny_cfg's geometry (that of ``small_cfg``) with the three trained
    classes, on the column backend, ``dense_from_stage = 2``."""
    full = Config.from_yaml(str(YAML))
    return tiny_cfg.replace(num_classes=3, anchors=full.anchors,
                            sparse_backend="column")


@pytest.fixture(scope="module")
def jax_column_second(cfg3):
    """The JAX detector on the column backend, compiled once with the
    variables as an argument: f(variables, points, num) -> (bev,
    Detections, counters)."""
    anchors = jnp.asarray(make_anchors(cfg3))

    def run(mdl, p, n):
        vox = j_voxelize_batch(p, n, cfg3)
        st, col_dropped = build_middle_input(cfg3, vox, with_diagnostics=True)
        _, bev = mdl.cnn(st, False, need_scales=False)
        cls_map, reg_map = mdl.head(mdl.rpn(bev, False))
        own = dict(voxelizer_dropped=(vox["num_voxels_total"] - vox["num_voxels"]).sum(),
                   stage0_columns_dropped=col_dropped.sum())
        return bev, j_head_inference(cls_map, reg_map, anchors, cfg3), own

    fn = jax.jit(lambda v, p, n: Second(cfg3).apply(v, p, n, method=run,
                                                    mutable=["diagnostics"]))

    def call(variables, pts, num):
        with quick_compile():
            (bev, det, own), mutated = fn(variables, jnp.asarray(pts), jnp.asarray(num))
        diag = _jax_diag(mutated)
        diag.update({k: int(v) for k, v in own.items()})
        return np.asarray(bev), det, diag

    return call


def _port_column_second(cfg3, variables, pts, num):
    """The port on the same input: (bev, Detections, counters); the state
    dict loads strictly into the column-backend model."""
    cfg = port_cfg(cfg3)
    model, anchors = tsecond.create_second(
        cfg, device="cpu", state_dict=convert.state_dict_from_flax(variables))
    with torch.no_grad():
        st, _ = tsecond.build_middle_input(cfg, t_voxelize_batch(_t(pts), _t(num), cfg))
        bev, _ = model.cnn(st)
        det, diag = model.inference(_t(pts), _t(num), anchors)
    return bev, det, {k: int(v) for k, v in diag.items()}


def _detections_close(tdet, det, box_tol, score_tol):
    valid = np.asarray(det.valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(tdet.valid.numpy(), valid)
    np.testing.assert_array_equal(tdet.class_idx.numpy()[valid],
                                  np.asarray(det.class_idx)[valid])
    box = np.abs(tdet.boxes.numpy() - np.asarray(det.boxes))[valid].max()
    score = np.abs(tdet.scores.numpy() - np.asarray(det.scores))[valid].max()
    assert box <= box_tol and score <= score_tol, (box, score)


def _column_counters(jdiag, tdiag):
    want = dict(voxelizer_dropped=jdiag["voxelizer_dropped"],
                stage0_columns_dropped=jdiag["stage0_columns_dropped"],
                stage1_columns_dropped=jdiag["cnn/SparseConvDown_0/columns_dropped"],
                stage2_columns_dropped=jdiag["cnn/SparseConvDown_1/columns_dropped"])
    assert tdiag == want


@pytest.mark.parametrize("weights", ["trained", "random"])
def test_column_inference_matches_jax(jax_column_second, trained, cfg3, weights):
    """The slice as a whole, ``Second.inference`` with
    ``sparse_backend="column"`` (``dense_from_stage = 2``: stages 0-1 on
    columns, ``dense_from_columns``, dense stages), float32. The BEV map of
    SpMiddleFHD within 1e-4 of its max, equal detection sets, boxes within
    0.0077 and scores within 0.0008 (the AP cross-check yardstick),
    counters equal. With the trained 3-class weights on KITTI-like frames;
    and with seeded random weights on a uniform cloud dense enough that
    the voxelizer and the stage-0 column capacity both truncate."""
    pts, num = kitti_like_frames(cfg3, 0)
    if weights == "random":
        pts = uniform_points(cfg3, np.random.default_rng(5), 2, int(num[0]))[0]
        variables = random_like(trained, seed=2)
    else:
        variables = trained
    ref_bev, det, jdiag = jax_column_second(variables, pts, num)
    bev, tdet, tdiag = _port_column_second(cfg3, variables, pts, num)
    _bev_close(bev, ref_bev)
    _column_counters(jdiag, tdiag)
    dropped = tdiag["voxelizer_dropped"] > 0 and tdiag["stage0_columns_dropped"] > 0
    assert dropped == (weights == "random")
    _detections_close(tdet, det, 0.0077, 0.0008)


def test_port_backends_agree(trained, cfg3):
    """The port's column result against its own voxel result with shared
    weights, at the tolerance of test_model_backends_agree
    (tests/test_column_sparse.py): rtol = atol = 2e-2 on the BEV map."""
    pts, num = kitti_like_frames(cfg3, 1)
    sd = convert.state_dict_from_flax(trained)
    bevs = {}
    for backend in ("voxel", "column"):
        cfg = port_cfg(cfg3.replace(sparse_backend=backend))
        model, _ = tsecond.create_second(cfg, device="cpu", state_dict=sd)
        with torch.no_grad():
            st, _ = tsecond.build_middle_input(cfg, t_voxelize_batch(_t(pts), _t(num), cfg))
            bevs[backend], diag = model.cnn(st)
        assert all(int(v.sum()) == 0 for v in diag.values()), diag
    assert float(bevs["voxel"].abs().max()) > 0
    np.testing.assert_allclose(bevs["column"].numpy(), bevs["voxel"].numpy(),
                               rtol=2e-2, atol=2e-2)
