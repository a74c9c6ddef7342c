"""PV-RCNN on the column backend (``SPARSE_BACKEND: column``), the port
against the JAX package on the CPU at the size of tests/test_pvrcnn.py's
``pv_cfg``: the middle extractor's four scales read back as voxels (eval
mode at ``dense_from_stage`` 2, training mode at 4 and 2) and
``to_global``, the
gradients of the two conversions (``ColumnTensor.to_voxel_sparse`` and
``dense_from_columns(keep_keys=True)`` read back at its keys) against
``jax.vjp``, stage 1, the two-stage outputs and both inference paths at
``dense_from_stage`` 2; then, port against port, a two-stage training
step on columns, both modes, against the same step on voxels, and ``train_cli`` /
``eval_cli --model pvrcnn|pvrcnn2`` on a column yaml.

The weights are the port's seeded init whose batch norms took one batch's
statistics (``chip_smoke.calibrate_bn``), with the seeded noise of
tests/test_torch_pvrcnn.py on every statistic, scale and bias, carried to
flax by ``convert.py``: one state dict serves both backends. JAX runs two
``jax.jit`` graphs: the model at ``dense_from_stage`` 2, whose scales are
the eval-mode ones at 2, and the conv stacks in training mode at 4 and 2.
Integer outputs
(keypoints, keys, masks, keep sets) must be equal; floats are held to 1e-5
of their scale, with oneDNN off."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vision3d_tpu.core.anchors import make_anchors
from vision3d_tpu.core.voxelize import voxelize_batch as j_voxelize_batch
from vision3d_tpu.models import sparse_cnn as jscnn
from vision3d_tpu.models.pvrcnn import PV_RCNN as JPV
from vision3d_tpu.models.second import build_middle_input as j_build_middle_input
from vision3d_tpu.models.sparse_cnn import to_global as j_to_global
from vision3d_tpu_torch import convert, eval_cli, train_cli
from vision3d_tpu_torch.core.voxelize import voxelize_batch
from vision3d_tpu_torch.models import pvrcnn as tpv
from vision3d_tpu_torch.models import sparse_cnn as tscnn
from vision3d_tpu_torch.models.second import build_middle_input
from vision3d_tpu_torch.training import train as ttrain

from test_data import write_fake_kitti
from test_torch_column import quick_compile
from test_torch_pointnet import perturb
from test_torch_pvrcnn import _everything, _inputs, close, pv_cfg
from test_torch_pvrcnn_train import _yaml_doc
from test_train import synthetic_train_batch
from torch_parity import ROOT, port_cfg

sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# (name, dense_from_stage in the mode, training mode) of the scale checks:
# eval mode at 2 (the model's default, from the model's own graph) and
# training mode at 4 (every stage on columns) and at 2 (the dense cutover
# carrying the column keys). Eval mode at 4 runs the conversions of
# training at 4 with eval-mode batch norms: its graph would add ~10 s of
# XLA compile and nothing the others leave unchecked.
VARIANTS = (("eval2", 2, False), ("train4", 4, True), ("train2", 2, True))
# the same port model on both backends, one training step: losses as
# tests/test_torch_train_backends.py holds port against port
PORT_LOSS_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def plain_f32():
    """oneDNN off; two intra-op threads, as tests/test_torch_train_backends.py
    runs (these tiny shapes gain nothing from more, and beside other test
    processes a larger pool spins)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            yield
    finally:
        torch.set_num_threads(threads)


def column_cfg(dense_from=2):
    return pv_cfg().replace(sparse_backend="column", dense_from_stage=dense_from,
                            train_dense_from_stage=dense_from)


@pytest.fixture(scope="module")
def weights():
    """The calibrated, perturbed weights: (flax tree, port state dict)."""
    cfg = port_cfg(column_cfg())
    pts, num = _inputs()
    model, anchors = tpv.create_pvrcnn(cfg, device="cpu")
    chip_smoke.calibrate_bn(model, torch.from_numpy(pts), torch.from_numpy(num), anchors)
    variables = perturb(convert.flax_from_state_dict(model.state_dict()), 9)
    return variables, convert.state_dict_from_flax(variables)


@pytest.fixture(scope="module")
def jax_run(weights):
    variables, _ = weights
    cfg = column_cfg()
    model = JPV(cfg)
    anchors = jnp.asarray(make_anchors(cfg))
    pts, num = _inputs()
    key = jax.random.PRNGKey(1)

    def scales(v, p, n):
        st = j_build_middle_input(cfg, j_voxelize_batch(p, n, cfg))
        cnn = {"params": v["params"]["cnn"], "batch_stats": v["batch_stats"]["cnn"]}
        out = {}
        for name, dense_from, train in VARIANTS:
            if train:       # eval mode at 2 is the model's own, from _everything
                (out[name], _), _ = jscnn.SpMiddleFHD(column_cfg(dense_from)).apply(
                    cnn, st, True, need_scales=True, mutable=["batch_stats"])
        return out

    def origins(sts):
        return [j_to_global(s, cfg, stride)[0] for s, stride in zip(sts, cfg.strides)]

    out = jax.jit(lambda v, p, n: model.apply(v, p, n, anchors, key, method=_everything))(
        variables, pts, num)
    # the other two conv stacks compile with XLA's optimisation passes
    # off; the metric origins, whose float32 rounding is XLA's fused
    # multiply-add, with them on
    with quick_compile():
        variants = jax.jit(scales)(variables, pts, num)
    out["variants"] = {name: [(s.keys, s.mask, s.feats, g)
                              for s, g in zip(sts, jax.jit(origins)(sts))]
                       for name, sts in variants.items()}
    out["variants"]["eval2"] = [s + (g,) for s, g in zip(out["scales"], out["glob"])]
    m = cfg.gridpool.num_gridpoints
    u = np.asarray(jax.random.uniform(key, (2, cfg.proposal.topk, m, 3)))
    return dict(u=u, out=jax.tree_util.tree_map(np.asarray, out))


@pytest.fixture(scope="module")
def port_run(weights, jax_run):
    _, sd = weights
    cfg = port_cfg(column_cfg())
    model, anchors = tpv.create_pvrcnn(cfg, device="cpu", state_dict=sd)
    pts, num = _inputs()
    p, n = torch.from_numpy(pts), torch.from_numpy(num)
    u = torch.from_numpy(jax_run["u"])
    out = {"variants": {}}
    with torch.no_grad():
        st = build_middle_input(cfg, voxelize_batch(p, n, cfg))[0]
        for name, dense_from, train in VARIANTS:
            c = port_cfg(column_cfg(dense_from))
            cnn = tscnn.SpMiddleFHD(c)
            cnn.load_state_dict(model.cnn.state_dict())
            cnn.train(train)
            _, diag, scales = cnn(st, need_scales=True)
            out["variants"][name] = (scales, [tscnn.to_global(s, c, stride)[0]
                                              for s, stride in zip(scales, c.strides)], diag)
        out["stage1"] = model.stage1(p, n)
        out["two"], _ = model.two_stage(p, n, anchors, u=u)
        out["inference"], out["diag"] = model.inference(p, n, anchors)
        out["two_stage_nms"], _ = model.inference_two_stage(p, n, anchors, u=u)
        out["rerank"], _ = model.inference_two_stage(p, n, anchors, u=u, rerank_only=True)
    return out


@pytest.mark.parametrize("scale", [0, 1, 2, 3])
@pytest.mark.parametrize("variant", [v[0] for v in VARIANTS])
def test_column_scales_and_to_global_match_jax(jax_run, port_run, variant, scale):
    """need_scales on a ColumnTensor: the input and the outputs of stages
    0-2, read as voxels at each stage's voxel capacity (a dense stage's
    output at the key set its cutover and strided convs carry): keys and
    masks equal, features to 1e-5 of their scale, metric origins equal to
    the bit."""
    keys, mask, feats, glob = jax_run["out"]["variants"][variant][scale]
    scales, tglob, _ = port_run["variants"][variant]
    st = scales[scale]
    np.testing.assert_array_equal(st.keys.numpy(), keys)
    np.testing.assert_array_equal(st.mask.numpy(), mask)
    assert mask.sum(1).min() > 0
    assert st.feats.dtype == torch.float32
    close(st.feats, feats)
    np.testing.assert_array_equal(tglob[scale].numpy(), glob)


@pytest.mark.parametrize("variant", [v[0] for v in VARIANTS])
def test_column_counters(port_run, variant):
    """The columns each sparse stage's capacity dropped, one counter per
    sparse stage (these uniform clouds overflow stages 0 and 1: the scales
    above hold JAX's truncation too)."""
    dense_from = dict((v[0], v[1]) for v in VARIANTS)[variant]
    diag = port_run["variants"][variant][2]
    assert set(diag) == {f"stage{i + 1}_columns_dropped" for i in range(dense_from)}
    assert int(diag["stage1_columns_dropped"].sum()) > 0


def test_stage1_matches_jax(jax_run, port_run):
    """FPS keypoints equal; point features and the maps to 1e-5 of their
    scale; the diagnostics gain the column counters."""
    kp, pf, cls_map, reg_map = jax_run["out"]["stage1"]
    tkp, tpf, tcls, treg, diag = port_run["stage1"]
    np.testing.assert_array_equal(tkp.numpy(), kp)
    for a, b in ((tpf, pf), (tcls, cls_map), (treg, reg_map)):
        close(a, b)
    assert set(diag) == {"voxelizer_dropped", "stage0_columns_dropped",
                         "stage1_columns_dropped", "stage2_columns_dropped"}
    assert {k: int(v) for k, v in diag.items()} == {
        k: int(v) for k, v in port_run["diag"].items()}


def test_two_stage_matches_jax(jax_run, port_run):
    want, got = jax_run["out"]["two"], port_run["two"]
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])


def test_inference_paths_match_jax(jax_run, port_run):
    """One stage and two stages with NMS: keep sets equal, kept boxes and
    scores to 1e-5 of their scale; rerank_only: indices equal."""
    for name in ("inference", "two_stage_nms"):
        det, tdet = jax_run["out"][name], port_run[name]
        valid = np.asarray(det.valid)
        np.testing.assert_array_equal(tdet.valid.numpy(), valid, err_msg=name)
        np.testing.assert_array_equal(tdet.class_idx.numpy(), det.class_idx)
        assert valid.any(), name
        close(tdet.boxes.numpy()[valid], det.boxes[valid])
        close(tdet.scores.numpy()[valid], det.scores[valid])
    boxes, scores, idx = jax_run["out"]["rerank"]
    tboxes, tscores, tidx = port_run["rerank"]
    np.testing.assert_array_equal(tidx.numpy(), idx)
    close(tboxes, boxes)
    close(tscores, scores)


def _column_tensor(rng, b=2, n=40, grid=(5, 7, 6), c=8, dtype=np.float32):
    """A random ColumnTensor: sorted BEV keys, about half of z active."""
    d, h, w = grid
    keys = np.full((b, n), h * w, np.int32)
    mask = np.zeros((b, n), bool)
    for i, k in enumerate((30, 25)):
        keys[i, :k] = np.sort(rng.choice(h * w, k, replace=False))
        mask[i, :k] = True
    zmask = (rng.uniform(size=(b, n, d)) < 0.5) & mask[..., None]
    feats = (rng.normal(size=(b, n, d, c)) * zmask[..., None]).astype(dtype)
    return feats.reshape(b, n, d * c), zmask, keys, mask, grid, c


@pytest.mark.parametrize("cap", [60, 400])
def test_to_voxel_sparse_gradient_matches_jax_vjp(cap):
    """ColumnTensor.to_voxel_sparse at a capacity that truncates the sites
    and at one that holds them all: keys and masks equal, features equal,
    and the gradient of the column rows equal to jax.vjp's."""
    rng = np.random.default_rng(cap)
    feats, zmask, keys, mask, grid, c = _column_tensor(rng)
    nsite = int(zmask.sum(axis=(1, 2)).max())
    assert (nsite > cap) == (cap == 60)

    def jconv(f):
        vs = jscnn.ColumnTensor(feats=f, zmask=jnp.asarray(zmask), keys=jnp.asarray(keys),
                                mask=jnp.asarray(mask), grid=grid, c=c).to_voxel_sparse(cap)
        return vs.feats, (vs.keys, vs.mask)

    jf, vjp, (jk, jm) = jax.vjp(jconv, jnp.asarray(feats), has_aux=True)
    cot = rng.normal(size=jf.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(cot))
    tf = torch.from_numpy(feats).requires_grad_()
    vs = tscnn.ColumnTensor(feats=tf, zmask=torch.from_numpy(zmask),
                            keys=torch.from_numpy(keys), mask=torch.from_numpy(mask),
                            grid=grid, c=c).to_voxel_sparse(cap)
    np.testing.assert_array_equal(vs.keys.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vs.mask.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(vs.feats.detach().numpy(), np.asarray(jf))
    vs.feats.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(tf.grad.numpy(), np.asarray(jg))
    assert np.abs(np.asarray(jg)).max() > 0


@pytest.mark.parametrize("cap", [0, 60])
def test_dense_from_columns_keep_keys_matches_jax_vjp(cap):
    """dense_from_columns(keep_keys=True) read back at its keys: JAX's
    volume is (B, H, W, D, C) (``hwdc``: raster row = key), the port's
    z-major (B, C, D, H, W); the keys, the masks, the features read back,
    the occupancy and the gradient of the column rows equal JAX's
    (voxel_cap 0: every site; 60: truncated)."""
    rng = np.random.default_rng(11 + cap)
    feats, zmask, keys, mask, grid, c = _column_tensor(rng)

    def jdense(f):
        ct = jscnn.ColumnTensor(feats=f, zmask=jnp.asarray(zmask), keys=jnp.asarray(keys),
                                mask=jnp.asarray(mask), grid=grid, c=c)
        dt = jscnn.dense_from_columns(ct, keep_keys=True, voxel_cap=cap)
        assert dt.hwdc
        vs = dt.to_voxel_sparse()
        return vs.feats, (vs.keys, vs.mask, dt.occ)

    jf, vjp, (jk, jm, jocc) = jax.vjp(jdense, jnp.asarray(feats), has_aux=True)
    cot = rng.normal(size=jf.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(cot))
    tf = torch.from_numpy(feats).requires_grad_()
    dt = tscnn.dense_from_columns(
        tscnn.ColumnTensor(feats=tf, zmask=torch.from_numpy(zmask),
                           keys=torch.from_numpy(keys), mask=torch.from_numpy(mask),
                           grid=grid, c=c), keep_keys=True, voxel_cap=cap)
    vs = dt.to_voxel_sparse()
    np.testing.assert_array_equal(vs.keys.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vs.mask.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(dt.occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(vs.feats.detach().numpy(), np.asarray(jf))
    sites = zmask.sum(axis=(1, 2))
    assert (vs.mask.sum(1).numpy() == (sites if cap == 0 else np.minimum(sites, cap))).all()
    assert cap == 0 or sites.max() > cap
    vs.feats.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(tf.grad.numpy(), np.asarray(jg))


def _pvrcnn_step(cfg, sd, batch, two):
    """One training step of the port: (losses, gradients before the update)."""
    model, tx, state = ttrain.create_pvrcnn_train_state(cfg, device="cpu", state_dict=sd,
                                                        two_stage=two)
    grads, update = {}, tx.step

    def grab_then_update(count):
        grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        update(count)

    tx.step = grab_then_update
    step = ttrain.make_pvrcnn_train_step(model, tx, cfg, train_stage2=two, seed=0)
    state, losses = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    return {k: float(v) for k, v in losses.items()}, grads, state.diagnostics


@pytest.mark.parametrize("two", [False, True], ids=["pvrcnn", "pvrcnn2"])
@pytest.mark.parametrize("dense_from", [4, 2])
def test_training_step_on_columns(weights, dense_from, two):
    """A training step on columns at ``train_dense_from_stage`` 4 and 2,
    both modes, where no capacity drops a site: its losses equal the voxel
    backend's step to 1e-5 (the two backends compute the same
    convolutions), and the parameters that take a gradient there take a
    finite one here, the stage-2 modules' with two stages. (Gradients are
    not compared across backends: their sums run in other orders, and a
    ReLU input within float32 noise of zero gates the backward on one side
    only; the conversions' gradients are held against jax.vjp above, and
    the card's against the CPU's on replayed gates in chip_smoke.py
    phase 11b.)"""
    cfg = port_cfg(pv_cfg().replace(max_voxels=512))
    sd = weights[1]
    if not two:
        sd = {k: v for k, v in sd.items() if k.split(".")[0] not in tpv.STAGE2_MODULES}
    batch = synthetic_train_batch(pv_cfg(), np.random.default_rng(1), n=400)
    col = cfg.replace(sparse_backend="column", train_dense_from_stage=dense_from)
    (lc, gc, dc), (lv, gv, dv) = (_pvrcnn_step(c, sd, batch, two) for c in (col, cfg))
    assert all(int(v) == 0 for v in list(dc.values()) + list(dv.values()))
    assert ("stage0_columns_dropped" in dc) and len(dc) == dense_from + 2
    for k, v in lv.items():
        np.testing.assert_allclose(lc[k], v, rtol=PORT_LOSS_TOL, err_msg=k)
    assert lv["cls_loss"] > 0 and (not two or lv["seg_loss"] > 0)
    assert set(gc) == set(gv)
    assert any(k.startswith("refinement") for k in gc) == two
    assert any(k.startswith("pnets") for k in gc) == two
    for name, g in gc.items():
        assert bool(torch.isfinite(g).all()), name


@pytest.fixture(scope="module")
def column_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("pv_column")
    write_fake_kitti(str(root / "kitti"), pv_cfg(), n_frames=4)
    (root / "splits").mkdir()
    (root / "splits" / "train.txt").write_text("0\n1\n")
    (root / "splits" / "val.txt").write_text("2\n3\n")
    yml = root / "pv_column.yaml"
    yml.write_text(yaml.safe_dump({**_yaml_doc(root), "SPARSE_BACKEND": "column"}))
    return root, yml


@pytest.mark.parametrize("mode", ["pvrcnn", "pvrcnn2"])
def test_train_cli_then_eval_cli_on_columns(column_set, mode):
    """train_cli --model pvrcnn|pvrcnn2 on a column yaml takes a step and
    checkpoints; eval_cli --ckpt evaluates it on columns."""
    root, yml = column_set
    recs = train_cli.main(["--config", str(yml), "--model", mode, "--batch-size", "2",
                           "--workers", "0", "--epochs", "1", "--ckpt-dir",
                           str(root / f"ck_{mode}"), "--metrics-jsonl",
                           str(root / f"{mode}.jsonl"), "--device", "cpu"])
    assert len(recs) == 1 and recs[0]["steps"] == 1
    assert np.isfinite(recs[0]["losses"]).all()
    table, timing = eval_cli.main(["--config", str(yml), "--model", mode, "--ckpt",
                                   recs[0]["checkpoint"], "--batch-size", "2",
                                   "--device", "cpu"])
    assert timing["frames"] == 2 and all(np.isfinite(v) for v in table[0].values())
