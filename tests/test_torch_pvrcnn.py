"""PV-RCNN inference, the port against the JAX package on the CPU, at the
size of tests/test_pvrcnn.py's ``pv_cfg`` (64 keypoints, 256 voxels, top
8 proposals, 4 grid points): the middle extractor's four scales and
``to_global``, stage 1's keypoints and point features, RoI grid pooling,
refinement, the two-stage outputs, both inference paths, the weight
mapping, the fresh init, and ``eval_cli --model pvrcnn|pvrcnn2``.

The JAX model is built once. One train-mode step of its own gives every
batch norm its batch statistics (read back from the running update: old +
(new - old) / (1 - momentum)), so the untrained model's activations stay
near unit scale and its boxes near anchor size; then seeded noise goes on
every batch statistic, scale and bias, so no batch norm is an identity.
The anchors' score threshold is 0, so the keep sets are NMS's alone. JAX
is applied only under ``jax.jit``. The port gets the same weights through ``convert.py`` and JAX's grid-point
draws. Integer outputs (keypoints, keys, keep sets) must be equal; float
outputs are held to a stated share of their scale, with oneDNN off.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vision3d_tpu.config import Config
from vision3d_tpu.core.anchors import make_anchors
from vision3d_tpu.core.voxelize import voxelize_batch as j_voxelize_batch
from vision3d_tpu.models.head import head_inference, multiclass_nms
from vision3d_tpu.models.pvrcnn import PV_RCNN as JPV
from vision3d_tpu.models.refinement import apply_refinements, refine_topk
from vision3d_tpu.models.second import build_middle_input as j_build_middle_input
from vision3d_tpu.models.sparse_cnn import to_global as j_to_global
from vision3d_tpu_torch import convert, eval_cli
from vision3d_tpu_torch.models import pvrcnn as tpv
from vision3d_tpu_torch.models.sparse_cnn import to_global

from test_data import write_fake_kitti
from test_torch_pointnet import perturb
from torch_parity import port_cfg, uniform_points

# float32 in other orders through the trunk's 14 convs, the GEMMs and the
# set abstraction's masked maxima: 1e-5 of each output's scale (the
# SECOND parity tests' bound)
TOL = 1e-5


def pv_cfg():
    cfg = Config()
    return cfg.replace(
        max_voxels=256, voxel_size=(0.4, 0.4, 0.1),
        grid_bounds=(0.0, -12.8, -3.0, 25.6, 12.8, 1.0), num_classes=1,
        num_keypoints=64,
        anchors=(dataclasses.replace(cfg.anchors[0], score_thresh=0.0),),
        capacity=cfg.capacity.__class__(max_points=512, max_gt_boxes=8,
                                        max_detections=16),
        proposal=cfg.proposal.__class__(c_in=128, topk=8),
        gridpool=cfg.gridpool.__class__(
            num_gridpoints=4, radii_pn=(0.8, 1.6),
            mlps_pn=((512, 32, 16), (512, 32, 16)), mlps_reduction=(4 * 32, 32, 32)),
        refinement=cfg.refinement.__class__(mlps=(32, 16)),
    )


def _inputs():
    """Batch 2: 400 uniform points, the second cloud with 250 valid."""
    cfg = pv_cfg()
    pts, num = uniform_points(cfg, np.random.default_rng(7), 2, 400)
    num[1] = 250
    return pts, num


def _everything(mdl, points, num, anchors, rng):
    """Every JAX output the tests compare, in one jitted graph that traces
    the model once (its compile is what this file's time is): stage 1's
    outputs come from ``two_stage``, which runs it, and the two inference
    paths are the last lines of ``PV_RCNN.inference`` (``head_inference``
    of stage 1's maps) and of ``inference_two_stage``, applied to them."""
    c = mdl.cfg
    st = j_build_middle_input(c, j_voxelize_batch(points, num, c))
    scales, _ = mdl.cnn(st, False, need_scales=True)
    glob = [j_to_global(s, c, stride)[0] for s, stride in zip(scales, c.strides)]
    two = mdl.two_stage(points, num, anchors, rng, False)
    fg = 1.0 - jax.nn.softmax(two["seg_logits"], axis=-1)[..., -1:]
    kp_mask = jnp.ones(two["keypoints"].shape[:2], bool)
    pooled = mdl.roi_grid_pool(rng, two["proposals"], two["keypoints"],
                               two["point_features"] * fg, kp_mask)
    refined = apply_refinements(two["box_deltas"], two["proposals"])
    conf = jax.nn.sigmoid(two["conf_logits"]) * two["proposal_scores"]
    b, k = refined.shape[0], c.proposal.topk
    return dict(
        scales=[(s.keys, s.mask, s.feats) for s in scales], glob=glob,
        stage1=(two["keypoints"], two["point_features"], two["cls_map"],
                two["reg_map"]),
        two=two, fg=fg, pooled=pooled, refined=mdl.refinement(pooled),
        inference=head_inference(two["cls_map"], two["reg_map"], anchors, c),
        two_stage_nms=multiclass_nms(refined.reshape(b, c.num_classes, k, c.box_dof),
                                     conf.reshape(b, c.num_classes, k), c),
        rerank=refine_topk(refined, conf, k))


@pytest.fixture(scope="module")
def jax_run():
    cfg = pv_cfg()
    model = JPV(cfg)
    anchors = jnp.asarray(make_anchors(cfg))
    pts, num = _inputs()
    key = jax.random.PRNGKey(1)

    @jax.jit
    def init_and_warm(p, n):
        v = model.init(jax.random.PRNGKey(0), p, n, anchors, key, train=False,
                       method=JPV.two_stage)
        _, upd = model.apply(v, p, n, anchors, key, train=True,
                             method=JPV.two_stage, mutable=["batch_stats"])
        return v, upd["batch_stats"]

    def batch_stat(path, old, new):
        m = 0.9 if any("SharedMLP" in str(k.key) for k in path) else 0.99
        return old + (new - old) / (1 - m)

    v, upd = jax.tree_util.tree_map(np.asarray, init_and_warm(pts, num))
    stats = jax.tree_util.tree_map_with_path(batch_stat, v["batch_stats"], upd)
    variables = perturb({"params": v["params"], "batch_stats": stats}, 9)
    out = jax.jit(lambda v, p, n: model.apply(v, p, n, anchors, key,
                                              method=_everything))(variables, pts, num)
    m = cfg.gridpool.num_gridpoints
    u = np.asarray(jax.random.uniform(key, (2, cfg.proposal.topk, m, 3)))
    return dict(cfg=cfg, variables=variables, pts=pts, num=num, u=u,
                out=jax.tree_util.tree_map(np.asarray, out))


@pytest.fixture(scope="module")
def port_run(jax_run):
    cfg = port_cfg(jax_run["cfg"])
    sd = convert.state_dict_from_flax(jax_run["variables"])
    model, anchors = tpv.create_pvrcnn(cfg, device="cpu", state_dict=sd)
    p, n = torch.from_numpy(jax_run["pts"]), torch.from_numpy(jax_run["num"])
    u = torch.from_numpy(jax_run["u"])
    out = {}
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        *_, scales = model.trunk(p, n, need_scales=True)
        out["scales"] = scales
        out["glob"] = [to_global(s, cfg, stride)[0] for s, stride in zip(scales, cfg.strides)]
        out["stage1"] = model.stage1(p, n)
        out["forward"] = model(p, n)
        out["two"], _ = model.two_stage(p, n, anchors, u=u)
        j = {k: torch.from_numpy(v) for k, v in jax_run["out"]["two"].items()}
        kp_mask = torch.ones(j["keypoints"].shape[:2], dtype=torch.bool)
        out["pooled"] = model.roi_grid_pool(
            j["proposals"], j["keypoints"],
            j["point_features"] * torch.from_numpy(jax_run["out"]["fg"]), kp_mask, u=u)
        out["refined"] = model.refinement(torch.from_numpy(jax_run["out"]["pooled"]))
        out["inference"], out["diag"] = model.inference(p, n, anchors)
        out["two_stage_nms"], _ = model.inference_two_stage(p, n, anchors, u=u)
        out["rerank"], _ = model.inference_two_stage(p, n, anchors, u=u, rerank_only=True)
    return dict(model=model, anchors=anchors, sd=sd, **out)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def test_state_dict_maps_every_leaf_both_ways(jax_run, port_run):
    """Every flax leaf maps, the load is strict, and the inverse map gives
    the same tree back."""
    model = tpv.PV_RCNN(port_cfg(jax_run["cfg"]))
    assert set(port_run["sd"]) == set(model.state_dict())
    model.load_state_dict(port_run["sd"], strict=True)
    back = convert.flax_from_state_dict(model.state_dict())
    flat = jax.tree_util.tree_flatten_with_path
    want = {jax.tree_util.keystr(k): v for k, v in flat(jax_run["variables"])[0]}
    got = {jax.tree_util.keystr(k): v for k, v in flat(back)[0]}
    assert set(got) == set(want) and len(want) > 100
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="not a PV-RCNN"):
        convert.pvrcnn_state_dict_from_flax(convert.load_npz(
            os.path.join(os.path.dirname(__file__), "..", "vision3d_tpu_torch",
                         "weights", "second_all_classes_epoch11.npz")))


@pytest.mark.parametrize("scale", [0, 1, 2, 3])
def test_scales_and_to_global_match_jax(jax_run, port_run, scale):
    """need_scales: the input, stages 0 and 1 (sparse) and stage 2 (dense,
    read back at its key set): keys and masks equal, features to 1e-5 of
    their scale; the voxels' metric origins equal to the bit."""
    keys, mask, feats = jax_run["out"]["scales"][scale]
    st = port_run["scales"][scale]
    np.testing.assert_array_equal(st.keys.numpy(), keys)
    np.testing.assert_array_equal(st.mask.numpy(), mask)
    assert mask.sum(1).min() > 0
    close(st.feats, feats)
    np.testing.assert_array_equal(port_run["glob"][scale].numpy(),
                                  jax_run["out"]["glob"][scale])


def test_stage1_matches_jax(jax_run, port_run):
    """FPS keypoints equal; point features (2 x 192 set abstraction + 128
    BEV) and the maps to 1e-5 of their scale."""
    kp, pf, cls_map, reg_map = jax_run["out"]["stage1"]
    tkp, tpf, tcls, treg, diag = port_run["stage1"]
    np.testing.assert_array_equal(tkp.numpy(), kp)
    assert pf.shape == (2, 64, 512)
    for a, b in ((tpf, pf), (tcls, cls_map), (treg, reg_map)):
        close(a, b)
    assert {k: int(v) for k, v in diag.items()} == {
        k: int(v) for k, v in port_run["diag"].items()}


def test_forward_runs_the_bev_branch_of_stage1(port_run):
    """forward (= inference's maps) equals stage 1's maps exactly."""
    tcls, treg, _ = port_run["forward"]
    assert torch.equal(tcls, port_run["stage1"][2])
    assert torch.equal(treg, port_run["stage1"][3])


def test_roi_grid_pool_and_refinement_match_jax(jax_run, port_run):
    """On JAX's proposals, keypoints and weighted features, with JAX's
    grid-point draws: the pooled features, then on JAX's pooled features
    the refinement's deltas and logits, to 1e-5 of their scale."""
    close(port_run["pooled"], jax_run["out"]["pooled"])
    for a, b in zip(port_run["refined"], jax_run["out"]["refined"]):
        close(a, b)


def test_two_stage_matches_jax(jax_run, port_run):
    want, got = jax_run["out"]["two"], port_run["two"]
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])


def test_inference_keep_sets_equal_jax(jax_run, port_run):
    """One stage (SECOND's head on PV-RCNN's weights) and two stages with
    NMS: keep sets equal, kept boxes and scores to 1e-5 of their scale."""
    for name in ("inference", "two_stage_nms"):
        det, tdet = jax_run["out"][name], port_run[name]
        valid = np.asarray(det.valid)
        np.testing.assert_array_equal(tdet.valid.numpy(), valid, err_msg=name)
        np.testing.assert_array_equal(tdet.class_idx.numpy(), det.class_idx)
        assert valid.any() and not valid.all(), name      # NMS suppressed some
        close(tdet.boxes.numpy()[valid], det.boxes[valid])
        close(tdet.scores.numpy()[valid], det.scores[valid])


def test_rerank_only_matches_jax(jax_run, port_run):
    """rerank_only: the top k by confidence, no NMS: indices equal."""
    boxes, scores, idx = jax_run["out"]["rerank"]
    tboxes, tscores, tidx = port_run["rerank"]
    np.testing.assert_array_equal(tidx.numpy(), idx)
    close(tboxes, boxes)
    close(tscores, scores)


def test_fresh_init_statistics():
    """init_pvrcnn draws the JAX package's distributions at full width:
    shared MLPs std sqrt(2/out), reduction and refinement MLPs
    normal(0.01) with zero biases, keypoint segmentation lecun-normal cut
    at 2.2737 std; the same seed gives the same weights."""
    cfg = port_cfg(Config())
    m1 = tpv.init_pvrcnn(tpv.PV_RCNN(cfg), torch.Generator().manual_seed(3))
    m2 = tpv.init_pvrcnn(tpv.PV_RCNN(cfg), torch.Generator().manual_seed(3))
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    w = m1.roi_grid_pool.sa.mlps[0].linears[0].weight            # (192, 515)
    np.testing.assert_allclose(float(w.detach().std()), (2 / 192) ** 0.5, rtol=0.05)
    w = m1.pnets[3].mlps[1].linears[1].weight                     # (64, 64)
    np.testing.assert_allclose(float(w.detach().std()), (2 / 64) ** 0.5, rtol=0.05)
    for lin in (m1.roi_grid_pool.mlp.linears[0], m1.refinement.mlp.linears[0]):
        np.testing.assert_allclose(float(lin.weight.detach().std()), 0.01, rtol=0.05)
    assert float(m1.refinement.mlp.linears[1].bias.detach().abs().max()) == 0.0
    assert float(m1.refinement.out.bias.detach().abs().max()) == 0.0
    w = m1.keypoint_seg.weight.detach()                           # (4, 512)
    sigma = (1 / 512) ** 0.5
    np.testing.assert_allclose(float(w.detach().std()), sigma, rtol=0.1)
    assert float(w.abs().max()) <= 2.2737 * sigma
    assert float(m1.keypoint_seg.bias.detach().abs().max()) == 0.0
    np.testing.assert_allclose(float(m1.cnn.subm[5].weight.detach().std()), (2 / 64) ** 0.5,
                               rtol=0.05)


def test_column_backend_scales_are_not_ported(port_run):
    """The refusal this test once held is gone: the port's PV_RCNN builds
    on a column config and loads the voxel backend's state dict strictly
    (tests/test_torch_pvrcnn_column.py holds its outputs against JAX)."""
    cfg = port_cfg(pv_cfg().replace(sparse_backend="column"))
    model = tpv.PV_RCNN(cfg)
    model.load_state_dict(port_run["sd"], strict=True)
    assert model.cfg.sparse_backend == "column"
    assert set(model.state_dict()) == set(port_run["model"].state_dict())


# --- eval_cli --model pvrcnn|pvrcnn2 on a small KITTI-format set ---------

@pytest.fixture(scope="module")
def mini_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("pv_mini")
    write_fake_kitti(str(root / "kitti"), Config(), n_frames=3)
    os.makedirs(root / "splits")
    (root / "splits" / "val.txt").write_text("0\n1\n2\n")
    doc = {
        "MAX_VOXELS": 256, "VOXEL_SIZE": [0.4, 0.4, 0.1],
        "GRID_BOUNDS": [0.0, -12.8, -3.0, 25.6, 12.8, 1.0], "NUM_CLASSES": 1,
        "NUM_KEYPOINTS": 64,
        "ANCHORS": [dict(names=["Car"], wlh=[1.6, 3.9, 1.56], yaw=[0, 1.501],
                         iou_thresh=[0.45, 0.6], score_thresh=0.3, center_z=-1.0)],
        "CAPACITY": {"MAX_POINTS": 1024, "MAX_GT_BOXES": 16},
        "PROPOSAL": {"C_IN": 128, "TOPK": 8},
        "GRIDPOOL": {"NUM_GRIDPOINTS": 4, "MLPS_PN": [[512, 32, 16], [512, 32, 16]],
                     "MLPS_REDUCTION": [128, 32, 32]},
        "REFINEMENT": {"MLPS": [32, 16]},
        "DATA": {"CACHEDIR": str(root / "cache"), "SPLITDIR": str(root / "splits"),
                 "ROOTDIR": str(root / "kitti")},
    }
    yml = root / "pv.yaml"
    yml.write_text(yaml.safe_dump(doc))
    return yml


@pytest.mark.parametrize("kind", ["pvrcnn", "pvrcnn2"])
def test_eval_cli_pvrcnn(mini_set, kind, tmp_path, monkeypatch):
    """eval_cli on the CPU: it runs, writes its table, and every batch's
    detections equal a direct call to a fresh seed-0 model (for pvrcnn2
    with a generator re-seeded 0)."""
    from vision3d_tpu_torch.config import Config as TConfig

    seen = []
    infer = eval_cli.infer_batch

    def record(model, model_kind, points, num_points, anchors):
        det = infer(model, model_kind, points, num_points, anchors)
        seen.append((model_kind, points, num_points, det))
        return det

    monkeypatch.setattr(eval_cli, "infer_batch", record)
    out = tmp_path / "ap.json"
    table, timing = eval_cli.main(["--config", str(mini_set), "--model", kind,
                                   "--batch-size", "2", "--out-json", str(out),
                                   "--device", "cpu"])
    assert timing["frames"] == 3 and len(seen) == 2
    assert out.exists() and set(table) == {0}
    model, anchors = tpv.create_pvrcnn(TConfig.from_yaml(str(mini_set)), device="cpu")
    for model_kind, p, n, det in seen:
        assert model_kind == kind
        with torch.no_grad():
            if kind == "pvrcnn2":
                want, _ = model.inference_two_stage(
                    p, n, anchors, generator=torch.Generator().manual_seed(0))
            else:
                want, _ = model.inference(p, n, anchors)
        for a, b in zip(det, want):
            assert torch.equal(a, b)
