"""Evaluation and entry points of the port against the JAX package on the
CPU: the AP@R40 evaluator on identical detection lists, run_eval end to end
with the trained 3-class weights, and the three CLIs (train_cli with
checkpoint and resume, eval_cli, inference_cli's BEV image)."""

import dataclasses
import json
import os
import struct
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vision3d_tpu.config import Config
from vision3d_tpu.eval import kitti_eval as jeval
from vision3d_tpu_torch import convert, eval_cli, inference_cli, train_cli
from vision3d_tpu_torch.eval import kitti_eval as teval
from vision3d_tpu_torch.models.second import create_second

from test_data import write_fake_kitti
from torch_parity import ROOT, WEIGHTS, YAML, port_cfg


def _boxes(rng, n, spread=30.0):
    xyz = rng.uniform([0, -spread / 2, -2], [spread, spread / 2, 0], (n, 3))
    wlh = rng.uniform([0.5, 0.6, 1.4], [1.9, 4.5, 1.9], (n, 3))
    return np.column_stack([xyz, wlh, rng.uniform(-np.pi, np.pi, n)]).astype(np.float32)


def _detection_lists(seed, frames=12, classes=3):
    """Ground truths with levels 1-4, and detections that are jittered
    copies of most of them (some ignored, some missed) plus false
    positives: IoUs spread across the class thresholds."""
    rng = np.random.default_rng(seed)
    dets, gts = [], []
    for _ in range(frames):
        g = _boxes(rng, int(rng.integers(0, 9)))
        gcls = rng.integers(0, classes, len(g))
        levels = rng.integers(1, 5, len(g))
        hit = rng.random(len(g)) < 0.8
        jit = np.column_stack([rng.normal(0, 0.15, (hit.sum(), 3)),
                               rng.normal(0, 0.08, (hit.sum(), 3)),
                               rng.normal(0, 0.1, (hit.sum(), 1))]).astype(np.float32)
        d = np.concatenate([g[hit] + jit, _boxes(rng, int(rng.integers(0, 4)))])
        dcls = np.concatenate([gcls[hit], rng.integers(0, classes, len(d) - hit.sum())])
        scores = rng.uniform(0.05, 1.0, len(d)).astype(np.float32)
        dets.append(dict(boxes=d, scores=scores, class_idx=dcls))
        gts.append(dict(boxes=g, class_idx=gcls, levels=levels))
    return dets, gts


def test_box3d_iou_matrix_bit_equal():
    rng = np.random.default_rng(3)
    a = _boxes(rng, 40, spread=8)
    b = np.concatenate([a[:20] + rng.normal(0, 0.2, (20, 7)).astype(np.float32),
                        _boxes(rng, 15, spread=8)])
    got, want = teval.box3d_iou_matrix(a, b), jeval.box3d_iou_matrix(a, b)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert ((want > 0.3) & (want < 0.9)).sum() > 10


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ap_tables_equal(seed):
    dets, gts = _detection_lists(seed)
    table = teval.evaluate_all(dets, gts, 3)
    assert table == jeval.evaluate_all(dets, gts, 3)
    assert any(0 < v < 100 for row in table.values() for v in row.values())
    for c in range(3):
        for d in (1, 2, 3):
            assert (teval.evaluate_pooled(dets, gts, c, d)
                    == jeval.evaluate_pooled(dets, gts, c, d))
            assert teval.evaluate(dets, gts, c, d) == table[c][
                {1: "easy", 2: "moderate", 3: "hard"}[d]]


def test_thresholds_and_pooled_ap_equal():
    rng = np.random.default_rng(8)
    scores = rng.random(57)
    for n_gt in (1, 10, 57, 90):
        assert teval.get_thresholds(scores, n_gt) == jeval.get_thresholds(scores, n_gt)
    tp = rng.random(57) < 0.6
    assert (teval.average_precision_r40(scores, tp, ~tp, 40)
            == jeval.average_precision_r40(scores, tp, ~tp, 40))


# --- run_eval end to end, trained 3-class weights, small geometry ---------

# the small geometry of chip_smoke.small_geometry_cfg, at a capacity that
# keeps every point of the scan
SMALL = dict(max_voxels=2048, voxel_size=(0.2, 0.2, 0.1),
             grid_bounds=(0.0, -12.8, -3.0, 25.6, 12.8, 1.0))
# the AP cross-check yardstick of tests/test_torch_convert.py
BOX_TOL, SCORE_TOL = 0.0077, 0.0008


@pytest.fixture(scope="module")
def synth_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth3")
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_synthetic_kitti.py"),
                    "--out", str(root), "--classes", "all", "--train", "1",
                    "--val", "2", "--seed", "1"], check=True, capture_output=True)
    cfg = Config.from_yaml(str(YAML)).replace(**SMALL)
    return cfg.replace(
        capacity=cfg.capacity.__class__(max_points=20000),
        data=dataclasses.replace(cfg.data, rootdir=str(root / "training"),
                                 splitdir=str(root / "splitfiles"),
                                 cachedir=str(root / "cache")))


def _capture(monkeypatch, module):
    """Record the detection and ground-truth lists ``module.evaluate_all``
    is called with."""
    seen = {}
    orig = module.evaluate_all

    def evaluate_all(dets, gts, num_classes=3):
        seen.update(dets=dets, gts=gts)
        return orig(dets, gts, num_classes)

    monkeypatch.setattr(module, "evaluate_all", evaluate_all)
    return seen


def test_run_eval_matches_jax(synth_tree, monkeypatch):
    from vision3d_tpu.data.kitti import KittiDataset as JDataset
    from vision3d_tpu.eval_cli import run_eval as j_run_eval
    from vision3d_tpu.models.second import Second
    from vision3d_tpu_torch.data.kitti import KittiDataset as TDataset

    cfg = synth_tree
    jseen, tseen = _capture(monkeypatch, jeval), _capture(monkeypatch, teval)
    variables = jax.tree_util.tree_map(jnp.asarray, convert.load_npz(WEIGHTS))
    jtable = j_run_eval(cfg, Second(cfg), variables, JDataset(cfg, verbose=False),
                        batch_size=2, verbose=False)
    tcfg = port_cfg(cfg)
    model, anchors = create_second(tcfg, device="cpu", state_dict=convert.state_dict_from_flax(
        convert.load_npz(WEIGHTS)))
    with torch.backends.mkldnn.flags(enabled=False):
        ttable, timing = eval_cli.run_eval(tcfg, model, anchors,
                                           TDataset(tcfg, verbose=False),
                                           batch_size=2, verbose=False)
    assert timing["frames"] == 2 and timing["seconds"] > 0
    n_det = 0
    for jd, td, jg, tg in zip(jseen["dets"], tseen["dets"], jseen["gts"], tseen["gts"],
                              strict=True):
        for k in jg:
            np.testing.assert_array_equal(tg[k], jg[k])
        np.testing.assert_array_equal(td["class_idx"], jd["class_idx"])
        if len(jd["boxes"]):
            assert np.abs(td["boxes"] - jd["boxes"]).max() <= BOX_TOL
            assert np.abs(td["scores"] - jd["scores"]).max() <= SCORE_TOL
        n_det += len(jd["boxes"])
    assert n_det > 0
    assert sum(len(g["boxes"]) for g in jseen["gts"]) > 0
    # every detection's IoU with every gt lies far from the class thresholds
    # here, so the tables are equal, not only close
    assert ttable == jtable


def test_golden_ap_table_is_of_this_generator(tmp_path):
    """chip_smoke.py holds the port's AP against the JAX table in this
    golden; the set it regenerates must be the one the table was made on."""
    from chip_smoke import GOLDEN, labels_sha256

    golden = json.loads(GOLDEN.read_text())
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_synthetic_kitti.py"),
                    "--out", str(tmp_path), *golden["generator_args"]], check=True,
                   capture_output=True)
    val = np.loadtxt(tmp_path / "splitfiles" / "val.txt", dtype=np.int64).tolist()
    assert len(val) == 48 and labels_sha256(tmp_path, val) == golden["val_labels_sha256"]
    assert len(golden["table"]) == 3 and all(len(r) == 3 for r in golden["table"].values())


# --- the CLIs on the mini tree of tests/test_cli.py -----------------------

TINY_YAML = {
    "MAX_VOXELS": 512,
    "VOXEL_SIZE": [0.4, 0.4, 0.1],
    "GRID_BOUNDS": [0.0, -12.8, -3.0, 25.6, 12.8, 1.0],
    "NUM_CLASSES": 1,
    "ANCHORS": [dict(names=["Car"], wlh=[1.6, 3.9, 1.56], yaw=[0, 1.501],
                     iou_thresh=[0.45, 0.6], score_thresh=0.3, center_z=-1.0)],
    "AUG": {"NUM_SAMPLE_OBJECTS": [2, 0, 0]},
    "CAPACITY": {"MAX_POINTS": 1024, "MAX_GT_BOXES": 16},
    "PROPOSAL": {"C_IN": 128, "TOPK": 8},
}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One tiny epoch of train_cli on the CPU, then one more by --resume:
    (yaml path, root, the two runs' records)."""
    root = tmp_path_factory.mktemp("mini")
    write_fake_kitti(str(root / "kitti"), Config(), n_frames=4)
    os.makedirs(root / "splits")
    (root / "splits" / "val.txt").write_text("0\n1\n")
    (root / "splits" / "train.txt").write_text("2\n3\n")
    doc = dict(TINY_YAML, DATA={"CACHEDIR": str(root / "cache"),
                                "SPLITDIR": str(root / "splits"),
                                "ROOTDIR": str(root / "kitti")})
    yml = root / "tiny.yaml"
    yml.write_text(yaml.safe_dump(doc))
    args = ["--config", str(yml), "--batch-size", "2", "--workers", "0",
            "--ckpt-dir", str(root / "ckpts"), "--metrics-jsonl", str(root / "m.jsonl"),
            "--device", "cpu"]
    first = train_cli.main(args + ["--epochs", "1"])
    resumed = train_cli.main(args + ["--epochs", "2", "--resume"])
    return yml, root, first, resumed


def test_train_cli_trains_saves_and_resumes(trained):
    yml, root, first, resumed = trained
    assert [r["epoch"] for r in first] == [0] and [r["epoch"] for r in resumed] == [1]
    for rec in first + resumed:
        assert rec["steps"] == 1 and np.isfinite(rec["losses"]).all()
        assert rec["frames_per_s"] > 0 and 0 <= rec["host_wait_s"] <= rec["seconds"]
        assert os.path.isfile(rec["checkpoint"])
    assert first[0]["checkpoint"].endswith("epoch_0")
    assert resumed[0]["checkpoint"].endswith("epoch_1")
    ckpt = torch.load(resumed[0]["checkpoint"], weights_only=True)
    assert ckpt["step"] == 2
    assert (root / "m.jsonl").exists()
    assert os.path.isfile(root / "cache" / "train.torch.pkl")


def test_eval_cli_on_a_trained_checkpoint(trained, tmp_path):
    yml, root, _, resumed = trained
    out = tmp_path / "ap.json"
    table, timing = eval_cli.main(["--config", str(yml), "--ckpt", resumed[0]["checkpoint"],
                                   "--batch-size", "2", "--out-json", str(out),
                                   "--device", "cpu"])
    assert timing["frames"] == 2
    saved = json.loads(out.read_text())
    assert set(saved) == {"0"} and set(saved["0"]) == {"easy", "moderate", "hard"}
    assert all(0.0 <= v <= 100.0 for v in saved["0"].values())
    assert saved["0"] == table[0]


def test_eval_cli_runs_voxel_rcnn(trained, tmp_path):
    """``--model voxel_rcnn`` on the mini tree: fresh seeded weights, the
    config's geometry with Voxel R-CNN's architecture, an AP table."""
    yml, _, _, _ = trained
    table, timing = eval_cli.main(["--config", str(yml), "--model", "voxel_rcnn",
                                   "--batch-size", "2", "--device", "cpu"])
    assert timing["frames"] == 2 and set(table) == {0}
    assert all(0.0 <= v <= 100.0 for v in table[0].values())


def _decode_png(data):
    """The RGB array of a PNG written by ``bev_drawer.write_png``: one
    IDAT, 8-bit truecolour, filter 0 on every row."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(kind + body)
        chunks[kind] = body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, color) == (8, 2) and b"IEND" in chunks
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_inference_cli_writes_the_jax_bev_image(trained, tmp_path, monkeypatch, capsys):
    """--ckpt from train_cli, --out: the PNG's pixels equal the JAX
    package's Drawer image (its numpy line drawer) of the same points and
    detections."""
    from vision3d_tpu.utils import bev_drawer as jdrawer

    yml, root, _, resumed = trained
    doc = yaml.safe_load(yml.read_text())
    # two steps leave batch-norm statistics that drive every score to 0 in
    # eval mode: a threshold below 0 keeps the boxes to draw
    doc["ANCHORS"][0]["score_thresh"] = -1.0
    yml0 = tmp_path / "thresh0.yaml"
    yml0.write_text(yaml.safe_dump(doc))
    velo = root / "kitti" / "velodyne" / "000000.bin"
    out = tmp_path / "dets.png"
    dets = inference_cli.main(["--config", str(yml0), "--ckpt", resumed[0]["checkpoint"],
                               "--velo", str(velo), "--out", str(out), "--device", "cpu"])
    assert len(dets["boxes"]) > 0
    assert f"wrote {out}" in capsys.readouterr().out
    monkeypatch.setattr(jdrawer, "cv2", None)
    points = np.fromfile(velo, np.float32).reshape(-1, 4)
    want = jdrawer.Drawer(points, [dets["boxes"]]).image
    got = _decode_png(out.read_bytes())
    np.testing.assert_array_equal(got, want)


def test_bev_drawer_matches_jax(monkeypatch):
    """Points and box outlines (some crossing the image's edge) drawn by
    the port and by the JAX package's numpy line drawer."""
    from vision3d_tpu.utils import bev_drawer as jdrawer
    from vision3d_tpu_torch.utils import bev_drawer as tdrawer

    monkeypatch.setattr(jdrawer, "cv2", None)
    rng = np.random.default_rng(2)
    points = rng.uniform([-5, -35, -2, 0], [65, 35, 1, 1], (20000, 4)).astype(np.float32)
    boxes = _boxes(rng, 12, spread=70)
    got = tdrawer.Drawer(points, [boxes[:6], boxes[6:]]).image
    np.testing.assert_array_equal(got, jdrawer.Drawer(points, [boxes[:6], boxes[6:]]).image)
    assert (got == [0, 255, 0]).all(-1).sum() > 100      # box outlines drawn
    np.testing.assert_array_equal(_decode_png(tdrawer.encode_png(got)), got)


def test_clis_refuse_what_is_not_ported(trained, tmp_path):
    """eval_cli runs PV-RCNN (tests/test_torch_pvrcnn.py) but refuses to load
    SECOND's weights into it. Dense late stages in training are ported:
    train_cli --dense-from 2 trains an epoch and writes its checkpoint."""
    yml = str(trained[0])
    with pytest.raises(ValueError, match="not a PV-RCNN"):
        eval_cli.main(["--config", yml, "--model", "pvrcnn", "--weights", str(WEIGHTS),
                       "--device", "cpu"])
    recs = train_cli.main(["--config", yml, "--dense-from", "2", "--batch-size", "2",
                           "--workers", "0", "--epochs", "1", "--ckpt-dir", str(tmp_path),
                           "--metrics-jsonl", str(tmp_path / "m.jsonl"), "--device", "cpu"])
    assert len(recs) == 1 and recs[0]["steps"] == 1 and np.isfinite(recs[0]["losses"]).all()
    assert os.path.isfile(recs[0]["checkpoint"])


def test_train_cli_on_a_column_backend_yaml(trained, tmp_path):
    """A yaml with ``SPARSE_BACKEND: column`` trains on the column backend,
    as the JAX package's train_cli does (no flag), and its checkpoint
    evaluates on the voxel backend: one state dict serves both."""
    yml, root, _, _ = trained
    doc = yaml.safe_load(yml.read_text())
    doc["SPARSE_BACKEND"] = "column"
    col = tmp_path / "column.yaml"
    col.write_text(yaml.safe_dump(doc))
    recs = train_cli.main(["--config", str(col), "--batch-size", "2", "--workers", "0",
                           "--epochs", "1", "--ckpt-dir", str(tmp_path / "ck"),
                           "--metrics-jsonl", str(tmp_path / "m.jsonl"), "--device", "cpu"])
    assert len(recs) == 1 and recs[0]["steps"] == 1 and np.isfinite(recs[0]["losses"]).all()
    table, timing = eval_cli.main(["--config", str(yml), "--ckpt", recs[0]["checkpoint"],
                                   "--batch-size", "2", "--device", "cpu"])
    assert timing["frames"] == 2
    assert all(0.0 <= v <= 100.0 for row in table.values() for v in row.values())


def test_tensorboard_writer(tmp_path):
    from vision3d_tpu_torch.training.metrics import MetricLogger, TensorBoardWriter

    logger = MetricLogger(writers=[TensorBoardWriter(str(tmp_path / "tb"))], interval=1)
    logger.update(1, {"loss": 2.5})
    assert any(f.startswith("events.") for f in os.listdir(tmp_path / "tb"))
