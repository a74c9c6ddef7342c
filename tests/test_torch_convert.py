"""Trained weights across the bridge: tools/export_torch_weights.py
restores ckpts_synth_r05_3c/epoch_11 through the JAX package, convert.py
loads it into the port, and both models run at tiny_cfg geometry with the
3 trained classes (conv weights do not depend on the grid). Held to the
AP cross-check yardstick (AP_r05_crosscheck.json): equal detection
counts, box delta <= 0.0077, score delta <= 0.0008."""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vision3d_tpu.config import Config
from vision3d_tpu.core.anchors import make_anchors
from vision3d_tpu.models.second import Second
from vision3d_tpu_torch import convert, inference_cli
from vision3d_tpu_torch.models import second as tsecond

from torch_parity import ROOT, WEIGHTS, YAML, port_cfg
from torch_parity import kitti_like_frames as _frames

CKPT = ROOT / "ckpts_synth_r05_3c" / "epoch_11"


def _export_tool():
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights", ROOT / "tools" / "export_torch_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    out = tmp_path_factory.mktemp("weights") / "epoch_11.npz"
    _export_tool().export(str(CKPT), str(YAML), str(out))
    return convert.load_npz(out)


@pytest.fixture(scope="module")
def cfg3(tiny_cfg):
    full = Config.from_yaml(str(YAML))
    return tiny_cfg.replace(num_classes=3, anchors=full.anchors)


def test_committed_weights_are_the_export(exported):
    committed = convert.load_npz(WEIGHTS)
    flat_a = jax.tree_util.tree_leaves_with_path(committed)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(exported))
    assert len(flat_a) == len(flat_b) == 109
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])


@pytest.mark.parametrize("seed", [0, 1])
def test_trained_weights_inference_matches_jax(exported, cfg3, seed):
    pts, num = _frames(cfg3, seed)
    anchors = jnp.asarray(make_anchors(cfg3))
    det, diag = jax.jit(lambda p, n: Second(cfg3).apply(
        exported, p, n, anchors, method=Second.inference,
        mutable=["diagnostics"]))(jnp.asarray(pts), jnp.asarray(num))
    model, tanchors = tsecond.create_second(
        port_cfg(cfg3), device="cpu", state_dict=convert.state_dict_from_flax(exported))
    with torch.no_grad():
        tdet, tdiag = model.inference(torch.from_numpy(pts), torch.from_numpy(num),
                                      tanchors)
    assert int(np.asarray(diag["diagnostics"]["cnn"]["stage1_dropped"])) == int(
        tdiag["stage1_dropped"])
    valid = np.asarray(det.valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(tdet.valid.numpy().sum(1), valid.sum(1))
    np.testing.assert_array_equal(tdet.valid.numpy(), valid)
    box_delta = np.abs(tdet.boxes.numpy() - np.asarray(det.boxes))[valid].max()
    score_delta = np.abs(tdet.scores.numpy() - np.asarray(det.scores))[valid].max()
    assert box_delta <= 0.0077 and score_delta <= 0.0008, (box_delta, score_delta)


def test_inference_cli_prints_detections(tmp_path, capsys, cfg3):
    pts, _ = _frames(cfg3, 2, batch=1)
    velo = tmp_path / "000000.bin"
    pts[0].astype(np.float32).tofile(velo)
    doc = yaml.safe_load(YAML.read_text())
    doc.update(MAX_VOXELS=512, VOXEL_SIZE=[0.4, 0.4, 0.1],
               GRID_BOUNDS=[0.0, -12.8, -3.0, 25.6, 12.8, 1.0],
               CAPACITY={"MAX_POINTS": 2048})
    yaml_path = tmp_path / "tiny3.yaml"
    yaml_path.write_text(yaml.safe_dump(doc))
    inference_cli.main(["--config", str(yaml_path), "--weights", str(WEIGHTS),
                        "--velo", str(velo), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines and all(ln.startswith("class=") and " yaw=" in ln for ln in lines)
