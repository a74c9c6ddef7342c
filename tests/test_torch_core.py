"""PyTorch port vs the JAX package: config, anchors, box codec,
voxelizer, rotated IoU, NMS, and the port's import boundary.

Inputs are made with numpy from a seed and fed to both; everything runs
on the CPU. Integer outputs must be equal; float tolerances are stated
where they are used.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision3d_tpu.config import Config
from vision3d_tpu.core.voxelize import mean_vfe as j_mean_vfe
from vision3d_tpu.core.voxelize import voxelize_batch as j_voxelize_batch
from vision3d_tpu.core import anchors as janchors
from vision3d_tpu.core import boxes as jboxes
from vision3d_tpu.core import iou as jiou
from vision3d_tpu.core import nms as jnms
from vision3d_tpu_torch.config import Config as TConfig
from vision3d_tpu_torch.core import anchors as tanchors
from vision3d_tpu_torch.core import boxes as tboxes
from vision3d_tpu_torch.core import iou as tiou
from vision3d_tpu_torch.core import nms as tnms
from vision3d_tpu_torch.core import voxelize as tvox

from torch_parity import port_cfg, uniform_points

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLD = ROOT / "tests" / "goldens"


def test_port_imports_nothing_of_jax():
    """Importing every module of the port (and chip_smoke.py and the GPU
    tools tools/microbench_torch_*.py, tools/profile_torch_*.py) must load
    no jax, flax, optax, orbax or vision3d_tpu module, and neither cv2, PIL
    nor tensorboard, which the card's host lacks."""
    mods = sorted(
        "vision3d_tpu_torch." + ".".join(p.relative_to(ROOT / "vision3d_tpu_torch")
                                         .with_suffix("").parts)
        for p in (ROOT / "vision3d_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    tools = sorted(str(p) for pat in ("microbench_torch_*.py", "profile_torch_*.py")
                   for p in (ROOT / "tools").glob(pat))
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {mods!r} + ['chip_smoke']: importlib.import_module(m)\n"
        f"for i, path in enumerate({tools!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'tool{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vision3d_tpu', 'cv2', 'PIL', "
        "'tensorboard', 'tensorflow'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(mods) >= 25 and len(tools) >= 4
    for new in ("core.targets", "models.losses", "ops.gather_gemm", "ops.gather_rows",
                "training.train", "training.checkpoint", "training.metrics",
                "ops.column_sparse", "ops.column_conv", "core.iou_host",
                "core.preprocess", "data.kitti", "data.augment", "data.loader",
                "eval.kitti_eval", "eval_cli", "train_cli", "inference_cli",
                "utils.bev_drawer", "ops.fps", "ops.ball_query", "models.pointnet",
                "models.refinement", "models.pvrcnn", "parallel.mesh"):
        assert "vision3d_tpu_torch." + new in mods


@pytest.mark.parametrize("name", ["all_classes", "car", "car_cpu_small", "car_tiny"])
def test_config_parses_yaml_like_jax(name):
    path = ROOT / "configs" / "second" / f"{name}.yaml"
    ours, ref = TConfig.from_yaml(str(path)), Config.from_yaml(str(path))
    # the port's own Voxel R-CNN field stays at its default
    assert dataclasses.asdict(ours) == dataclasses.asdict(port_cfg(ref))
    assert ours.grid_shape_zyx == ref.grid_shape_zyx
    assert ours.bev_shape == ref.bev_shape
    assert [ours.stage_voxel_capacity(i) for i in range(5)] == [
        ref.stage_voxel_capacity(i) for i in range(5)]
    assert [ours.stage_column_capacity(i) for i in range(5)] == [
        ref.stage_column_capacity(i) for i in range(5)]


def test_anchor_grid_golden_and_jax():
    g = np.load(GOLD / "anchors.npz")
    anchors = tanchors.make_anchors(TConfig())
    assert tuple(anchors.shape) == tuple(g["shape"])
    not_z = [0, 1, 3, 4, 5, 6]
    np.testing.assert_allclose(anchors[:, :, ::17, ::13][..., not_z],
                               g["sample"][..., not_z], atol=1e-5)
    for path in ("configs/second/all_classes.yaml", "configs/second/car.yaml"):
        np.testing.assert_array_equal(
            tanchors.make_anchors(TConfig.from_yaml(str(ROOT / path))),
            janchors.make_anchors(Config.from_yaml(str(ROOT / path))))


def test_box_codec_golden_and_jax():
    g = np.load(GOLD / "box_encode.npz")
    enc = tboxes.encode(torch.from_numpy(g["boxes"]), torch.from_numpy(g["anchors"]))
    dec = tboxes.decode(torch.from_numpy(g["deltas"]), torch.from_numpy(g["anchors"]))
    # f32 log/exp differ by a few ULP between libraries (the golden's own
    # tolerance in tests/test_boxes.py)
    np.testing.assert_allclose(enc.numpy(), g["encoded"], rtol=1e-5, atol=2e-4)
    np.testing.assert_allclose(dec.numpy(), g["decoded"], rtol=1e-5, atol=2e-4)
    rng = np.random.default_rng(3)
    deltas = rng.normal(0, 4, (64, 7)).astype(np.float32)  # some hit the clamp
    deltas[:4, 3:6] = [[30.0, -30.0, 12.0]] * 4
    anchors = g["anchors"][:64]
    ref = np.asarray(jboxes.decode(jnp.asarray(deltas), jnp.asarray(anchors)))
    got = tboxes.decode(torch.from_numpy(deltas), torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


def _voxel_cases(tiny_cfg):
    rng = np.random.default_rng(11)
    pts, num = uniform_points(tiny_cfg, rng, 3, 900)
    pts[:, ::37, 0] = -5.0                     # out of range: dropped
    num[1] = 400                               # padded tail ignored
    pts[2, :200, :3] = pts[2, :1, :3]          # one voxel, > K points
    return {
        "tiny": (tiny_cfg, pts, num),
        "cap16": (tiny_cfg.replace(max_voxels=16), pts, num),
        "cap_exact": (tiny_cfg.replace(max_voxels=4096), pts, num),
    }


@pytest.mark.parametrize("case", ["tiny", "cap16", "cap_exact"])
def test_voxelize_bit_equal(tiny_cfg, case):
    cfg, pts, num = _voxel_cases(tiny_cfg)[case]
    ref = j_voxelize_batch(jnp.asarray(pts), jnp.asarray(num), cfg)
    got = tvox.voxelize_batch(torch.from_numpy(pts), torch.from_numpy(num),
                              port_cfg(cfg))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    # mean VFE: the K-sum may be taken in another order (1 ulp)
    np.testing.assert_allclose(
        tvox.mean_vfe(got["features"], got["occupancy"]).numpy(),
        np.asarray(j_mean_vfe(ref["features"], ref["occupancy"])),
        rtol=1e-6, atol=1e-6)


def test_rotated_iou_golden():
    g = np.load(GOLD / "rotated_iou.npz")
    pairs = torch.from_numpy(g["pairs"].astype(np.float32))
    ours = tiou.rotated_iou(pairs[:, :5], pairs[:, 5:], "degrees").numpy()
    # the JAX package's own f32 tolerance against the reference kernel
    np.testing.assert_allclose(ours, g["ious"], atol=2e-4)


@pytest.mark.parametrize("mode", ["degrees", "radians"])
def test_rotated_iou_matches_jax(mode):
    rng = np.random.default_rng(5)
    b = np.column_stack([rng.uniform(0, 6, (300, 2)), rng.uniform(0.5, 4, (300, 2)),
                         rng.uniform(-3, 3, (300, 1))]).astype(np.float32)
    ref = np.asarray(jiou.rotated_iou(jnp.asarray(b[:150]), jnp.asarray(b[150:]), mode))
    got = tiou.rotated_iou(torch.from_numpy(b[:150]), torch.from_numpy(b[150:]),
                           mode).numpy()
    # float32 trig/atan2 of two libraries: a few ulp on areas of O(10)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_nms_keep_sets_equal(seed):
    rng = np.random.default_rng(seed)
    b, k = 2, 96
    boxes = np.concatenate([rng.uniform(0, 20, (b, k, 2)), rng.uniform(1, 5, (b, k, 2)),
                            rng.uniform(-3, 3, (b, k, 1))], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
    scores[:, 10:20] = scores[:, :1]                  # ties: lower index first
    groups = rng.integers(0, 3, (b, k)).astype(np.int32)
    valid = rng.uniform(size=(b, k)) > 0.1
    thr = [0.01, 0.1, 0.3, 0.5][seed]
    got = tnms.nms_rotated(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(groups), torch.from_numpy(valid),
                           iou_threshold=thr).numpy()
    for i in range(b):
        ref = np.asarray(jnms.nms_rotated(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(groups[i]),
            jnp.asarray(valid[i]), iou_threshold=thr))
        np.testing.assert_array_equal(got[i], ref)
