"""The port's public ops surface and its last helpers against the JAX
package, on the CPU: ``ops.__all__``, the one-set and axis-aligned NMS
(keep sets equal), ``subsample_labels`` (masks equal given JAX's draws),
the native host library (outputs equal), and the profiler hooks
(``trace_if`` writing a trace that holds a program span)."""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision3d_tpu.ops as jops
from vision3d_tpu.config import Config
from vision3d_tpu.core import nms as jnms
from vision3d_tpu.core import targets as jtargets
from vision3d_tpu.core.preprocess import Preprocessor as JPreprocessor
from vision3d_tpu.data.kitti import Calib as JCalib
from vision3d_tpu.utils import native as jnative
from vision3d_tpu_torch import ops as tops
from vision3d_tpu_torch.core import nms as tnms
from vision3d_tpu_torch.core import targets as ttargets
from vision3d_tpu_torch.core.preprocess import Preprocessor as TPreprocessor
from vision3d_tpu_torch.data.kitti import Calib as TCalib
from vision3d_tpu_torch.training import profiler as tprofiler
from vision3d_tpu_torch.utils import native as tnative

from torch_parity import port_cfg


def test_ops_surface_equals_jax():
    """The same 17 names, each bound to a function of the port."""
    assert tops.__all__ == jops.__all__
    assert len(tops.__all__) == 17
    for name in tops.__all__:
        fn = getattr(tops, name)
        assert callable(fn) and fn.__module__.startswith("vision3d_tpu_torch."), name
    assert tops.box_iou_rotated is tops.pairwise_rotated_iou
    with pytest.raises(AttributeError):
        tops.no_such_op


def _rotated(rng, n, spread=20.0):
    return np.column_stack([rng.uniform(0, spread, (n, 2)), rng.uniform(2, 6, (n, 2)),
                            rng.uniform(-3, 3, (n, 1))]).astype(np.float32)


def _xyxy(rng, n):
    lo = rng.uniform(0, 30, (n, 2))
    return np.concatenate([lo, lo + rng.uniform(2, 8, (n, 2))], 1).astype(np.float32)


def _nms_case(name, rng):
    """(function name, args as numpy arrays, kwargs, {threshold: fixed
    keep mask} or None): the cases of tests/test_nms.py through the one-set
    entry points. The fixed masks are that file's expectations (identical
    boxes in two groups; two squares of IoU 81/119 = 0.68 and a far one);
    the other cases are held to JAX's call."""
    n = 64
    scores = rng.uniform(0, 1, n).astype(np.float32)
    groups = rng.integers(0, 3, n).astype(np.int32)
    valid = rng.uniform(size=n) < 0.8
    if name == "rotated_groups":
        return "batched_nms_rotated", (_rotated(rng, n), scores, groups), {}, None
    if name == "rotated_groups_do_not_interact":
        tile = np.tile(np.array([[5.0, 5.0, 2.0, 2.0, 0.0]], np.float32), (4, 1))
        return ("batched_nms_rotated", (tile, np.array([0.9, 0.8, 0.7, 0.6], np.float32),
                                        np.array([0, 0, 1, 1], np.int32)), {},
                dict.fromkeys((0.01, 0.3, 0.7), [True, False, True, False]))
    if name == "rotated_valid":
        return ("batched_nms_rotated", (_rotated(rng, n), scores, groups),
                {"valid": valid}, None)
    if name == "axis_aligned":
        return ("nms", (np.array([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]],
                                 np.float32), np.array([0.9, 0.8, 0.7], np.float32)), {},
                {0.01: [True, False, True], 0.3: [True, False, True],
                 0.7: [True, True, True]})
    if name == "axis_aligned_random":
        return "nms", (_xyxy(rng, n), scores), {"valid": valid}, None
    if name == "axis_aligned_groups":
        return "batched_nms", (_xyxy(rng, n), scores, groups), {}, None
    raise ValueError(name)


@pytest.mark.parametrize("case", ["rotated_groups", "rotated_groups_do_not_interact",
                                  "rotated_valid", "axis_aligned", "axis_aligned_random",
                                  "axis_aligned_groups"])
@pytest.mark.parametrize("thresh", [0.01, 0.3, 0.7])
def test_nms_keep_sets_equal_jax(case, thresh):
    name, args, kw, fixed = _nms_case(case, np.random.default_rng(7))
    got = getattr(tnms, name)(*(torch.from_numpy(a) for a in args),
                              **{k: torch.from_numpy(v) for k, v in kw.items()},
                              iou_threshold=thresh)
    assert got.shape == (len(args[0]),) and got.dtype == torch.bool
    if fixed is not None:
        np.testing.assert_array_equal(got.numpy(), fixed[thresh])
        return
    want = getattr(jnms, name)(*(jnp.asarray(a) for a in args),
                               **{k: jnp.asarray(v) for k, v in kw.items()},
                               iou_threshold=thresh)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and (thresh > 0.01 or not got.all())


@pytest.mark.parametrize("seed", range(4))
def test_subsample_labels_equals_jax_given_its_draws(seed):
    """JAX's masks from JAX's draws (the key's two halves), and the
    counts with the port's own generator."""
    rng = np.random.default_rng(seed)
    labels = rng.choice([-1, 0, 1, 2], size=200, p=[0.2, 0.5, 0.2, 0.1]).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    num, frac = (64, 0.25) if seed % 2 else (16, 0.5)
    want = jtargets.subsample_labels(key, jnp.asarray(labels), num, frac)
    kp, kn = jax.random.split(key)
    u_pos, u_neg = (torch.from_numpy(np.array(jax.random.uniform(k, (len(labels),))))
                    for k in (kp, kn))
    got = ttargets.subsample_choice(torch.from_numpy(labels), u_pos, u_neg, num, frac)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    pos, neg = ttargets.subsample_labels(torch.Generator().manual_seed(seed),
                                         torch.from_numpy(labels), num, frac)
    n_pos = min(int(num * frac), int(((labels != -1) & (labels != 0)).sum()))
    assert int(pos.sum()) == n_pos
    assert int(neg.sum()) == min(num - n_pos, int((labels == 0).sum()))
    assert ((labels[pos.numpy()] != -1) & (labels[pos.numpy()] != 0)).all()
    assert (labels[neg.numpy()] == 0).all()


@pytest.fixture
def tiny():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native host library cannot be built")
    assert tnative.available() and jnative.available()
    cfg = Config()
    return cfg.replace(max_voxels=512, voxel_size=(0.4, 0.4, 0.1),
                       grid_bounds=(0.0, -12.8, -3.0, 25.6, 12.8, 1.0))


def test_native_equals_jax(tiny):
    """hard_voxelize, points_in_cuboids_mask and filter_camera_fov of the
    port's library equal the JAX package's on seeded inputs, and
    voxelize_host equals JAX's Preprocessor.voxelize_host."""
    rng = np.random.default_rng(3)
    lo, hi = np.asarray(tiny.grid_bounds[:3]), np.asarray(tiny.grid_bounds[3:])
    pts = np.concatenate([rng.uniform(lo - 2, hi + 2, (6000, 3)),
                          rng.uniform(0, 1, (6000, 1))], 1).astype(np.float32)
    tcfg = port_cfg(tiny)
    got = tnative.hard_voxelize(pts, tcfg)
    want = jnative.hard_voxelize(pts, tiny)
    assert len(got[0]) == tiny.max_voxels      # the capacity truncates
    for g, w, h in zip(got, want, TPreprocessor(tcfg).voxelize_host(pts)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(h, w)
    for g, w in zip(got, JPreprocessor(tiny).voxelize_host(pts)):
        np.testing.assert_array_equal(g, w)

    boxes = np.column_stack([rng.uniform(0, 20, (12, 2)), rng.uniform(-2, 0, 12),
                             rng.uniform(1, 4, (12, 3)),
                             rng.uniform(-np.pi, np.pi, 12)]).astype(np.float32)
    inside = tnative.points_in_cuboids_mask(pts, boxes)
    assert inside.any()
    np.testing.assert_array_equal(inside, jnative.points_in_cuboids_mask(pts, boxes))
    assert tnative.points_in_cuboids_mask(pts[:0], boxes).shape == (0, 12)

    mats = dict(P2=np.array([[700, 0, 612, 45], [0, 700, 185, -0.3], [0, 0, 1, 0.003]],
                            np.float32),
                R0=np.eye(3, dtype=np.float32) + rng.normal(0, 0.01, (3, 3)).astype(np.float32),
                V2C=np.array([[0, -1, 0, 0.01], [0, 0, -1, -0.07], [1, 0, 0, -0.27]],
                             np.float32))
    got = tnative.filter_camera_fov(TCalib(**mats), pts)
    assert 0 < len(got) < len(pts)
    np.testing.assert_array_equal(got, jnative.filter_camera_fov(JCalib(**mats), pts))


def test_trace_if_writes_a_trace(tmp_path):
    with tprofiler.trace_if(str(tmp_path / "off"), enabled=False):
        torch.ones(3).sum()
    assert not (tmp_path / "off").exists()
    with tprofiler.trace_if(str(tmp_path / "on")):
        with tprofiler.annotate("region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list((tmp_path / "on").glob("*.json"))
    assert len(files) == 1
    spans = [e for e in json.loads(files[0].read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert [e["name"] for e in spans] == ["v3d:region"]
