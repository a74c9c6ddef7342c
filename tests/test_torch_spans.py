"""The port's program spans (``training/profiler.annotate``) on the CPU, at
a small geometry: no ``record_function`` without a profiler, and under
``torch.profiler`` the spans of one SECOND inference, one SECOND training
step and one two-stage PV-RCNN inference nest as the benchmark's readers
and the profile tools expect, each batch's or step's under its entry span."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.models.pvrcnn import create_pvrcnn
from vision3d_tpu_torch.models.second import create_second
from vision3d_tpu_torch.training import profiler
from vision3d_tpu_torch.training.train import create_train_state, make_train_step

from torch_parity import uniform_points


@pytest.fixture(autouse=True)
def two_threads():
    # the suite runs several workers a host: small ops crawl on every core
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def small_cfg(**over):
    """``tiny_cfg``'s geometry (tests/conftest.py) in the port's Config."""
    cfg = Config()
    return cfg.replace(**{
        **dict(max_voxels=512, voxel_size=(0.4, 0.4, 0.1),
               grid_bounds=(0.0, -12.8, -3.0, 25.6, 12.8, 1.0), num_classes=1,
               anchors=cfg.anchors[:1],
               capacity=dataclasses.replace(cfg.capacity, max_points=2048, max_gt_boxes=8,
                                            max_detections=32),
               proposal=dataclasses.replace(cfg.proposal, c_in=128, topk=16)),
        **over})


def pv_small_cfg():
    """tests/test_torch_pvrcnn.py's ``pv_cfg`` with 32 keypoints."""
    cfg = small_cfg(max_voxels=256, num_keypoints=32)
    return cfg.replace(
        proposal=dataclasses.replace(cfg.proposal, topk=8),
        gridpool=dataclasses.replace(
            cfg.gridpool, num_gridpoints=4, radii_pn=(0.8, 1.6),
            mlps_pn=((512, 32, 16), (512, 32, 16)), mlps_reduction=(4 * 32, 32, 32)),
        refinement=dataclasses.replace(cfg.refinement, mlps=(32, 16)))


def traced(fn, tmp_path):
    """Run ``fn`` under a CPU ``torch.profiler`` and return the exported
    trace's complete events: (spans by name, cpu ops)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(profiler.SPAN_PREFIX):
            spans.setdefault(e["name"][len(profiler.SPAN_PREFIX):], []).append(e)
    return spans, [e for e in events if e.get("cat") == "cpu_op"]


def inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def assert_under(spans, parent, children):
    for child in children:
        assert spans.get(child), f"no v3d:{child} span"
        for e in spans[child]:
            assert any(inside(e, p) for p in spans[parent]), f"v3d:{child} outside v3d:{parent}"


def test_annotate_records_only_under_a_profiler(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    for _ in range(3):
        with profiler.annotate("voxelize"):
            torch.ones(4).sum()
    assert made == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.annotate("voxelize"):
            torch.ones(4).sum()
    assert made == ["v3d:voxelize"]


@pytest.mark.parametrize("backend", ["voxel", "column"])
def test_second_inference_spans(tmp_path, backend):
    """One ``Second.inference``: every op under ``v3d:inference``; voxelize,
    middle, RPN, head, decode and NMS under it; every plan under the middle
    extractor, one a sparse stage's plan (two voxel stages; two column stages,
    their submanifold and their strided rulebooks); the waits for the
    device (``v3d:sync``) under the forward, NMS's among them."""
    cfg = small_cfg(sparse_backend=backend)
    model, anchors = create_second(cfg, device="cpu")
    pts, num = uniform_points(cfg, np.random.default_rng(3), 2, 300)
    pts, num = torch.from_numpy(pts), torch.from_numpy(num)
    with torch.no_grad():
        model.inference(pts, num, anchors)           # first calls outside the trace
        spans, ops = traced(lambda: model.inference(pts, num, anchors), tmp_path)
    assert len(spans["inference"]) == 1
    assert_under(spans, "inference", ["voxelize", "middle", "rpn", "head", "decode", "nms",
                                      "sync"])
    assert_under(spans, "middle", ["plan"])
    assert len(spans["plan"]) == {"voxel": 2, "column": 4}[backend]
    assert any(inside(e, spans["nms"][0]) for e in spans["sync"])
    assert ops and all(inside(op, spans["inference"][0]) for op in ops)


def test_second_train_step_spans(tmp_path):
    """One SECOND ``train_step``: target assignment, the loss's forward, the
    backward pass, the all-reduce and the optimizer under
    ``v3d:train_step``; the model's layers under the loss's forward, one plan
    a sparse stage (all four)."""
    cfg = small_cfg()
    model, tx, state = create_train_state(cfg, steps_per_epoch=10, device="cpu")
    step = make_train_step(model, tx, cfg)
    pts, num = uniform_points(cfg, np.random.default_rng(4), 2, 300)
    boxes = np.zeros((2, 4, 7), np.float32)
    boxes[..., :3] = (10.0, 0.0, -1.0)
    boxes[..., 3:6] = (1.6, 3.9, 1.56)
    batch = dict(points=torch.from_numpy(pts), num_points=torch.from_numpy(num),
                 boxes=torch.from_numpy(boxes), class_idx=torch.zeros((2, 4), dtype=torch.int32),
                 gt_mask=torch.tensor([[True, False, False, False]] * 2),
                 box_ignore=torch.zeros((2, 4), dtype=torch.bool))
    spans, _ = traced(lambda: step(state, batch), tmp_path)
    assert len(spans["train_step"]) == 1
    assert_under(spans, "train_step",
                 ["target_assign", "loss_forward", "backward", "allreduce", "optimizer"])
    assert_under(spans, "loss_forward", ["voxelize", "middle", "rpn", "head"])
    assert_under(spans, "middle", ["plan"])
    assert len(spans["plan"]) == 4


def test_pvrcnn_two_stage_spans(tmp_path):
    """One ``PV_RCNN.inference_two_stage``: one FPS span for all the steps,
    one point branch, one grid pool, the refinement, all under
    ``v3d:inference``; four plans (two sparse stages, then the two dense
    stages' key sets for the scales)."""
    cfg = pv_small_cfg()
    model, anchors = create_pvrcnn(cfg, device="cpu")
    pts, num = uniform_points(cfg, np.random.default_rng(5), 2, 400)
    pts, num = torch.from_numpy(pts), torch.from_numpy(num)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        spans, ops = traced(lambda: model.inference_two_stage(pts, num, anchors, generator=gen),
                            tmp_path)
    assert len(spans["inference"]) == 1
    for name in ("fps", "point_branch", "grid_pool"):
        assert len(spans[name]) == 1, name
    assert_under(spans, "inference", ["fps", "point_branch", "grid_pool", "refine", "middle",
                                      "decode", "nms"])
    assert_under(spans, "middle", ["plan"])
    assert len(spans["plan"]) == 4
    assert all(inside(op, spans["inference"][0]) for op in ops)
