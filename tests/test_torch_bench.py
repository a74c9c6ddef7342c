"""The port's benchmark entry points (``vision3d_tpu_torch.bench`` and
``.bench_train``) on the CPU: their batches bit-equal to what the
repository's ``bench.py`` / ``bench_train.py`` build for seed 0, their
configs equal to the JAX package's for the same flags, one JSON line each
with those scripts' keys (less ``vs_baseline``, plus ``peak_mem_gib``) at
the quick geometry with one iteration and one repetition, ``bench`` over
two gloo ranks, and the refusal to run on the CPU unless asked. No JAX
model is built here."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vision3d_tpu.config import Config
from vision3d_tpu_torch import bench, bench_train
from vision3d_tpu_torch.parallel import mesh
from vision3d_tpu_torch.synthetic import kitti_like_batch, kitti_like_train_batch

from torch_parity import ROOT, port_cfg

sys.path.insert(0, str(ROOT))
from bench import kitti_like_points  # noqa: E402  (the repository's bench.py)

BENCH_KEYS = {  # bench.py's JSON keys, less vs_baseline, plus peak_mem_gib
    "metric", "value", "unit", "n_devices", "aggregate_frames_per_sec",
    "batch_latency_ms_p50", "batch_latency_ms_best", "host_roundtrip_ms",
    "latency_method", "batch", "points_per_frame", "compile_s", "device", "dtype",
    "stage_capacities", "sparse_backend", "dense_from_stage", "stage_dropped",
    "voxelizer_dropped_reference_semantics", "peak_mem_gib"}
TRAIN_KEYS = {  # bench_train.py's JSON keys, plus peak_mem_gib
    "metric", "value", "unit", "step_ms_best", "train_frames_per_sec",
    "epoch_minutes_kitti3712", "batch", "points_per_frame", "compile_s", "dtype",
    "device", "backward", "peak_mem_gib"}


@pytest.fixture
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _bench_clouds(batch, points):
    """bench.py:124-133 for seed 0, on the repository's kitti_like_points."""
    rng = np.random.default_rng(0)
    clouds = []
    for _ in range(batch):
        p = kitti_like_points(rng, int(points * 1.6))
        if len(p) < points:
            p = np.concatenate([p, p[rng.integers(0, len(p), points - len(p))]])
        clouds.append(p[:points])
    return rng, np.stack(clouds)


@pytest.mark.parametrize("batch,points", [(8, 18000), (2, 6000)])
def test_batches_equal_the_repository_scripts(batch, points):
    _, clouds = _bench_clouds(batch, points)
    pts, num = kitti_like_batch(0, batch, points)
    np.testing.assert_array_equal(pts, clouds)
    np.testing.assert_array_equal(num, np.full((batch,), points, np.int32))

    # bench_train.py:62-84
    rng, clouds = _bench_clouds(batch, points)
    G = 32
    boxes = np.zeros((batch, G, 7), np.float32)
    boxes[..., 0] = rng.uniform(5, 60, (batch, G))
    boxes[..., 1] = rng.uniform(-30, 30, (batch, G))
    boxes[..., 2] = -1.0
    boxes[..., 3:6] = [1.6, 3.9, 1.56]
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (batch, G))
    want = dict(points=clouds, num_points=np.full((batch,), points, np.int32),
                boxes=boxes, class_idx=np.zeros((batch, G), np.int32),
                gt_mask=rng.uniform(size=(batch, G)) < 0.5,
                box_ignore=np.zeros((batch, G), bool))
    got = kitti_like_train_batch(0, batch, points)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _jax_config(dtype="bfloat16", backend=None, dense_from=None, quick=False, **over):
    """bench.py:100-116's config (bench_train.py:48-60 with ``over``)."""
    cfg = Config()
    cfg = cfg.replace(num_classes=1, anchors=cfg.anchors[:1], compute_dtype=dtype, **over)
    if backend:
        cfg = cfg.replace(sparse_backend=backend)
    if dense_from is not None:
        cfg = cfg.replace(dense_from_stage=dense_from)
    if quick:
        cfg = cfg.replace(max_voxels=4096, voxel_size=(0.1, 0.1, 0.1),
                          grid_bounds=(0.0, -19.2, -3.0, 38.4, 19.2, 1.0))
    return cfg


@pytest.mark.parametrize("flags", [
    {}, {"quick": True}, {"backend": "column"}, {"backend": "column", "quick": True},
    {"dense_from": 3, "dtype": "float32"}, {"quick": True, "train_dense_from_stage": 2}])
def test_configs_equal_jax(flags):
    got = bench.bench_config(**flags)
    assert dataclasses.asdict(got) == dataclasses.asdict(port_cfg(_jax_config(**flags)))


def _capacities(cfg):
    return [cfg.stage_column_capacity(i) if cfg.sparse_backend == "column"
            else cfg.stage_voxel_capacity(i) for i in range(5)]


def _one_line(capsys):
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def _finite(record, keys):
    for k in keys:
        assert np.isfinite(record[k]) and record[k] > 0, (k, record[k])


def test_bench_prints_one_line(monkeypatch, capsys, two_threads):
    """``main --quick --device cpu`` with ``run`` held to one iteration and
    one timed repetition: one JSON line, the keys, finite timings,
    capacity counters 0 and the JAX config's stage capacities."""
    real = bench.run
    monkeypatch.setattr(bench, "run", lambda cfg, model, batch, points, iters, warmup,
                        device: real(cfg, model, batch, points, 1, 1, device))
    record = bench.main(["--quick", "--device", "cpu"])
    assert _one_line(capsys) == record
    assert set(record) == BENCH_KEYS
    assert record["metric"] == "second_inference_frames_per_sec_per_chip"
    assert (record["batch"], record["points_per_frame"], record["n_devices"]) == (2, 6000, 1)
    assert record["device"] == "cpu" and record["dtype"] == "bfloat16"
    assert record["peak_mem_gib"] is None
    _finite(record, ("value", "aggregate_frames_per_sec", "batch_latency_ms_p50",
                     "batch_latency_ms_best", "host_roundtrip_ms"))
    assert record["stage_dropped"] == [0, 0, 0]
    assert record["stage_capacities"] == _capacities(_jax_config(quick=True))
    # rates are rounded to 0.01
    assert record["aggregate_frames_per_sec"] == pytest.approx(
        2 / record["batch_latency_ms_p50"] * 1e3, abs=0.011)


def test_bench_train_prints_one_line(monkeypatch, capsys, two_threads):
    """``main --quick --device cpu`` with ``run`` held to one step a chain
    and one timed chain."""
    real = bench_train.run
    monkeypatch.setattr(bench_train, "run", lambda cfg, batch, points, iters, reps,
                        device: real(cfg, batch, points, 1, 1, device))
    record = bench_train.main(["--quick", "--device", "cpu"])
    assert _one_line(capsys) == record
    assert set(record) == TRAIN_KEYS
    assert record["metric"] == "second_train_step_ms"
    assert (record["batch"], record["points_per_frame"]) == (2, 6000)
    assert record["device"] == "cpu" and record["peak_mem_gib"] is None
    _finite(record, ("value", "step_ms_best", "train_frames_per_sec",
                     "epoch_minutes_kitti3712"))
    assert record["train_frames_per_sec"] == pytest.approx(2e3 / record["value"], abs=0.011)


RANK = """
import sys
from vision3d_tpu_torch import bench
real = bench.run
bench.run = lambda cfg, model, batch, points, iters, warmup, device: real(
    cfg, model, batch, points, 1, 1, device)
bench.main(sys.argv[1:])
"""


def test_bench_over_two_gloo_ranks():
    """Two ranks through the coordinator variables, each on its own
    batch slice: rank 0 alone prints the line, with n_devices 2 and the
    aggregate rate of the global batch of 4."""
    port = mesh.free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, "--quick", "--device", "cpu"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "COORDINATOR_ADDRESS": f"localhost:{port}",
             "NUM_PROCESSES": "2", "PROCESS_ID": str(r), "OMP_NUM_THREADS": "1"})
        for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert outs[1][0] == ""
    lines = outs[0][0].splitlines()
    assert len(lines) == 1, lines
    record = json.loads(lines[0])
    assert set(record) == BENCH_KEYS
    assert record["n_devices"] == 2 and record["batch"] == 2
    assert record["stage_dropped"] == [0, 0, 0]
    assert record["aggregate_frames_per_sec"] == pytest.approx(2 * record["value"], abs=0.021)
    assert record["aggregate_frames_per_sec"] == pytest.approx(
        4 / record["batch_latency_ms_p50"] * 1e3, abs=0.011)


@pytest.mark.parametrize("entry", [bench, bench_train])
def test_entry_points_need_a_card_unless_asked(entry, monkeypatch, capsys):
    """Without a visible card the default ``--device cuda`` exits non-zero
    and prints no line: there is no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        entry.main(["--quick"])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""
