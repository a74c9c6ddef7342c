"""Training on several cards (``vision3d_tpu_torch/parallel/mesh.py``), on
the CPU: the data loader's shards against the JAX package's loader, the
helpers without a process group, four gloo ranks against one process on
the whole batch, and ``train_cli`` as two ranks.

The ranks' reference is the port's one-process step, which
tests/test_torch_train*.py hold against JAX; a JAX mesh is not run here (it
needs virtual devices fixed before JAX starts). The ranks are processes
spawned by ``chip_smoke.ddp_check`` (the check of ``chip_smoke.py`` phase
11d, there on the card), which imports nothing of JAX, at
tests/test_pvrcnn.py's ``pv_cfg`` size: SECOND on voxels, SECOND on
columns and PV-RCNN's two-stage step, each rank on one frame of four with
one intra-op thread, on the one process's replayed ReLU gates, max-pool
selections and ball-query groups; losses to 1e-5 relative, summed gradients to 1e-4 of their
max, running statistics to 1e-5, parameters after the step bit-equal
across the ranks."""

import os
import subprocess
import sys
from concurrent.futures import Future

import numpy as np
import pytest
import torch
import yaml

from vision3d_tpu.config import Config
from vision3d_tpu.data import loader as jloader
from vision3d_tpu_torch.data import loader as tloader
from vision3d_tpu_torch.parallel import mesh

from test_data import write_fake_kitti
from test_torch_pvrcnn import pv_cfg
from test_torch_pvrcnn_train import _yaml_doc
from torch_parity import ROOT, ShardSet, port_cfg

sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

SHARDS = 4


class _Inline:
    """An executor that runs each job when it is submitted: the loaders'
    worker path (per-batch seeds, the dataset's rng swapped) without
    processes."""

    def submit(self, fn, *args):
        f = Future()
        f.set_result(fn(*args))
        return f


def _cfg():
    cfg = Config()
    return cfg.replace(capacity=cfg.capacity.__class__(max_points=256, max_gt_boxes=4))


def _epochs(module, cfg, workers, monkeypatch, **shard):
    """(len, every batch of two epochs) of ``module``'s DataLoader over a
    ShardSet, batches of 2, seed 5."""
    ds = ShardSet()
    loader = module.DataLoader(ds, cfg, batch_size=2, seed=5, num_workers=workers, **shard)
    if workers:
        monkeypatch.setattr(module, "_WORKER_DATASET", ds)
        monkeypatch.setattr(module, "_WORKER_CFG", cfg)
        loader._executor = _Inline
    return len(loader), [b for _ in range(2) for b in loader]


def _assert_same(got, want):
    assert got[0] == want[0] and len(got[1]) == len(want[1]) > 0
    for g, w in zip(got[1], want[1]):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("shard", range(SHARDS))
@pytest.mark.parametrize("workers", [0, 1], ids=["thread", "workers"])
def test_loader_shards_equal_jax(shard, workers, monkeypatch):
    """DataLoader(num_shards=4, shard_id=k): the same length and batches,
    bit for bit, as the JAX package's loader, on the prefetch thread and on
    the worker path (whose per-batch seeds the shard id decorrelates)."""
    kw = dict(num_shards=SHARDS, shard_id=shard)
    _assert_same(_epochs(tloader, port_cfg(_cfg()), workers, monkeypatch, **kw),
                 _epochs(jloader, _cfg(), workers, monkeypatch, **kw))


@pytest.mark.parametrize("workers", [0, 1], ids=["thread", "workers"])
def test_loader_shard_zero_of_one_is_the_one_card_loader(workers, monkeypatch):
    cfg = port_cfg(_cfg())
    _assert_same(_epochs(tloader, cfg, workers, monkeypatch, num_shards=1, shard_id=0),
                 _epochs(tloader, cfg, workers, monkeypatch))


def test_loader_shards_split_each_epoch(monkeypatch):
    """An epoch's shards hold disjoint frames, 8 batches of 2 of the 37
    between them (37 // 4 = 9 frames a shard, 4 whole batches)."""
    cfg = port_cfg(_cfg())
    seen = []
    for k in range(SHARDS):
        n, batches = _epochs(tloader, cfg, 0, monkeypatch, num_shards=SHARDS, shard_id=k)
        assert n == 4
        seen.append(np.concatenate([b["frame_idx"] for b in batches[:n]]))
    frames = np.concatenate(seen)
    assert len(frames) == len(set(frames.tolist())) == 32


def test_mesh_without_a_group_is_the_identity():
    assert not torch.distributed.is_initialized()
    assert (mesh.world_size(), mesh.rank()) == (1, 0)
    x = torch.randn(3, requires_grad=True)
    assert mesh.global_sum(x) is x
    d = {"a": torch.tensor(1.5), "n": torch.tensor(3)}
    assert mesh.sum_over_ranks(d) is d
    assert mesh.local_batch(8) == 8 and mesh.rank_slice(torch.arange(4)).tolist() == [0, 1, 2, 3]
    assert mesh.local_device("cpu") == torch.device("cpu")
    # the JAX CLI's rule: the largest card count that divides the batch
    assert [mesh.devices_for(8, n) for n in (1, 2, 3, 4, 5, 8, 16)] == [1, 2, 2, 4, 4, 8, 8]
    with mesh.rank0_first():
        pass


@pytest.fixture(scope="module")
def ranks():
    """One intra-op thread for the one process too: beside other test
    processes, torch's thread pool spinning on a busy host costs more than
    the work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            return chip_smoke.ddp_check(port_cfg(pv_cfg().replace(max_voxels=512)), "cpu",
                                        SHARDS, "gloo", batch_size=SHARDS, points=400)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("form", list(chip_smoke.DDP_FORMS))
def test_four_ranks_match_one_process(ranks, form):
    """``ddp_check`` raises on any gate it holds; here its report: every
    loss term took part (the regression and, two-stage, the refinement
    terms), within the gates."""
    r = ranks[form]
    assert r["world"] == SHARDS and r["frames"] == SHARDS
    assert r["loss_rel_max"] <= chip_smoke.DDP_LOSS_TOL
    assert r["worst_grad_rel"] <= chip_smoke.DDP_GRAD_TOL
    assert r["stat_err"] <= chip_smoke.DDP_STAT_TOL
    assert r["losses"]["reg_loss"] > 0
    if form == "pvrcnn2":
        assert r["losses"]["refine_reg_loss"] > 0 and r["losses"]["seg_loss"] > 0
    assert all(v == 0 for k, v in r["counters"].items() if k != "voxelizer_dropped")


@pytest.fixture(scope="module")
def two_rank_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_cli")
    write_fake_kitti(str(root / "kitti"), pv_cfg(), n_frames=4)
    (root / "splits").mkdir()
    (root / "splits" / "train.txt").write_text("0\n1\n2\n3\n")
    yml = root / "pv.yaml"
    yml.write_text(yaml.safe_dump(_yaml_doc(root)))
    return root, yml


def test_train_cli_as_two_ranks(two_rank_set):
    """train_cli as ranks 0 and 1 of a gloo group through the coordinator
    variables: each loads its shard (batch 4 is 2 frames a rank), both
    finish, rank 0 alone prints the epoch line (4 frames a step) and
    writes the checkpoint, which holds the one update both made."""
    root, yml = two_rank_set
    port = mesh.free_port()
    args = [sys.executable, "-m", "vision3d_tpu_torch.train_cli", "--config", str(yml),
            "--batch-size", "4", "--workers", "0", "--epochs", "1", "--device", "cpu",
            "--ckpt-dir", str(root / "ck"), "--metrics-jsonl", str(root / "m.jsonl")]
    procs = [subprocess.Popen(args, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env={**os.environ, "COORDINATOR_ADDRESS":
                                              f"localhost:{port}", "NUM_PROCESSES": "2",
                                              "PROCESS_ID": str(r), "OMP_NUM_THREADS": "1"})
             for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert "epoch 0:" in outs[0][0] and "2 processes" in outs[0][0] and "saved" in outs[0][0]
    assert "epoch 0:" not in outs[1][0] and "saved" not in outs[1][0]
    ckpt = torch.load(root / "ck" / "epoch_0", weights_only=True)
    assert ckpt["step"] == 1
