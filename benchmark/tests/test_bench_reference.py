"""The plain reference against the port at the small geometry on the CPU,
both in float32 (the reference's own tolerances), and the control (the
reference in float8 in the program's place) coming out as not correct:
on the card at the cells' own size, and here as a control that reads
well above the bfloat16 program on the same seed."""

import time

import pytest
import torch

from harness import compare
from test_bench_harness import _run, M, cuda_device  # noqa: F401

# float32 on both sides, sums in other orders: the largest gaps of maps and
# features are ~1e-4 of their standard deviation
TOL = 2e-3
CELLS = ["second-car-infer-b8", "pvrcnn2-car-infer-b8", "second-car-train-b8"]
# the control's reading over the bfloat16 program's, on the same seed
MAPS = {"second-car-infer-b8": "cls_gap", "pvrcnn2-car-infer-b8": "point_feat_gap",
        "second-car-train-b8": "cls_gap_first"}


@pytest.mark.parametrize("cell", CELLS[:2])
def test_inference_agrees_in_float32(cell):
    c, _, res = _run(cell, 21)
    n = res["numbers"]
    for k, v in n.items():
        if k.endswith("mismatch"):
            assert v == 0, k
        elif k.endswith("_gap"):
            assert v < TOL, (k, v)
    assert M.verdict(c, res)[0]


def test_training_step_agrees_in_float32():
    c, _, res = _run("second-car-train-b8", 22)
    n = res["numbers"]
    # the later steps' losses move more: Adam's first updates are about +-lr
    # wherever a gradient is not near zero, so a rounding that flips a tiny
    # gradient's sign moves that parameter by 2 lr
    assert n["loss_gap_first"] < 1e-5 and n["loss_gap"] < 2e-3, n
    assert n["grad_gap_median"] < TOL and n["step_gap"] < 2e-2, n
    assert n["cls_gap_first"] < TOL and n["reg_gap_first"] < TOL, n
    assert M.verdict(c, res)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program(cell):
    _, _, prog = _run(cell, 23, f32=False)
    _, _, ctl = _run(cell, 23, control=True, f32=False)
    key = MAPS[cell]
    assert ctl["numbers"][key] > 3 * prog["numbers"][key], (prog["numbers"], ctl["numbers"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell, cuda_device):  # noqa: F811
    c = M.Cell(cell)
    for seed in (101, 102, 103):
        args = M.parse_args(["--workload", cell, "--seed", str(seed), "--seconds", "1",
                             "--control"])
        res = M.run_once(c, seed, args, cuda_device, time.perf_counter())
        assert not M.verdict(c, res)[0], res["numbers"]


@pytest.mark.cuda
def test_control_is_not_correct_on_four_cards(cuda_device):  # noqa: F811
    """The cell on four cards: the control runs as four ranks over the
    global batches, and fails a number other than the ranks' agreement
    (which it does not read)."""
    import json
    import subprocess
    import sys

    cell = "second-car-train-b8x4"
    if torch.cuda.device_count() < M.Cell(cell).chips:
        pytest.skip("needs four CUDA devices")
    for seed in (101, 102, 103):
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                              str(seed), "--seconds", "1", "--control"], cwd=M.ROOT,
                             capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert not line["correct"]
        assert any(c["value"] > c["limit"] for c in line["checks"].values()), line["checks"]


def _steps_over_ranks(rank, world, port, seed, out):
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        c, cfg, sd, anchors, batches = _global_steps_inputs(seed, world, rank)
        with torch.backends.mkldnn.flags(enabled=False):
            got = c.model.reference_steps(cfg, sd, batches, anchors, over_ranks=True)
        if rank == 0:
            torch.save(got[:4], out)
    finally:
        dist.destroy_process_group()


def _global_steps_inputs(seed, world, rank):
    from harness import reference as ref, traffic, weights

    c = M.Cell("second-car-train-b8x4", quick=True)
    cfg = {**c.cfg, "compute_dtype": "float32"}
    b = c.mix["batch"]
    gmix = dict(c.mix, batch=b * world)
    rows = slice(None) if rank is None else slice(b * rank, b * (rank + 1))
    batches = [M.to_device(traffic.make_batch(gmix, seed, traffic.POOL, i,
                                              cfg["anchors"][0]["wlh"], rows), "cpu")
               for i in range(cfg["bench"]["check_steps"])]
    sd = weights.draw(c.model.param_shapes(cfg), seed, "cpu")
    return c, cfg, sd, torch.as_tensor(ref.make_anchors(cfg)), batches


def test_reference_over_ranks_equals_the_global_batch(tmp_path):
    """Two gloo ranks, each on its share, with the reference's sums taken
    over the ranks, take the global batch's steps: float32 both ways."""
    import torch.multiprocessing as mp
    from vision3d_tpu_torch.parallel.mesh import free_port

    seed, out = 2**31 + 43, tmp_path / "ranks.pt"
    mp.start_processes(_steps_over_ranks, args=(2, free_port(), seed, str(out)), nprocs=2,
                       join=True, start_method="spawn")
    c, cfg, sd, anchors, batches = _global_steps_inputs(seed, 2, None)
    with torch.backends.mkldnn.flags(enabled=False):
        whole = c.model.reference_steps(cfg, sd, batches, anchors)
    losses, first, change, maps = torch.load(out)
    n = c.mix["batch"]                          # rank 0's rows
    assert compare.rel_gap(maps["cls"], whole[3]["cls"][:n]) < TOL
    numbers = c.model.train_numbers(cfg, (losses, first, change, maps), whole)
    # the tolerances of test_training_step_agrees_in_float32: Adam's first
    # updates are about +-lr wherever a gradient is not near zero, so the
    # later steps move more
    assert numbers["loss_gap_first"] < 1e-5 and numbers["loss_gap"] < 2e-3, numbers
    assert numbers["grad_gap_median"] < TOL and numbers["grad_gap_weights"] < TOL, numbers
    assert numbers["step_gap"] < 2e-2, numbers
