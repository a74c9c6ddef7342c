"""The plain reference against the port at the small geometry on the CPU,
both in float32 (the reference's own tolerances), and the control (the
reference in float8 in the program's place) coming out as not correct:
on the card at the cells' own size, and here as a control that reads
well above the bfloat16 program on the same seed."""

import time

import pytest
import torch

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
