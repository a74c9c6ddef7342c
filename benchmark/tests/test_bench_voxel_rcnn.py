"""Voxel R-CNN's cell on the CPU at the small geometry: the whole run
rehearsed (``--device cpu``), the judge at 0 on the reference against
itself, the faults ``half_batch`` and ``alter`` caught, and the voxel
query's roofline terms on a scan counted by hand."""

import time

import pytest
import torch

from harness import files, reference as ref
from harness import main as M

CELL = "voxelrcnn-car-infer-b8"
mf = files.model("voxel_rcnn")


def _run(seed, fault="none", f32=True, topk=12):
    """One rehearsal with fewer RoIs a frame (the work scales with them,
    the code paths do not)."""
    c = M.Cell(CELL, quick=True)
    c.cfg = {**c.cfg, "proposal": {**c.cfg["proposal"], "topk": topk}}
    if f32:
        c.cfg = {**c.cfg, "compute_dtype": "float32"}
    args = M.parse_args(["--workload", CELL, "--seed", str(seed), "--seconds", "0.5",
                         "--device", "cpu", "--fault", fault])
    with torch.backends.mkldnn.flags(enabled=not f32):
        res = M.run_once(c, seed, args, torch.device("cpu"), time.perf_counter())
    return c, res


def test_rehearsal_is_correct():
    c, res = _run(2**31 + 61, f32=False)
    ok, checks = M.verdict(c, res)
    assert ok, checks
    assert res["numbers"]["voxel_query_mismatch"] == 0 and res["numbers"]["nms_mismatch"] == 0
    # the query finds voxels: not every grid point's ball is empty
    assert res["numbers"]["voxel_query_empty"] < 3 * 2 * 12 * 216


def test_judge_of_the_reference_against_itself_is_zero():
    c = M.Cell(CELL, quick=True)
    cfg = {**c.cfg, "proposal": {**c.cfg["proposal"], "topk": 8}}
    mix = c.mix
    anchors = torch.as_tensor(ref.make_anchors(cfg))
    from harness import traffic, weights

    sd = weights.draw(mf.param_shapes(cfg), 7, "cpu")
    batch = M.to_device(traffic.make_batch(mix, 7, traffic.CALIBRATION, 0), "cpu")
    mf.calibrate(cfg, sd, batch, anchors)
    prog = mf.reference_outputs(cfg, sd, batch, anchors, quant=False)
    got = mf.judge(cfg, prog, batch, sd, anchors, None)
    for k in ("cls_gap", "reg_gap", "choice_gap", "voxel_query_mismatch", "pooled_gap",
              "rcnn_gap", "decode_mismatch", "nms_mismatch"):
        assert got[k] == 0, (k, got[k])


@pytest.mark.parametrize("fault", ["half_batch", "alter"])
def test_planted_fault_is_not_correct(fault):
    c, res = _run(2**31 + 67, fault=fault)
    ok, checks = M.verdict(c, res)
    assert not ok, checks


def test_voxel_query_counts_by_hand():
    """Four voxels on a (4, 4, 4) grid of 1 m cells, one point at the centre
    of cell (1, 1, 1), window 1, radius 1.0, two slots: the scan (z, y, x
    order) meets the occupied cells (0,1,1) at 1 m (a hit), (1,1,1) at 0 (a
    hit: the row is full), then (1,1,2) and (2,1,1), which it never tests.
    Two tests; the rows are the first two sites in scan order."""
    dims = (4, 4, 4)
    zyx = torch.tensor([[0, 1, 1], [1, 1, 1], [1, 1, 2], [2, 1, 1]])
    coords = torch.cat([torch.zeros(4, 1, dtype=torch.int64), zyx], 1)
    key, order = torch.sort(ref.site_key(coords, dims))
    x = ref.Sparse(coords[order], key, torch.zeros(4, 1), dims, 1)
    lo, step = torch.zeros(3), torch.ones(3)
    idx, tests = mf.voxel_query(x, torch.tensor([[[1.5, 1.5, 1.5]]]), lo, step, (1, 1, 1),
                                1.0, 2)
    want = [int((key == ref.site_key(torch.tensor([[0, *c]]), dims)).nonzero()) for c in
            ([0, 1, 1], [1, 1, 1])]
    assert idx[0, 0].tolist() == want and tests == 2
    # three slots: the scan goes on to (1,1,2) (a hit at 1 m) and stops there
    idx, tests = mf.voxel_query(x, torch.tensor([[[1.5, 1.5, 1.5]]]), lo, step, (1, 1, 1),
                                1.0, 3)
    assert tests == 3 and idx[0, 0, 2] == int((key == ref.site_key(
        torch.tensor([[0, 1, 1, 2]]), dims)).nonzero())


def test_voxel_query_roofline_arithmetic():
    reader = files.reader("voxel_query_roofline")

    class Trace:
        def kernel_us(self, patterns):
            assert patterns == reader.KERNELS
            return 100.0

    class Run:
        trace = Trace()
        # one query bound by its tests, one by its bytes
        unit_counts = [[dict(name="voxel_query0", flops=0, tests=67e6, bytes=1e3),
                        dict(name="voxel_query1", flops=0, tests=1, bytes=3.35e6),
                        dict(name="subm0", stage=0, n_in=1, n_out=1, cin=1, cout=1, kvol=1,
                             hits=1)]]

    # 67e6 tests x 8 / 67e12 = 8 us; 3.35e6 B / 3.35e12 = 1 us; over 100 us
    assert reader.read(Run()) == pytest.approx(9.0)
