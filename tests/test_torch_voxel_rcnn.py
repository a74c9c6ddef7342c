"""Voxel R-CNN in the port (``models/voxel_rcnn.py``) against the plain
reference ``tests/plain_voxel_rcnn.py`` on the CPU, at a small geometry, on
seeded fresh weights whose batch norms the reference calibrates on the
test's own batch: ``VoxelBackBone8x``'s active sets, the voxel query's
indices (exact, with one case each for a grid border, an empty ball, more
than ``nsample`` hits, a voxel at exactly the radius and a point outside
the grid), the pooled features, the RoI head, the decode and NMS (exact);
the program's spans; and SECOND's trunk (``SpMiddleFHD``, ``RPN``), which
Voxel R-CNN shares, unchanged on a seeded input."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_voxel_rcnn as plain
from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.core.voxelize import voxelize_batch
from vision3d_tpu_torch.models import voxel_rcnn as vr
from vision3d_tpu_torch.models.rpn import BaseBEVBackbone
from vision3d_tpu_torch.models.second import Second, build_middle_input, init_second
from vision3d_tpu_torch.models.sparse_cnn import SparseTensor
from vision3d_tpu_torch.ops import voxel_query as vq
from vision3d_tpu_torch.synthetic import kitti_like_points
from vision3d_tpu_torch.training import profiler

GOLDEN = Path(__file__).resolve().parent / "goldens" / "second_trunk_seed0.npz"


@pytest.fixture(autouse=True)
def two_threads():
    # the suite runs several workers a host; oneDNN's float32 conv is a
    # reduced-accuracy algorithm, off for float32 comparisons
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            yield
    finally:
        torch.set_num_threads(threads)


def small_cfg():
    cfg = Config()
    cfg = cfg.replace(max_voxels=4096, voxel_size=(0.2, 0.2, 0.1),
                      grid_bounds=(0.0, -12.8, -3.0, 25.6, 12.8, 1.0), num_classes=1,
                      anchors=cfg.anchors[:1],
                      proposal=dataclasses.replace(cfg.proposal, topk=3))
    return vr.voxel_rcnn_config(cfg)


def scene(seed, b=2, n=2500):
    """KITTI-like frames cut to the small grid: (points (B, n, 4), counts)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        p = kitti_like_points(rng, 20 * n)
        p = p[(p[:, 0] < 25.6) & (np.abs(p[:, 1]) < 12.8)][:n]
        out.append(p)
    return torch.from_numpy(np.stack(out)), torch.tensor([n, n - 300])


@pytest.fixture(scope="module")
def calibrated():
    """(cfg, its plain dict, state dict with the reference's batch
    statistics, points, counts, anchors, the port's model)."""
    with torch.backends.mkldnn.flags(enabled=False):
        cfg = small_cfg()
        model, anchors = vr.create_voxel_rcnn(cfg, device="cpu")
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        pts, num = scene(3)
        cd = dataclasses.asdict(cfg)
        plain.forward(plain.Ctx("calib"), sd, cd, pts, num, anchors)
        model.load_state_dict(sd, strict=True)
    return cfg, cd, sd, pts, num, anchors, model


def _frame_rows(x: plain.Sparse, idx, batch):
    """Reference site indices (B, G, S) -> rows within each frame."""
    d, h, w = x.dims
    start = torch.searchsorted(x.key, torch.arange(batch) * (d * h * w))
    return torch.where(idx >= 0, idx - start[:, None, None], -1)


def test_voxel_backbone_and_bev_backbone_shapes():
    model, _ = vr.create_voxel_rcnn(small_cfg(), device="cpu")
    subm = [tuple(c.weight.shape) for c in model.cnn.subm]
    down = [tuple(c.weight.shape) for c in model.cnn.down]
    assert [s[1] for s in subm] == [16, 16, 32, 32, 64, 64, 64, 64]
    assert down == [(27 * 16, 32), (27 * 32, 64), (27 * 64, 64), (3 * 64, 128)]
    assert model.cnn.bev_channels() == 256 and model.rpn.c_out == 256
    assert tuple(model.rcnn.shared[0].linear.weight.shape) == (256, 96 * 216)
    assert tuple(model.head.conv_cls.weight.shape[:2]) == (2, 256)


def test_forward_matches_plain(calibrated):
    """Stage 1 and its active sets; stage 2 on the program's own RoIs:
    voxel-query rows exact, pooled features, logits and residuals within
    float32 tolerances, decode and NMS exact."""
    cfg, cd, sd, pts, num, anchors, model = calibrated
    with torch.no_grad():
        _, _, _, diag, scales = model.trunk(pts, num, need_scales=True)
        out, diag = model.two_stage(pts, num, anchors)
        det, _ = model.inference_two_stage(pts, num, anchors)
    assert all(int(v) == 0 for k, v in diag.items() if k.endswith("dropped"))
    want = plain.forward(plain.Ctx("eval"), sd, cd, pts, num, anchors, rois=out["rois"])
    b = pts.shape[0]
    # active sets of every scale: exact
    for st, ref in zip(scales, want["scales"]):
        k = torch.where(st.mask, st.keys, -1)
        got = {(i, int(v)) for i in range(b) for v in k[i][k[i] >= 0]}
        d, h, w = ref.dims
        assert got == {(int(c[0]), int(key) - int(c[0]) * d * h * w)
                       for c, key in zip(ref.coords, ref.key)}

    def close(got, ref, tol):
        scale = float(ref.std()) or 1.0
        assert float((got - ref).abs().max()) <= tol * scale

    # float32 sums in another order than the reference's gathers: 1e-4 of
    # each tensor's spread (a lower precision reads 1e-2 and above)
    close(out["cls_map"], want["cls"], 1e-4)
    close(out["reg_map"], want["reg"], 1e-4)
    # the program's top anchors are the reference's, up to ties
    logits = want["cls"].reshape(b, -1)
    k = cfg.proposal.topk
    kth = torch.sort(logits, dim=1, descending=True).values[:, k - 1:k]
    _, idx = torch.sort(torch.sigmoid(out["cls_map"].reshape(b, -1)), dim=1, descending=True,
                        stable=True)
    chosen = torch.gather(logits, 1, idx[:, :cfg.proposal.topk])
    assert float((kth - chosen).clamp(min=0).max()) <= 1e-4 * float(logits.std())
    for got, ref, x in zip(out["rows"], want["indices"], [want["scales"][i]
                                                          for i in cfg.voxel_rcnn.scales]):
        assert torch.equal(got.long(), _frame_rows(x, ref, b))
    assert int(diag["voxel_query_empty"]) == sum(int((r[..., 0] < 0).sum()) for r in out["rows"])
    assert any(bool((r[..., 0] >= 0).any()) for r in out["rows"])
    with torch.no_grad():
        pooled = model.roi_pool(out["rois"], [scales[i] for i in cfg.voxel_rcnn.scales])[0]
    close(pooled, want["pooled"], 1e-4)
    close(out["rcnn_cls"], want["rcnn_cls"], 1e-4)
    close(out["rcnn_reg"], want["rcnn_reg"], 1e-4)
    # decode and NMS of the program's own residuals and scores: exact
    boxes = plain.decode_rois(out["rcnn_reg"], out["rois"])
    scores = torch.sigmoid(out["rcnn_cls"])
    assert torch.equal(det.boxes, boxes) and torch.equal(det.scores, scores)
    keep = plain.nms_keep(boxes, scores, cfg.proposal.nms_iou_threshold, cfg.iou_angle_mode)
    assert torch.equal(det.valid, keep & (scores > cfg.anchors[0].score_thresh))
    assert bool(det.valid.any())


def _query(keys_zyx, points, grid=(6, 10, 12), step=0.5, radius=1.0, ranges=(2, 2, 2),
           nsample=4):
    """One frame's scale from voxel cells (z, y, x), queried at ``points``
    by the port (its plain version here) and by the reference: both
    (G, nsample) rows."""
    d, h, w = grid
    zyx = torch.tensor(keys_zyx, dtype=torch.int64).reshape(-1, 3)
    key = (zyx[:, 1] * w + zyx[:, 2]) * d + zyx[:, 0]
    key, _ = torch.sort(key)
    n = len(key) + 2
    keys = torch.full((1, n), d * h * w, dtype=torch.int32)
    keys[0, :len(key)] = key.to(torch.int32)
    mask = keys < d * h * w
    lo = np.zeros(3, np.float32)
    stp = np.full(3, step, np.float32)
    p = torch.tensor(points, dtype=torch.float32).reshape(1, -1, 3)
    got = vq.voxel_query(vq.row_map(keys, mask, grid), grid, p, lo, stp, ranges, radius,
                         nsample)[0]
    coords = torch.stack([torch.zeros_like(key), key % d, key // d // w, key // d % w], 1)
    x = plain.Sparse(coords, key, torch.zeros(len(key), 1), grid, 1)
    ref = plain.voxel_query(x, p, torch.from_numpy(lo), torch.from_numpy(stp), ranges,
                            radius, nsample)
    assert torch.equal(got.long(), _frame_rows(x, ref, 1)[0])
    return got, key


def _row(key, z, y, x, grid=(6, 10, 12)):
    d, h, w = grid
    return int((key == (y * w + x) * d + z).nonzero()[0, 0])


def test_voxel_query_grid_border():
    # a point in the corner cell: the window's cells below 0 are skipped
    cells = [(0, 0, 0), (0, 0, 1), (1, 1, 0), (5, 9, 11)]
    got, key = _query(cells, [(0.25, 0.25, 0.25)])
    assert got[0].tolist() == [_row(key, 0, 0, 0), _row(key, 0, 0, 1), _row(key, 1, 1, 0),
                               _row(key, 0, 0, 0)]


def test_voxel_query_empty_ball():
    # voxels in the window, all beyond the radius: every slot -1
    got, _ = _query([(2, 2, 4), (2, 2, 0)], [(1.25, 1.25, 1.25)], radius=0.9)
    assert got[0].tolist() == [-1] * 4


def test_voxel_query_more_hits_than_nsample_in_scan_order():
    # a full 3^3 block around the point, seven of it within 0.6 m (the
    # point's own cell and its six face neighbours): the first four in scan
    # order (dz outermost, dx innermost) are taken
    cells = [(z, y, x) for z in (1, 2, 3) for y in (3, 4, 5) for x in (5, 6, 7)]
    got, key = _query(cells, [(3.25, 2.25, 1.25)], radius=0.6)
    assert got[0].tolist() == [_row(key, 1, 4, 6), _row(key, 2, 3, 6), _row(key, 2, 4, 5),
                               _row(key, 2, 4, 6)]


def test_voxel_query_voxel_at_exactly_the_radius_is_taken():
    # centres exactly 1.0 m away in x (binary fractions: the distance is
    # exact in float32) are taken, one float32 step further is not
    got, key = _query([(2, 2, 2), (2, 2, 6)], [(2.25, 1.25, 1.25)], radius=1.0)
    a, b = _row(key, 2, 2, 2), _row(key, 2, 2, 6)
    assert got[0].tolist() == [a, b, a, a]
    got, _ = _query([(2, 2, 6)], [(float(np.nextafter(np.float32(2.25), np.float32(0))),
                                   1.25, 1.25)], radius=1.0)
    assert got[0].tolist() == [-1] * 4


def test_voxel_query_point_outside_the_grid():
    # below the grid in x: the window still reaches its first columns; far
    # outside (and NaN): nothing
    cells = [(2, 2, 0), (2, 2, 1)]
    got, key = _query(cells, [(-0.25, 1.25, 1.25), (500.0, 1.25, 1.25),
                              (float("nan"), 1.25, 1.25)], radius=1.0)
    a, b = _row(key, 2, 2, 0), _row(key, 2, 2, 1)
    assert got[0].tolist() == [a, b, a, a]
    assert got[1].tolist() == [-1] * 4 and got[2].tolist() == [-1] * 4


def test_voxel_query_plain_chunks_agree():
    # the plain version's chunking over grid points changes nothing
    rng = np.random.default_rng(5)
    grid = (11, 32, 32)
    cells = np.unique(rng.integers(0, [11, 32, 32], (600, 3)), axis=0)
    d, h, w = grid
    key = torch.from_numpy(np.sort((cells[:, 1] * w + cells[:, 2]) * d + cells[:, 0]))
    keys, mask = key[None].to(torch.int32), torch.ones((1, len(key)), dtype=torch.bool)
    p = torch.from_numpy(rng.uniform(-1, 17, (1, 300, 3)).astype(np.float32))
    lo, step = np.zeros(3, np.float32), np.full(3, 0.5, np.float32)
    vmap = vq.row_map(keys, mask, grid)
    whole = vq.voxel_query_plain(vmap, grid, p, lo, step, (4, 4, 4), 1.6, 16)
    parts = vq.voxel_query_plain(vmap, grid, p, lo, step, (4, 4, 4), 1.6, 16, budget=7 * 729)
    assert torch.equal(whole, parts) and int((whole >= 0).sum()) > 0


def test_spans_of_one_inference(calibrated, tmp_path):
    cfg, _, _, pts, num, anchors, model = calibrated
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model.inference_two_stage(pts, num, anchors)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            spans.setdefault(e["name"][len(profiler.SPAN_PREFIX):], []).append(e)
    assert len(spans["voxel_query"]) == 3 and len(spans["voxel_roi_pool"]) == 1
    assert len(spans["rcnn_head"]) == 1 and spans["decode"] and spans["nms"]
    assert len(spans["plan"]) == 4     # one a stage: all four run sparse
    (inf,) = spans["inference"]
    for name in ("voxel_roi_pool", "voxel_query", "rcnn_head", "middle"):
        for e in spans[name]:
            assert inf["ts"] <= e["ts"] and e["ts"] + e["dur"] <= inf["ts"] + inf["dur"]


def _second_outputs(cfg, pts, num):
    """Seeded SECOND (``SpMiddleFHD``, ``RPN``) at ``dense_from_stage`` 2 and
    4: state-dict names and shapes, each tensor's absolute sum, and the
    middle extractor's BEV map, the RPN's output and the head's maps."""
    res = {}
    for dense in (2, 4):
        model = Second(cfg.replace(dense_from_stage=dense))
        init_second(model, torch.Generator().manual_seed(0))
        model.eval()
        sd = model.state_dict()
        res["keys"] = json.dumps([[k, list(v.shape)] for k, v in sd.items()])
        res["param_sums"] = np.array([np.abs(v.numpy().astype(np.float64)).sum()
                                      for v in sd.values()])
        with torch.no_grad():
            x, cls, reg, _, _ = model.trunk(pts, num)
            bev, _ = model.cnn(build_middle_input(cfg, voxelize_batch(pts, num, cfg))[0])
        res[f"bev{dense}"], res[f"rpn{dense}"] = bev.numpy(), x.numpy()
        res[f"cls{dense}"], res[f"reg{dense}"] = cls.numpy(), reg.numpy()
    return res


def test_second_trunk_unchanged():
    """``SpMiddleFHD`` and ``RPN``, which gained a subclass and a sibling,
    build the same state dict (names, shapes, seeded values) and give the
    same outputs as ``tests/goldens/second_trunk_seed0.npz``, which
    ``_second_outputs`` wrote on the tree before ``VoxelBackBone8x`` and
    ``BaseBEVBackbone`` were added (car_tiny.yaml, numpy seed 20)."""
    cfg = Config.from_yaml(str(Path(__file__).resolve().parents[1] / "configs" / "second"
                               / "car_tiny.yaml"))
    rng = np.random.default_rng(20)
    pts = torch.from_numpy(rng.uniform([0, -12.8, -3, 0], [25.6, 12.8, 1, 1],
                                       (2, 1500, 4)).astype(np.float32))
    got = _second_outputs(cfg, pts, torch.tensor([1500, 1200]))
    want = np.load(GOLDEN)
    assert got["keys"] == str(want["keys"])
    np.testing.assert_array_equal(got["param_sums"], want["param_sums"])
    for k in want.files:
        if k in ("keys", "param_sums"):
            continue
        # the same float32 arithmetic; sums may take another order under
        # another thread count: 1e-5 of each tensor's largest magnitude
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5 * scale, err_msg=k)


def test_sparse_scale_type():
    # the pooled scales are the trunk's SparseTensors (all stages sparse)
    cfg = small_cfg()
    assert cfg.dense_from_stage == 4 and cfg.cnn == "VoxelBackBone8x"
    assert cfg.proposal.c_in == 256
    model, _ = vr.create_voxel_rcnn(cfg, device="cpu")
    assert isinstance(model.rpn, BaseBEVBackbone) and model.rpn.c_out == 256
    pts, num = scene(4, b=1, n=800)
    with torch.no_grad():
        *_, scales = model.trunk(pts, num[:1], need_scales=True)
    assert all(isinstance(s, SparseTensor) for s in scales)
    assert [s.feats.shape[-1] for s in scales[1:]] == [32, 64, 64]


@pytest.mark.parametrize("kernel", [(3, 1, 1), (3, 3, 1), (3, 1, 3)])
def test_zwin_conv_embeds_a_narrower_kernel(kernel):
    """A z-window conv of kernel (3, ky, kx) placed in the (3, 3, 3) one
    that the card's kernel runs: the same outputs (the plain version of
    each; float32, extra terms are exact zeros)."""
    from vision3d_tpu_torch.ops import sparse as sp
    from vision3d_tpu_torch.ops.zwin_conv import embed_333

    gen = torch.Generator().manual_seed(sum(kernel))
    b, n, m, c, cout = 2, 60, 50, 8, 16
    k2 = kernel[1] * kernel[2]
    feats = torch.randn((b, n, c), generator=gen)
    start = torch.randint(0, n + 3, (b, m * k2), generator=gen, dtype=torch.int32)
    pattern = torch.randint(0, 8, (b, m * k2), generator=gen, dtype=torch.int32)
    w = torch.randn((3 * k2 * c, cout), generator=gen)
    s9, p9, w27 = embed_333(start, pattern, w, kernel, n)
    got = sp.conv_zwin_apply(feats, s9, p9, w27, (3, 3, 3))
    want = sp.conv_zwin_apply(feats, start, pattern, w, kernel)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
