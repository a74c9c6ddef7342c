"""Data-pipeline parity: the port's KITTI parser, annotation cache, gt
database, augmentation, collation and loader against the JAX package's on
the CPU, on two KITTI-format trees: test_data.write_fake_kitti's (Cars,
easy) and a small one from tools/make_synthetic_kitti.py --classes all
(three classes, occlusion and truncation levels). Both packages run the
same numpy in the same order, so integers and floats must be equal."""

import dataclasses
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from vision3d_tpu.config import Config
from vision3d_tpu.core import boxes as jboxes
from vision3d_tpu.core.iou import np_pairwise_rotated_iou as j_pairwise_iou
from vision3d_tpu.data import augment as jaug
from vision3d_tpu.data import kitti as jkitti
from vision3d_tpu.data import loader as jloader
from vision3d_tpu_torch.core import boxes as tboxes
from vision3d_tpu_torch.core.iou_host import np_pairwise_rotated_iou as t_pairwise_iou
from vision3d_tpu_torch.core.preprocess import Preprocessor, TrainPreprocessor
from vision3d_tpu_torch.data import augment as taug
from vision3d_tpu_torch.data import kitti as tkitti
from vision3d_tpu_torch.data import loader as tloader

from test_data import write_fake_kitti
from torch_parity import ROOT, port_cfg

TREES = ("fake", "synthetic")


def _write_splits(splitdir, train, val):
    os.makedirs(splitdir, exist_ok=True)
    for name, inds in (("train", train), ("val", val)):
        with open(os.path.join(splitdir, f"{name}.txt"), "w") as f:
            f.write("".join(f"{i}\n" for i in inds))


@pytest.fixture(scope="module", params=TREES)
def tree(request, tmp_path_factory):
    """(JAX Config, port Config, tree kind): one KITTI-format tree, each
    package with a cache directory of its own (so each builds its own
    annotations and gt database)."""
    root = tmp_path_factory.mktemp(f"kitti_{request.param}")
    base = Config()
    if request.param == "fake":
        write_fake_kitti(str(root / "training"), base, n_frames=6)
        _write_splits(root / "splitfiles", [2, 3, 4, 5], [0, 1])
        cfg = base.replace(
            num_classes=1, anchors=base.anchors[:1],
            aug=base.aug.__class__(num_sample_objects=(4, 0, 0), min_num_sample_pts=8),
            capacity=base.capacity.__class__(max_points=2048, max_gt_boxes=16))
    else:
        subprocess.run([sys.executable, str(ROOT / "tools" / "make_synthetic_kitti.py"),
                        "--out", str(root), "--classes", "all", "--train", "6",
                        "--val", "4", "--points", "5000", "--seed", "0"],
                       check=True, capture_output=True)
        cfg = Config.from_yaml(str(ROOT / "configs" / "second" / "all_classes.yaml"))
        cfg = cfg.replace(capacity=cfg.capacity.__class__(max_points=8192, max_gt_boxes=32))

    def with_cache(c, name):
        return c.replace(data=dataclasses.replace(
            c.data, rootdir=str(root / "training"), splitdir=str(root / "splitfiles"),
            cachedir=str(root / name)))

    return with_cache(cfg, "cache_jax"), port_cfg(with_cache(cfg, "cache_torch")), request.param


def _files(cfg, sub):
    d = os.path.join(cfg.data.rootdir, sub)
    return [os.path.join(d, f) for f in sorted(os.listdir(d))]


def _assert_equal_items(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_label_and_calib_parse_equal(tree):
    jcfg, _, _ = tree
    n = 0
    for path in _files(jcfg, "label_2"):
        for jo, to in zip(jkitti.read_label(path), tkitti.read_label(path), strict=True):
            ja, ta = dataclasses.asdict(jo), dataclasses.asdict(to)
            np.testing.assert_array_equal(ja.pop("box2d"), ta.pop("box2d"))
            assert ja == ta
            n += 1
    assert n > 0
    for path in _files(jcfg, "calib"):
        jc, tc = jkitti.Calib.parse(path), tkitti.Calib.parse(path)
        for f in ("P2", "R0", "V2C", "C2V", "WH"):
            np.testing.assert_array_equal(getattr(jc, f), getattr(tc, f))
            assert getattr(jc, f).dtype == getattr(tc, f).dtype


def test_fov_crop_and_camera_boxes_equal(tree):
    jcfg, _, _ = tree
    for velo, calib, label in zip(_files(jcfg, "velodyne"), _files(jcfg, "calib"),
                                  _files(jcfg, "label_2")):
        jc, tc = jkitti.Calib.parse(calib), tkitti.Calib.parse(calib)
        pts = jkitti.read_velo(velo)
        kept = jkitti.filter_camera_fov(jc, pts)
        assert 0 < len(kept) <= len(pts)
        np.testing.assert_array_equal(tkitti.filter_camera_fov(tc, pts), kept)
        for jo, to in zip(jkitti.read_label(label), tkitti.read_label(label)):
            np.testing.assert_array_equal(tkitti.camera_box_to_velo(to, tc),
                                          jkitti.camera_box_to_velo(jo, jc))


@pytest.mark.parametrize("split", ["train", "val"])
def test_annotations_equal_and_cached_apart(tree, split):
    jcfg, tcfg, _ = tree
    jds = jkitti.KittiDataset(jcfg, split=split, verbose=False)
    tds = tkitti.KittiDataset(tcfg, split=split, verbose=False)
    assert jds.inds == tds.inds and len(tds) > 0
    assert list(jds.annotations) == list(tds.annotations)
    for i, ja in jds.annotations.items():
        ta = dict(tds.annotations[i])
        ja = dict(ja)
        jc, tc = ja.pop("calib"), ta.pop("calib")
        np.testing.assert_array_equal(jc.C2V, tc.C2V)
        assert os.path.basename(ja.pop("velo_path")) == os.path.basename(ta.pop("velo_path"))
        _assert_equal_items(ja, ta)
    for k in range(len(jds)):
        _assert_equal_items(jds[k], tds[k])
    # the port's cache is its own file, and loading it again gives the same
    path = os.path.join(tcfg.data.cachedir, f"{split}.torch.pkl")
    assert os.path.isfile(path)
    assert not os.path.exists(os.path.join(tcfg.data.cachedir, f"{split}.pkl"))
    again = tkitti.KittiDataset(tcfg, split=split, verbose=False)
    _assert_equal_items(again[0], tds[0])


def test_port_cache_unpickles_without_the_jax_package(tree):
    _, tcfg, _ = tree
    tkitti.KittiDataset(tcfg, split="val", verbose=False)
    path = os.path.join(tcfg.data.cachedir, "val.torch.pkl")
    code = ("import pickle, sys\n"
            f"pickle.load(open({path!r}, 'rb'))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'vision3d_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr


def _datasets(tree, seed):
    jcfg, tcfg, _ = tree
    return (jkitti.KittiDatasetTrain(jcfg, verbose=False, rng=np.random.default_rng(seed)),
            tkitti.KittiDatasetTrain(tcfg, verbose=False, rng=np.random.default_rng(seed)))


def test_gt_database_equal(tree):
    jcfg, tcfg, _ = tree
    _datasets(tree, 0)
    dbs = []
    for cfg in (jcfg, tcfg):
        with open(os.path.join(cfg.data.cachedir, "database.pkl"), "rb") as f:
            dbs.append(pickle.load(f))
    jdb, tdb = dbs
    assert sorted(jdb) == sorted(tdb) and sum(len(v) for v in jdb.values()) > 0
    for c in jdb:
        assert len(jdb[c]) == len(tdb[c])
        for js, ts in zip(jdb[c], tdb[c]):
            _assert_equal_items(js, ts)


def test_box_geometry_equal():
    rng = np.random.default_rng(4)
    boxes = np.column_stack([rng.uniform(-5, 5, (12, 3)), rng.uniform(0.5, 4, (12, 3)),
                             rng.uniform(-3.2, 3.2, (12, 1))]).astype(np.float32)
    pts = rng.uniform(-6, 6, (3000, 4)).astype(np.float32)
    np.testing.assert_array_equal(tboxes.box3d_to_bev_corners(boxes),
                                  jboxes.box3d_to_bev_corners(boxes, xp=np))
    np.testing.assert_array_equal(tboxes.points_in_cuboids_mask(pts, boxes),
                                  jboxes.points_in_cuboids_mask(pts, boxes, xp=np))
    for jp, tp in zip(jboxes.points_in_cuboids(pts, boxes),
                      tboxes.points_in_cuboids(pts, boxes), strict=True):
        np.testing.assert_array_equal(tp, jp)
    kept = tboxes.points_not_in_rectangles(pts, boxes)
    assert 0 < len(kept) < len(pts)
    np.testing.assert_array_equal(kept, jboxes.points_not_in_rectangles(pts, boxes))


@pytest.mark.parametrize("mode", ["degrees", "radians"])
def test_host_rotated_iou_bit_equal(mode):
    rng = np.random.default_rng(6)
    b = np.column_stack([rng.uniform(0, 6, (80, 2)), rng.uniform(0.5, 4, (80, 2)),
                         rng.uniform(-3, 3, (80, 1))]).astype(np.float32)
    b[40:] = b[:40] + rng.normal(0, 0.3, (40, 5)).astype(np.float32)
    got, want = t_pairwise_iou(b, b, mode), j_pairwise_iou(b, b, mode)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert ((want > 0.01) & (want < 0.99)).sum() > 40


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collision_keep_set_equal(tree, seed):
    jcfg, tcfg, _ = tree
    jds, tds = _datasets(tree, 0)
    jsa, tsa = jds.augmentation.sample, tds.augmentation.sample
    scene = jds.annotations[jds.inds[0]]["boxes"]
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    js, ts = jsa.draw_samples(rj), tsa.draw_samples(rt)
    jsa.random_translate(js, rj)
    tsa.random_translate(ts, rt)
    np.testing.assert_array_equal(ts["boxes"], js["boxes"])
    keep = jsa.filter_collisions(scene, js["boxes"])
    np.testing.assert_array_equal(tsa.filter_collisions(scene, ts["boxes"]), keep)
    assert keep.any()


@pytest.mark.parametrize("seed", [0, 5])
def test_augmented_samples_equal(tree, seed):
    jds, tds = _datasets(tree, seed)
    for k in range(len(jds)):
        j, t = jds[k], tds[k]
        _assert_equal_items(j, t)
        assert len(t["boxes"]) > 0


def test_geometric_augmentations_equal():
    jcfg = Config()
    tcfg = port_cfg(jcfg)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-10, 10, (200, 4)).astype(np.float32)
    boxes = rng.uniform(-5, 5, (5, 7)).astype(np.float32)
    for jaug_cls, taug_cls in ((jaug.FlipAugmentation, taug.FlipAugmentation),
                               (jaug.ScaleAugmentation, taug.ScaleAugmentation),
                               (jaug.RotateAugmentation, taug.RotateAugmentation)):
        for seed in range(4):
            jp, jb = jaug_cls(jcfg)(pts, boxes, np.random.default_rng(seed))
            tp, tb = taug_cls(tcfg)(pts, boxes, np.random.default_rng(seed))
            np.testing.assert_array_equal(tp, jp)
            np.testing.assert_array_equal(tb, jb)


def test_pad_points_and_collate_equal(tree):
    jcfg, tcfg, _ = tree
    jds, tds = _datasets(tree, 3)
    items = [jds[k] for k in range(len(jds))]
    for cap in (16, len(items[0]["points"]), 100000):
        jp, jn = jloader.pad_points(items[0]["points"], cap, np.random.default_rng(2))
        tp, tn = tloader.pad_points(items[0]["points"], cap, np.random.default_rng(2))
        assert jn == tn
        np.testing.assert_array_equal(tp, jp)
    jb = jloader.collate(items, jcfg, np.random.default_rng(9))
    tb = tloader.collate(items, tcfg, np.random.default_rng(9))
    _assert_equal_items(jb, tb)
    assert jb["gt_mask"].sum() > 0


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_epoch_equal(tree, shuffle):
    """Thread-prefetch path: every batch of two epochs, in order."""
    jcfg, tcfg, _ = tree
    jds, tds = _datasets(tree, 7)
    jl = jloader.DataLoader(jds, jcfg, batch_size=2, seed=11, shuffle=shuffle,
                            drop_last=False)
    tl = tloader.DataLoader(tds, tcfg, batch_size=2, seed=11, shuffle=shuffle,
                            drop_last=False)
    assert len(jl) == len(tl) >= 1
    for _ in range(2):
        jbs, tbs = list(jl), list(tl)
        assert len(jbs) == len(tbs) == len(tl)
        for jb, tb in zip(jbs, tbs):
            _assert_equal_items(jb, tb)


def test_worker_batch_in_process_equal(tree, monkeypatch):
    """The process pool's unit of work, called here: each batch from its own
    seed, whichever worker runs it."""
    jcfg, tcfg, _ = tree
    jds, tds = _datasets(tree, 0)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    for mod in (jloader, tloader):
        monkeypatch.setattr(mod, "_WORKER_DATASET", None)
        monkeypatch.setattr(mod, "_WORKER_CFG", None)
    jloader._init_worker(jds, jcfg)
    tloader._init_worker(tds, tcfg)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ""
    for idx, seed in (([0, 1], 123), ([2, 0], 7), ([1], 2**31 - 1)):
        _assert_equal_items(jloader._worker_batch(np.array(idx), seed),
                            tloader._worker_batch(np.array(idx), seed))


def test_spawned_worker_pool_matches_jax(tree, monkeypatch):
    """The port's loader with one spawned worker process against the JAX
    loader's per-batch jobs run in this process: same epoch order, same
    per-batch seeds, same batches."""
    jcfg, tcfg, _ = tree
    jds, tds = _datasets(tree, 0)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(jloader, "_WORKER_DATASET", None)
    monkeypatch.setattr(jloader, "_WORKER_CFG", None)
    jloader._init_worker(jds, jcfg)
    jl = jloader.DataLoader(jds, jcfg, batch_size=2, seed=3, num_workers=1)
    jl._pool = ThreadPoolExecutor(1)
    tl = tloader.DataLoader(tds, tcfg, batch_size=2, seed=3, num_workers=1)
    try:
        jbs, tbs = list(jl), list(tl)
    finally:
        jl.close()
        tl.close()
    assert len(jbs) == len(tbs) == len(tl) >= 1
    for jb, tb in zip(jbs, tbs):
        _assert_equal_items(jb, tb)


def test_loader_thread_raises_what_the_dataset_raised(tree):
    _, tcfg, _ = tree

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError(f"frame {i} unreadable")

    with pytest.raises(OSError, match="unreadable"):
        list(tloader.DataLoader(Broken(), tcfg, batch_size=2))


def test_preprocessor_equal(tree):
    jcfg, tcfg, _ = tree
    from vision3d_tpu.core.preprocess import Preprocessor as JPre
    from vision3d_tpu.core.preprocess import TrainPreprocessor as JTrainPre

    jds, tds = _datasets(tree, 1)
    items = [jds[0], jds[1]]
    j = JPre(jcfg, seed=0)(dict(points=[it["points"] for it in items], extra="x"))
    t = Preprocessor(tcfg, seed=0)(dict(points=[it["points"] for it in items], extra="x"))
    _assert_equal_items(j, t)
    _assert_equal_items(JTrainPre(jcfg, seed=4).collate(items),
                        TrainPreprocessor(tcfg, seed=4).collate(items))
    cloud = items[0]["points"]
    # both take the native C++ host library where it builds, else numpy
    for got, want in zip(Preprocessor(tcfg).voxelize_host(cloud),
                         JPre(jcfg).voxelize_host(cloud), strict=True):
        assert got.dtype == want.dtype and len(want) > 0
        np.testing.assert_array_equal(got, want)
