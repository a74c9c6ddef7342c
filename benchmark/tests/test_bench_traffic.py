"""The frozen traffic generator against the port's ``synthetic.py``."""

import numpy as np
import pytest

from harness import traffic


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
def test_clouds_equal_synthetic(seed):
    from vision3d_tpu_torch.synthetic import kitti_like_batch

    want = kitti_like_batch(seed, 2, 5000)
    got = traffic.clouds(np.random.default_rng(seed), 2, 5000)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_train_batch_equals_synthetic():
    from vision3d_tpu_torch.synthetic import kitti_like_train_batch

    want = kitti_like_train_batch(11, 2, 4000, max_gt=32)
    got = traffic.train_batch(np.random.default_rng(11), 2, 4000, 32, 0.5,
                              np.asarray([1.6, 3.9, 1.56], np.float32))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_same_seed_same_batch_and_streams_differ():
    mix = dict(mode="infer", batch=1, points=2000, pool=2)
    a = traffic.make_batch(mix, 2**31 + 7, traffic.CALIBRATION, 0)
    b = traffic.make_batch(mix, 2**31 + 7, traffic.CALIBRATION, 0)
    c = traffic.make_batch(mix, 2**31 + 8, traffic.CALIBRATION, 0)
    assert np.array_equal(a["points"], b["points"])
    assert not np.array_equal(a["points"], c["points"])
    assert a["points"].shape == c["points"].shape


def test_every_seed_deals_the_same_pool():
    mix = dict(mode="train", batch=2, points=1500, pool=3, max_gt=4, gt_valid_share=0.5)
    wlh = [1.6, 3.9, 1.56]

    def frames(seed):
        bs = [traffic.make_batch(mix, seed, traffic.POOL, i, wlh) for i in range(mix["pool"])]
        return np.concatenate([b["points"] for b in bs]), bs

    fa, ba = frames(11)
    fb, bb = frames(2**31 + 11)
    key = lambda f: sorted(x.tobytes() for x in f)  # noqa: E731
    assert key(fa) == key(fb)                      # the same frames, dealt in another order
    assert not np.array_equal(fa, fb)
    assert not np.array_equal(ba[0]["boxes"], bb[0]["boxes"])
    again = frames(11)[0]
    assert np.array_equal(fa, again)


def test_rank_shares_make_the_global_batch():
    """Rank r's share of a global batch is rows ``batch*r`` on of the whole,
    so the global traffic does not depend on the number of ranks."""
    mix = dict(mode="train", batch=8, points=1200, pool=2, max_gt=4, gt_valid_share=0.5)
    wlh = [1.6, 3.9, 1.56]
    whole = traffic.make_batch(mix, 2**31 + 13, traffic.POOL, 1, wlh)
    for ranks in (2, 4):
        b = mix["batch"] // ranks
        shares = [traffic.make_batch(mix, 2**31 + 13, traffic.POOL, 1, wlh,
                                     slice(b * r, b * (r + 1))) for r in range(ranks)]
        for k in whole:
            assert np.array_equal(np.concatenate([s[k] for s in shares]), whole[k]), k
