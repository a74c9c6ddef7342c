"""PyTorch port vs the JAX package: target assignment, losses, and the
optimizer chain (schedule, clip, Adam) against optax. Seeded numpy inputs,
CPU; tolerances stated where used."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vision3d_tpu.config import Config
from vision3d_tpu.core import iou as jiou
from vision3d_tpu.core import targets as jtargets
from vision3d_tpu.core.anchors import make_anchors
from vision3d_tpu.models import losses as jlosses
from vision3d_tpu.training import train as jtrain
from vision3d_tpu_torch.core import iou as tiou
from vision3d_tpu_torch.core import targets as ttargets
from vision3d_tpu_torch.models import losses as tlosses
from vision3d_tpu_torch.training import train as ttrain

from torch_parity import port_cfg


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfg3():
    """All three classes on a small grid."""
    cfg = Config()
    return cfg.replace(voxel_size=(0.4, 0.4, 0.1),
                       grid_bounds=(0.0, -12.8, -3.0, 25.6, 12.8, 1.0))


def _gt(cfg, rng, batch=2, g=10):
    """gt boxes of the classes' own sizes: some copied from anchors
    (IoU 1), some jittered, one duplicated (an argmax tie), some masked,
    one ignored."""
    anchors = make_anchors(cfg)                       # (n_cls, n_yaw, ny, nx, 7)
    n_cls = cfg.num_classes
    boxes = np.zeros((batch, g, 7), np.float32)
    cls = rng.integers(0, n_cls, (batch, g)).astype(np.int32)
    for b in range(batch):
        for i in range(g):
            a = anchors[cls[b, i], rng.integers(0, 2),
                        rng.integers(1, anchors.shape[2] - 1),
                        rng.integers(1, anchors.shape[3] - 1)]
            boxes[b, i] = a
            if i % 2:
                boxes[b, i, :2] += rng.uniform(-0.6, 0.6, 2)
                boxes[b, i, 6] += rng.uniform(-0.5, 0.5)
        boxes[b, 1] = boxes[b, 0]
        cls[b, 1] = cls[b, 0]
    mask = rng.uniform(size=(batch, g)) < 0.8
    mask[:, :2] = True
    ignore = np.zeros((batch, g), bool)
    ignore[:, 2] = True
    return boxes, cls, mask, ignore, anchors


def test_pairwise_rotated_iou_chunked():
    """Same pairs, elementwise arithmetic: 1e-6."""
    rng = np.random.default_rng(0)
    b1 = np.concatenate([rng.uniform(0, 10, (7, 2)), rng.uniform(1, 4, (7, 2)),
                         rng.uniform(-3, 3, (7, 1))], -1).astype(np.float32)
    b2 = np.concatenate([rng.uniform(0, 10, (101, 2)), rng.uniform(1, 4, (101, 2)),
                         rng.uniform(-3, 3, (101, 1))], -1).astype(np.float32)
    for mode in ("degrees", "radians"):
        ref = np.asarray(jiou.pairwise_rotated_iou_chunked(
            jnp.asarray(b1), jnp.asarray(b2), mode, chunk=32))
        got = tiou.pairwise_rotated_iou_chunked(_t(b1), _t(b2), mode, chunk=32)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("allow", [False, True])
def test_assign_targets_batch_equal(allow):
    """Masks and class targets exactly equal, encoded boxes to 1e-5; ties
    (a duplicated gt) go to the lowest gt index, as jnp.argmax."""
    cfg = _cfg3().replace(allow_low_quality_matches=allow)
    boxes, cls, mask, ignore, anchors = _gt(cfg, np.random.default_rng(1))
    ref = jax.jit(lambda *a: jtargets.assign_targets_batch(
        *a, jnp.asarray(anchors), cfg, 4096))(
        jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(mask), jnp.asarray(ignore))
    got = ttargets.assign_targets_batch(_t(boxes), _t(cls), _t(mask), _t(ignore),
                                        _t(anchors), port_cfg(cfg), 4096)
    assert got.M_cls.dtype == torch.bool and got.M_reg.dtype == torch.bool
    np.testing.assert_array_equal(got.M_cls.numpy(), np.asarray(ref.M_cls))
    np.testing.assert_array_equal(got.M_reg.numpy(), np.asarray(ref.M_reg))
    np.testing.assert_array_equal(got.G_cls.numpy(), np.asarray(ref.G_cls))
    np.testing.assert_allclose(got.G_reg.numpy(), np.asarray(ref.G_reg), atol=1e-5)
    assert int(got.M_reg.sum()) > 0 and int((~got.M_cls).sum()) > 0


def test_assign_targets_single_and_no_gt():
    cfg = _cfg3()
    boxes, cls, mask, ignore, anchors = _gt(cfg, np.random.default_rng(2), batch=1)
    mask[:] = False                                   # no gt: all background
    ref = jtargets.assign_targets(jnp.asarray(boxes[0]), jnp.asarray(cls[0]),
                                  jnp.asarray(mask[0]), jnp.asarray(ignore[0]),
                                  jnp.asarray(anchors), cfg)
    got = ttargets.assign_targets(_t(boxes[0]), _t(cls[0]), _t(mask[0]),
                                  _t(ignore[0]), _t(anchors), port_cfg(cfg))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got.M_reg.sum()) == 0 and bool(got.M_cls.all())


def test_losses_match_jax():
    """Elementwise losses and the proposal loss with the 3x/pi yaw quirk:
    1e-5 relative."""
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 3, (2, 3, 2, 8, 9)).astype(np.float32)
    tgt = (rng.uniform(size=logits.shape) < 0.1).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.sigmoid_focal_loss(_t(logits), _t(tgt)).numpy(),
        np.asarray(jlosses.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(tgt))),
        rtol=1e-5, atol=1e-7)
    reg = rng.normal(0, 1.5, logits.shape + (7,)).astype(np.float32)
    g_reg = rng.normal(0, 1.5, reg.shape).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.smooth_l1(_t(reg), _t(g_reg)).numpy(),
        np.asarray(jlosses.smooth_l1(jnp.asarray(reg), jnp.asarray(g_reg))),
        rtol=1e-6, atol=1e-7)
    m_reg = tgt > 0
    m_cls = rng.uniform(size=logits.shape) < 0.9
    cfg = _cfg3()
    ref = jlosses.proposal_loss(
        jnp.asarray(logits), jnp.asarray(reg),
        jtargets.Targets(jnp.asarray(tgt), jnp.asarray(m_cls), jnp.asarray(g_reg),
                         jnp.asarray(m_reg)), cfg)
    got = tlosses.proposal_loss(
        _t(logits), _t(reg),
        ttargets.Targets(_t(tgt), _t(m_cls), _t(g_reg), _t(m_reg)), port_cfg(cfg))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5)


@pytest.mark.parametrize("spe,epochs", [(10, 10), (7, 3), (3, 2)])
def test_lr_schedule_matches_optax_at_every_step(tiny_cfg, spe, epochs):
    """optax's piecewise cosine (not torch's OneCycleLR), at every step of
    the run and past its end. optax evaluates the cosine in float32, so
    its own error is ~1e-7 of the PEAK at every step (more than 1e-6 of the
    value near the low end): held to 1e-6 of the value plus 1e-6 of the
    peak."""
    cfg = tiny_cfg.replace(train=tiny_cfg.train.__class__(epochs=epochs))
    ref = jtrain.make_lr_schedule(cfg, spe)
    got = ttrain.make_lr_schedule(port_cfg(cfg), spe)
    for step in range(spe * epochs + 3):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-6 * cfg.train.max_lr)
    if spe * epochs == 100:
        assert max(range(100), key=got) == 30       # torch's OneCycleLR peaks at 29


def _grad_trees(rng, scale):
    shapes = {"a": (5, 7), "b": (11,), "c": (3, 2, 4)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (scale * rng.normal(size=s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(4)]
    return params, grads


@pytest.mark.parametrize("scale", [0.01, 30.0])
def test_clip_and_adam_match_optax(tiny_cfg, scale):
    """Given gradients through clip_by_global_norm(35) + Adam at the
    schedule, four updates: parameters within 1e-6 of optax's. scale 30
    clips (norm ~250), 0.01 does not."""
    rng = np.random.default_rng(5)
    params, grads = _grad_trees(rng, scale)
    tx = jtrain.make_optimizer(tiny_cfg, 10)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt = ttrain.make_optimizer(port_cfg(tiny_cfg), 10, tp.values())
    clipped = False
    for step, g in enumerate(grads):
        norm = float(optax.global_norm(jax.tree_util.tree_map(jnp.asarray, g)))
        clipped |= norm >= tiny_cfg.train.grad_clip_norm
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k in tp:
            tp[k].grad = _t(g[k])
        opt.step(step)
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-6)
    assert clipped == (scale > 1)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(6)
    for scale in (0.1, 10.0):
        g = [(scale * rng.normal(size=s)).astype(np.float32) for s in ((40, 9), (77,))]
        ref, _ = optax.clip_by_global_norm(35.0).update([jnp.asarray(x) for x in g],
                                                        optax.EmptyState())
        got = [_t(x) for x in g]
        norm = ttrain.clip_by_global_norm_(got, 35.0)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            [jnp.asarray(x) for x in g])), rtol=1e-6)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
