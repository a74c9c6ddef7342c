"""PV-RCNN training, the port against the JAX package on the CPU, at the
size of tests/test_torch_pvrcnn.py's ``pv_cfg`` (64 keypoints, top 8
proposals, 4 grid points) with a class radius of 2 m: one step of each
mode (stage 1 alone, both stages), the refinement loss, the keypoint
targets, the stage-1 tree (C2), train-state conversion and the two CLIs.

The JAX side is one ``jax.jit`` of ``make_pvrcnn_train_step`` for both
modes, unchanged, behind an optimizer chain whose first link only records
the gradients in its state: the raw gradients, the losses, the new batch
statistics, the parameters and the Adam state after one step, all from the
JAX package's own step. Both models start from one set of weights (the
port's seeded init carried to flax by ``convert.py``, then seeded noise on
every batch-norm leaf; the reduction and refinement MLPs redrawn at unit
gain, std sqrt(2 / fan_in), since at their normal(0.01) init the gradient
that reaches the grid pool's set abstraction is ~1e-15, float32 noise),
and the port's step is fed JAX's draws of step 0
(grid points ``uniform(rng)``, negatives ``randint(split(rng, B)[b])``,
``rng = fold_in(PRNGKey(0), 0)``). The gt boxes sit on the first pass's
proposals near its keypoints, so the refinement regression and the
keypoint segmentation have foreground. oneDNN is off where floats are
compared.

A ReLU input within float32 noise of zero can be positive in one package
and not in the other, and such a gate moves the gradients of every layer
before it by up to a few percent of their scale at this size (one of the
RPN's did, at two intra-op threads). So the JAX step also hands every
ReLU's input to the host (``capture_intermediates`` of the batch norms and
MLP Dense layers that feed the ReLUs, through ``jax.debug.callback``), and
the port's backward takes JAX's gates (``chip_smoke.relu_gates``, as its
phase 6 takes the card's); the count of gates that differ is bounded.
"""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from vision3d_tpu.config import Config
from vision3d_tpu.core.targets import assign_refinement_targets_keypoints as j_kp_targets
from vision3d_tpu.models.pvrcnn import PV_RCNN as JPV
from vision3d_tpu.models.refinement import refinement_loss as j_refinement_loss
from vision3d_tpu.training.train import (TrainState, make_optimizer,
                                         make_pvrcnn_train_step)
from vision3d_tpu_torch import convert, eval_cli, train_cli
from vision3d_tpu_torch.core.anchors import make_anchors
from vision3d_tpu_torch.core.targets import assign_refinement_targets_keypoints
from vision3d_tpu_torch.models import pvrcnn as tpv
from vision3d_tpu_torch.models.refinement import refinement_loss
from vision3d_tpu_torch.training import train as ttrain

from test_data import write_fake_kitti
from test_torch_pointnet import perturb
from test_torch_pvrcnn import _inputs, pv_cfg
from torch_parity import ROOT, port_cfg

sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

SEED, SPE = 0, 10
MODES = ["pvrcnn", "pvrcnn2"]
# float32 in other orders through the trunk, the point branch and the
# grid pool: losses to 1e-5 relative, every gradient to 1e-4 of its
# tensor's max (the card-vs-CPU gates of chip_smoke.py), batch statistics
# to 1e-5 of 1 + |value| (SECOND's)
LOSS_TOL, GRAD_TOL, STAT_TOL = 1e-5, 1e-4, 1e-5


def train_cfg():
    """pv_cfg with a class radius of 2 m, each gt's best anchors positive
    (so the proposal regression has positives too), and grid-pool radii of
    2.4 and 4.8 m: at 0.8 m a grid ball holds one of the 64 keypoints or
    none, its batch norm sees one distinct row, and the gradient through
    it is float32 noise."""
    cfg = pv_cfg()
    return cfg.replace(anchors=(dataclasses.replace(cfg.anchors[0], radius=2.0),),
                       allow_low_quality_matches=True,
                       gridpool=dataclasses.replace(cfg.gridpool, radii_pn=(2.4, 4.8)))


def stage1_tree(tree):
    return {coll: {k: v for k, v in sub.items() if k not in tpv.STAGE2_MODULES}
            for coll, sub in tree.items()}


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _adam(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


@pytest.fixture(scope="module", autouse=True)
def plain_f32():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            yield
    finally:
        torch.set_num_threads(threads)


def _jax_draws(cfg, b):
    rng = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    n, m = cfg.num_classes * cfg.proposal.topk, cfg.gridpool.num_gridpoints
    u = np.asarray(jax.random.uniform(rng, (b, n, m, 3)))
    neg = np.stack([np.asarray(jax.random.randint(
        k, (cfg.train.refinement_num_negatives,), 0, cfg.num_keypoints))
        for k in jax.random.split(rng, b)])
    return u, neg


def _gt_on_proposals(cfg, variables, pts, num, u):
    """Per frame 3 gt boxes: the two proposals nearest a keypoint, moved
    by 5 cm and turned by 0.05 (so no yaw residual sits at the codec's
    wrap), and one far box; 5 padding slots of zero size."""
    tcfg = port_cfg(cfg)
    model, _, _ = ttrain.create_pvrcnn_train_state(
        tcfg, device="cpu", state_dict=convert.state_dict_from_flax(variables))
    anchors = torch.as_tensor(make_anchors(tcfg))
    with torch.no_grad():
        out, _ = model.two_stage(torch.from_numpy(pts), torch.from_numpy(num), anchors,
                                 u=torch.from_numpy(u))
    props, kp = out["proposals"].numpy(), out["keypoints"].numpy()
    g = cfg.capacity.max_gt_boxes
    boxes = np.zeros((2, g, 7), np.float32)
    gt_mask = np.zeros((2, g), bool)
    for b in range(2):
        near = np.linalg.norm(props[b, :, None, :3] - kp[b, None], axis=-1).min(1)
        pick = np.argsort(near, kind="stable")[:2]
        boxes[b, :2] = props[b, pick]
        boxes[b, :2, :3] += 0.05
        boxes[b, :2, 6] += 0.05
        boxes[b, 2] = [20.0, 8.0, -1.0, 1.6, 3.9, 1.56, 0.3]
        gt_mask[b, :3] = True
    return dict(points=pts, num_points=num, boxes=boxes,
                class_idx=np.zeros((2, g), np.int32), gt_mask=gt_mask,
                box_ignore=np.zeros((2, g), bool))


def _feeds_relu(mdl, method):
    """The modules whose outputs are ReLU inputs: every batch norm (sparse
    convs, RPN, shared MLPs) and the Dense layers of the MLPs."""
    kind = type(mdl).__name__
    return method == "__call__" and (
        kind in ("MaskedBatchNorm", "BatchNorm")
        or (kind == "Dense" and type(mdl.parent).__name__ == "MLP"))


def _relu_paths(cfg, two_stage):
    """The JAX modules of ``_feeds_relu`` in the order the port calls its
    ReLUs, each with the centre count of its groups (None: not a group)."""
    paths, subm = [], 0
    for si, n in enumerate((2, 2, 3, 3)):
        for _ in range(n):
            paths.append((("cnn", f"SubMConv_{subm}", "MaskedBatchNorm_0"), None))
            subm += 1
        paths.append((("cnn", f"SparseConvDown_{si}", "MaskedBatchNorm_0"), None))
    paths += [(("rpn", f"ConvBNReLU_{i}", "BatchNorm_0"), None) for i in range(7)]

    def sa(prefix, mlps, m):
        return [(prefix + (f"SharedMLP_{r}", f"MaskedBatchNorm_{j}"), m)
                for r, widths in enumerate(mlps) for j in range(len(widths) - 1)]

    for i, mlps in enumerate(cfg.psa.mlps):
        paths += sa((f"pnets_{i}",), mlps, cfg.num_keypoints)
    if two_stage:
        g = cfg.gridpool
        paths += sa(("roi_grid_pool", "SetAbstractionMSG_0"), g.mlps_pn,
                    cfg.num_classes * cfg.proposal.topk * g.num_gridpoints)
        paths += [(("roi_grid_pool", "MLP_0", f"Dense_{j}"), None)
                  for j in range(len(g.mlps_reduction) - 1)]
        paths += [(("refinement", "MLP_0", f"Dense_{j}"), None)
                  for j in range(len(cfg.refinement.mlps))]
    return paths


def _gates(cfg, inter, two_stage):
    """JAX's ReLU inputs -> the port's gates (x > 0) in its call order and
    layout (NCHW in the RPN, (B, M, S, C) groups in the shared MLPs)."""
    gates, used = [], 0
    for path, m in _relu_paths(cfg, two_stage):
        node = inter
        for k in path:
            node = node[k]
        z = np.asarray(node["__call__"][0])
        used += 1
        if path[0] == "rpn":
            z = z.transpose(0, 3, 1, 2)
        elif m is not None:
            z = z.reshape(z.shape[0], m, -1, z.shape[-1])
        gates.append(torch.from_numpy(z > 0))
    assert used == len(jax.tree_util.tree_leaves(inter))
    return gates


@pytest.fixture(scope="module")
def jax_run():
    cfg = train_cfg()
    tcfg = port_cfg(cfg)
    init = tpv.init_pvrcnn(tpv.PV_RCNN(tcfg), torch.Generator().manual_seed(4))
    with torch.no_grad():
        for lin in list(init.roi_grid_pool.mlp.linears) + list(init.refinement.mlp.linears):
            lin.weight.normal_(0.0, (2.0 / lin.weight.shape[1]) ** 0.5,
                               generator=torch.Generator().manual_seed(lin.weight.shape[1]))
    v2 = perturb(convert.flax_from_state_dict(init.state_dict()), 5)
    v1 = stage1_tree(v2)
    pts, num = _inputs()
    u, neg = _jax_draws(cfg, 2)
    batch = _gt_on_proposals(cfg, v2, pts, num, u)
    model = JPV(cfg)

    def capture():
        """Passes the gradients on and keeps them as its state."""
        return optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda g, s, p=None: (g, g))

    relu_inputs = {}

    class Recording:
        """The model as the step applies it, also handing the ReLU inputs
        of the forward to the host."""

        def __init__(self, mode):
            self.mode = mode

        def apply(self, variables, *args, mutable, **kw):
            out, mutated = model.apply(variables, *args, capture_intermediates=_feeds_relu,
                                       mutable=list(mutable) + ["intermediates"], **kw)
            jax.debug.callback(functools.partial(relu_inputs.__setitem__, self.mode),
                               mutated["intermediates"])
            return out, {k: v for k, v in mutated.items() if k != "intermediates"}

    @jax.jit
    def both(v1, v2, batch):
        out = {}
        for mode, v in (("pvrcnn", v1), ("pvrcnn2", v2)):
            tx = optax.chain(capture(), make_optimizer(cfg, SPE))
            state = TrainState(params=v["params"], batch_stats=v["batch_stats"],
                               opt_state=tx.init(v["params"]),
                               step=jnp.zeros((), jnp.int32))
            step = make_pvrcnn_train_step(Recording(mode), tx, cfg,
                                          train_stage2=mode == "pvrcnn2", seed=SEED)
            new, losses = step(state, batch)
            out[mode] = dict(params=new.params, batch_stats=new.batch_stats,
                             grads=new.opt_state[0], opt_state=new.opt_state[1],
                             losses=losses)
        return out

    out = jax.tree_util.tree_map(np.asarray, both(v1, v2, batch))
    jax.effects_barrier()
    for mode in MODES:
        out[mode]["adam"] = _adam(out[mode].pop("opt_state"))
        out[mode]["gates"] = _gates(cfg, relu_inputs[mode], mode == "pvrcnn2")
    return dict(cfg=cfg, variables={"pvrcnn": v1, "pvrcnn2": v2}, batch=batch,
                u=u, neg=neg, out=out)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_state(jax_run, mode, variables=None):
    cfg = port_cfg(jax_run["cfg"])
    sd = convert.state_dict_from_flax(variables or jax_run["variables"][mode])
    model, tx, state = ttrain.create_pvrcnn_train_state(
        cfg, steps_per_epoch=SPE, device="cpu", state_dict=sd,
        two_stage=mode == "pvrcnn2")
    return cfg, model, tx, state


@pytest.fixture(scope="module")
def port_run(jax_run):
    """One step of each mode on JAX's draws and JAX's ReLU gates, with the
    raw gradients read just before the optimizer clips them."""
    runs = {}
    for mode in MODES:
        cfg, model, tx, state = _port_state(jax_run, mode)
        sd0 = {k: v.clone() for k, v in model.state_dict().items()}
        grads, step_opt = {}, tx.step

        def record_then_step(count, model=model, grads=grads, step_opt=step_opt):
            grads.update({n: p.grad.clone() for n, p in model.named_parameters()
                          if p.grad is not None})
            step_opt(count)

        tx.step = record_then_step
        step = ttrain.make_pvrcnn_train_step(model, tx, cfg,
                                             train_stage2=mode == "pvrcnn2", seed=SEED)
        draws = (dict(u=torch.from_numpy(jax_run["u"]), neg=torch.from_numpy(jax_run["neg"]))
                 if mode == "pvrcnn2" else {})
        gates = jax_run["out"][mode]["gates"]
        with chip_smoke.relu_gates(gates, replay=True) as differ:
            state, losses = step(state, _torch_batch(jax_run["batch"]), **draws)
        tx.step = step_opt
        runs[mode] = dict(model=model, tx=tx, state=state, sd0=sd0, grads=grads,
                          gates=len(gates), gate_calls=len(differ),
                          gates_differ=sum(differ), n_gates=sum(g.numel() for g in gates),
                          losses={k: float(v) for k, v in losses.items()},
                          sd={k: v.clone() for k, v in model.state_dict().items()})
    return runs


@pytest.mark.parametrize("mode", MODES)
def test_losses_match_jax(jax_run, port_run, mode):
    want = {k: float(v) for k, v in jax_run["out"][mode]["losses"].items()}
    got = port_run[mode]["losses"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=LOSS_TOL, atol=1e-7, err_msg=k)
    assert np.isfinite(list(want.values())).all()
    if mode == "pvrcnn2":
        assert want["refine_reg_loss"] > 0 and want["seg_loss"] > 0
        assert set(want) == {"loss", "cls_loss", "reg_loss", "refine_cls_loss",
                             "refine_reg_loss", "refine_loss", "seg_loss"}


def test_the_data_reach_every_loss_path(jax_run):
    """The refinement regression has foreground proposals and the keypoint
    segmentation positive keypoints (both packages' targets)."""
    cfg, batch = port_cfg(jax_run["cfg"]), _torch_batch(jax_run["batch"])
    model = tpv.PV_RCNN(cfg)
    model.load_state_dict(convert.state_dict_from_flax(jax_run["variables"]["pvrcnn2"]))
    with torch.no_grad():
        out, _ = model.train().two_stage(batch["points"], batch["num_points"],
                                         torch.as_tensor(make_anchors(cfg)),
                                         u=torch.from_numpy(jax_run["u"]))
    cls_t, _ = assign_refinement_targets_keypoints(
        torch.from_numpy(jax_run["neg"]), out["keypoints"], batch["boxes"],
        batch["class_idx"], batch["gt_mask"], cfg)
    assert int(cls_t[..., 0].sum()) > 0, "no positive keypoint"
    rl = refinement_loss(out["box_deltas"], out["conf_logits"], out["proposals"],
                         torch.ones(out["proposals"].shape[:2], dtype=torch.bool),
                         batch["boxes"], batch["gt_mask"], cfg)
    assert float(rl["refine_reg_loss"]) > 0, "no foreground proposal"


@pytest.mark.parametrize("mode", MODES)
def test_every_gradient_matches_jax(jax_run, port_run, mode):
    """Every parameter's gradient to 1e-4 of its tensor's max, on JAX's
    ReLU gates (every ReLU of the port replayed one of JAX's, and at most
    1e-5 of the gates differed from the port's own). In stage-1 mode JAX's
    point-branch gradients are exactly zero, and the port's point branch
    has none."""
    run = port_run[mode]
    assert run["gate_calls"] == run["gates"] == (49 if mode == "pvrcnn2" else 41)
    assert run["gates_differ"] <= 1e-5 * run["n_gates"], run["gates_differ"]
    ref = convert.state_dict_from_flax({"params": jax_run["out"][mode]["grads"]})
    got = port_run[mode]["grads"]
    names = [n for n, _ in port_run[mode]["model"].named_parameters()]
    assert set(ref) == set(names)
    for name in names:
        r = ref[name].numpy()
        if mode == "pvrcnn" and name.startswith("pnets."):
            assert name not in got and not r.any(), name
            continue
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(got[name].numpy(), r, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(r).max()), err_msg=name)
    assert len(got) == len(names) - (60 if mode == "pvrcnn" else 0)


@pytest.mark.parametrize("mode", MODES)
def test_batch_stats_match_jax_after_a_step(jax_run, port_run, mode):
    """Every running statistic, the point branch's included (it runs in
    training mode in both modes, and every pnets_* statistic moves)."""
    v = jax_run["variables"][mode]
    ref = convert.state_dict_from_flax({"params": v["params"],
                                        "batch_stats": jax_run["out"][mode]["batch_stats"]})
    names = [k for k in ref if "running_" in k]
    assert len(names) == 2 * (14 + 7 + 20 + (4 if mode == "pvrcnn2" else 0))
    sd, sd0 = port_run[mode]["sd"], port_run[mode]["sd0"]
    for k in names:
        np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(), rtol=STAT_TOL,
                                   atol=STAT_TOL, err_msg=k)
        assert not torch.equal(sd[k], sd0[k]), f"{k} did not move"


@pytest.mark.parametrize("mode", MODES)
def test_params_after_a_step_match_jax(jax_run, port_run, mode):
    """Clip + Adam at the schedule's first rate lr: Adam's first update is
    lr * g / (|g| + 1e-8), lr in size wherever |g| is well above 1e-8, so
    every parameter agrees with JAX's to 2e-7 + 1e-6 of its size, except
    where JAX's gradient is under the gradient check's noise floor (1e-4
    of its tensor's max): there the update's sign is the noise's, and the
    two may differ by up to 2 lr. The point branch of a stage-1 step
    stays bit-equal to its start, in both packages."""
    v = jax_run["variables"][mode]
    out = jax_run["out"][mode]
    ref = convert.state_dict_from_flax({"params": out["params"]})
    grads = convert.state_dict_from_flax({"params": out["grads"]})
    start = convert.state_dict_from_flax({"params": v["params"]})
    lr = ttrain.make_lr_schedule(port_run[mode]["model"].cfg, SPE)(0)
    sd = port_run[mode]["sd"]
    floor_hits = total = 0
    for name, want in ref.items():
        got, want = sd[name].numpy(), want.numpy()
        if mode == "pvrcnn" and name.startswith("pnets."):
            np.testing.assert_array_equal(want, start[name].numpy(), err_msg=name)
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        g = np.abs(grads[name].numpy())
        noisy = g <= GRAD_TOL * g.max()
        tol = 2e-7 + 1e-6 * np.abs(want) + np.where(noisy, 2 * lr, 0.0)
        assert (np.abs(got - want) <= tol).all(), (name, float(np.abs(got - want).max()))
        assert not np.array_equal(want, start[name].numpy()), f"{name} did not move"
        floor_hits += int(noisy.sum())
        total += g.size
    assert floor_hits < 0.01 * total


# --- the keypoint targets, exactly --------------------------------------

def _kp_cases():
    """(name, keypoints (B, K, 3), gt (B, G, 7), classes, mask): 3 classes
    of radius 2 m; frame 0 random keypoints around gts of every class, with
    a keypoint between a car and a pedestrian (ambiguous); frame 1 no gt."""
    rng = np.random.default_rng(11)
    k, g = 48, 6
    gts = np.zeros((2, g, 7), np.float32)
    gts[0, :5, :3] = rng.uniform([2, -8, -2], [20, 8, 0], (5, 3))
    gts[0, :5, 3:6] = [1.6, 3.9, 1.56]
    gts[0, :5, 6] = rng.uniform(-3, 3, 5)
    gts[0, 1, :3] = gts[0, 0, :3] + [2.5, 0.0, 0.0]
    cls = np.zeros((2, g), np.int32)
    cls[0, :5] = [0, 1, 2, 0, 1]
    mask = np.zeros((2, g), bool)
    mask[0, :5] = True
    kp = rng.uniform([0, -10, -3], [22, 10, 1], (2, k, 3)).astype(np.float32)
    near = gts[0, rng.integers(0, 5, 20), :3] + rng.normal(0, 1.0, (20, 3))
    kp[0, :20] = near
    kp[0, 20] = gts[0, 0, :3] + [1.25, 0.0, 0.0]       # within 2 m of gts 0 and 1
    return kp.astype(np.float32), gts, cls, mask


def test_keypoint_targets_equal_jax():
    """One-hot class targets (ignore channel, random negatives, positives,
    the ambiguous fallback to background, a frame with no gt) and the
    regression targets, against JAX's function frame by frame."""
    cfg = Config()
    cfg = cfg.replace(anchors=tuple(dataclasses.replace(a, radius=2.0)
                                    for a in cfg.anchors))
    kp, gts, cls, mask = _kp_cases()
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    want = [j_kp_targets(keys[b], jnp.asarray(kp[b]), jnp.asarray(gts[b]),
                         jnp.asarray(cls[b]), jnp.asarray(mask[b]), cfg) for b in range(2)]
    neg = np.stack([np.asarray(jax.random.randint(
        keys[b], (cfg.train.refinement_num_negatives,), 0, kp.shape[1]))
        for b in range(2)])
    got = assign_refinement_targets_keypoints(
        torch.from_numpy(neg), torch.from_numpy(kp), torch.from_numpy(gts),
        torch.from_numpy(cls), torch.from_numpy(mask), port_cfg(cfg))
    for b in range(2):
        np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(want[b][0]))
        np.testing.assert_allclose(got[1][b].numpy(), np.asarray(want[b][1]),
                                   rtol=1e-6, atol=1e-6)
    c = got[0].numpy()
    n_cls = cfg.num_classes
    assert (c[0, :, :n_cls].sum(0) > 0).all(), "a class with no positive"
    assert c[0, 20].tolist() == [0, 0, 0, 1, 0], "the ambiguous keypoint"
    assert c[1, :, :n_cls].sum() == 0 and ((c[1, :, -1] == 1) | (c[1, :, -2] == 1)).all()
    assert (c[:, :, -1] == 1).any() and (c[:, :, -2] == 1).any()


# --- the refinement loss ------------------------------------------------

def _refine_case(zero_padding=True):
    rng = np.random.default_rng(13)
    b, n, g = 2, 12, 5
    props = np.zeros((b, n, 7), np.float32)
    props[..., :3] = rng.uniform([0, -10, -2], [20, 10, 0], (b, n, 3))
    props[..., 3:6] = rng.uniform([1.4, 3.5, 1.4], [1.8, 4.2, 1.7], (b, n, 3))
    props[..., 6] = rng.uniform(-3, 3, (b, n))
    gts = np.zeros((b, g, 7), np.float32)
    gts[0, :3] = props[0, [1, 4, 7]] + rng.normal(0, 0.1, (3, 7)).astype(np.float32)
    gts[0, 3] = props[0, 4] + 0.3         # a second gt on proposal 4
    gm = np.zeros((b, g), bool)
    gm[0, :4] = True                       # frame 1 has no gt
    if not zero_padding:
        gts[~gm] = [0, 0, 0, 1, 1, 1, 0]
    deltas = rng.normal(0, 0.3, (b, n, 7)).astype(np.float32)
    logits = rng.normal(0, 1.0, (b, n)).astype(np.float32)
    valid = np.ones((b, n), bool)
    valid[1, -2:] = False
    return deltas, logits, props, valid, gts, gm


def test_refinement_loss_and_gradients_match_jax():
    """The three losses and their gradients with respect to the deltas,
    the logits and the proposals, against jax.grad of JAX's loss.

    Where a frame has no gt JAX matches a zero-size padding box: its loss
    stays finite, but ``log(0)`` in the masked residual makes its gradient
    NaN. The port's loss and gradients, on that frame, are JAX's on the
    same frame whose padding boxes have a size."""
    cfg = Config()
    case = _refine_case()
    tcase = [torch.from_numpy(a) for a in case]
    for t in tcase[:3]:
        t.requires_grad_(True)
    got = refinement_loss(*tcase, port_cfg(cfg))
    got["refine_loss"].backward()

    def loss(d, lg, p, v, g, m):
        out = j_refinement_loss(d, lg, p, v, g, m, cfg)
        return out["refine_loss"], out

    jgrad = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)
    (dd, dl, dp), out = jgrad(*[jnp.asarray(a) for a in _refine_case(False)])
    for k in ("refine_cls_loss", "refine_reg_loss", "refine_loss"):
        np.testing.assert_allclose(float(got[k]), float(out[k]), rtol=1e-6, err_msg=k)
    assert float(out["refine_reg_loss"]) > 0
    for t, want in zip(tcase[:3], (dd, dl, dp)):
        want = np.asarray(want)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=1e-6 * float(np.abs(want).max()))
    assert np.abs(np.asarray(dp)).max() > 0      # the target carries gradient
    (dd, _, dp), out = jgrad(*[jnp.asarray(a) for a in case])
    np.testing.assert_allclose(float(got["refine_loss"]), float(out["refine_loss"]),
                               rtol=1e-6)
    assert np.isnan(np.asarray(dd)[1]).any() and np.isnan(np.asarray(dp)[1]).any()
    assert all(bool(torch.isfinite(t.grad).all()) for t in tcase[:3])


# --- C2: the stage-1 tree ------------------------------------------------

def test_stage1_tree_loads_strictly_and_round_trips(jax_run, mini_set, tmp_path):
    """The JAX package's ``create_pvrcnn(two_stage=False)`` leaf set is the
    stage-1 tree's; it loads strictly into a stage-1 PV_RCNN and maps back
    to the same leaves; a two-stage model (eval_cli --model pvrcnn2)
    refuses it, naming the missing modules."""
    cfg = jax_run["cfg"]
    pts, num = _inputs()
    shapes = jax.eval_shape(lambda: JPV(cfg).init(jax.random.PRNGKey(0), pts, num,
                                                  train=False))
    shapes = {k: shapes[k] for k in ("params", "batch_stats")}
    tree = jax_run["variables"]["pvrcnn"]
    assert set(_flat(shapes)) == set(_flat(tree))
    sd = convert.pvrcnn_state_dict_from_flax(tree)
    tcfg = port_cfg(cfg)
    model, _ = tpv.create_pvrcnn(tcfg, device="cpu", state_dict=sd, two_stage=False)
    assert not tpv.has_stage2(model.state_dict())
    back, want = _flat(convert.flax_from_state_dict(model.state_dict())), _flat(tree)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="roi_grid_pool, refinement, keypoint_seg"):
        tpv.create_pvrcnn(tcfg, device="cpu", state_dict=sd)
    with pytest.raises(ValueError, match="two_stage=False"):
        model.two_stage(torch.from_numpy(pts), torch.from_numpy(num),
                        torch.as_tensor(make_anchors(tcfg)))
    npz = tmp_path / "stage1.npz"
    np.savez(npz, **{"/".join(k): v for k, v in _flat_paths(tree)})
    with pytest.raises(ValueError, match="stage-1 tree"):
        eval_cli.main(["--config", str(mini_set[1]), "--model", "pvrcnn2",
                       "--weights", str(npz), "--device", "cpu"])


def _flat_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("mode", MODES)
def test_train_state_converts_both_ways(jax_run, port_run, mode):
    """JAX's state after its step (parameters, batch statistics, Adam
    moments, count) into the port and back, bit for bit; and the port's
    own Adam state after its step read as optax's: a stage-1 step's point
    branch has no torch state, and reads as zero moments, as optax's,
    with the global count."""
    out = jax_run["out"][mode]
    variables = {"params": out["params"], "batch_stats": out["batch_stats"]}
    cfg, model, tx, state = _port_state(jax_run, mode, variables)
    adam = out["adam"]
    sd = tx.state_dict()
    sd["state"] = convert.opt_state_from_optax(adam.mu, adam.nu, int(adam.count), model)
    tx.load_state_dict(sd)
    back = convert.flax_from_state_dict(model.state_dict())
    mu, nu, count = convert.optax_from_opt_state(tx.state_dict()["state"], model)
    assert count == 1
    for a, b in ((back, variables), (mu, adam.mu), (nu, adam.nu)):
        fa, fb = _flat(a), _flat(b)
        assert set(fa) == set(fb)
        for k in fb:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)

    port_tx = port_run[mode]["tx"]
    own = port_tx.state_dict()["state"]
    n_params = len(list(port_run[mode]["model"].parameters()))
    assert len(own) == n_params - (60 if mode == "pvrcnn" else 0)
    mu, nu, count = convert.optax_from_opt_state(own, port_run[mode]["model"])
    assert count == 1
    fmu, jmu = _flat(mu), _flat(adam.mu)
    assert set(fmu) == set(jmu)
    for k, want in jmu.items():
        if mode == "pvrcnn" and "pnets_" in k:
            assert not fmu[k].any() and not want.any(), k
        np.testing.assert_allclose(fmu[k], want, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(want).max()), err_msg=k)


def test_step_draws_are_seeded_by_seed_and_step():
    cfg = port_cfg(train_cfg())
    u0, n0 = ttrain.pvrcnn_draws(cfg, 2, 0, 5)
    u1, n1 = ttrain.pvrcnn_draws(cfg, 2, 0, 5)
    u2, n2 = ttrain.pvrcnn_draws(cfg, 2, 0, 6)
    assert torch.equal(u0, u1) and torch.equal(n0, n1)
    assert not torch.equal(u0, u2) and not torch.equal(n0, n2)
    assert u0.shape == (2, 8, 4, 3) and n0.shape == (2, 128)
    assert float(u0.min()) >= 0 and float(u0.max()) < 1
    assert int(n0.min()) >= 0 and int(n0.max()) < cfg.num_keypoints


# --- train_cli and eval_cli ----------------------------------------------

def _yaml_doc(root):
    return {
        "MAX_VOXELS": 256, "VOXEL_SIZE": [0.4, 0.4, 0.1],
        "GRID_BOUNDS": [0.0, -12.8, -3.0, 25.6, 12.8, 1.0], "NUM_CLASSES": 1,
        "NUM_KEYPOINTS": 64,
        "ANCHORS": [dict(names=["Car"], wlh=[1.6, 3.9, 1.56], yaw=[0, 1.501],
                         iou_thresh=[0.45, 0.6], score_thresh=0.3, center_z=-1.0)],
        "AUG": {"NUM_SAMPLE_OBJECTS": [2, 0, 0]},
        "CAPACITY": {"MAX_POINTS": 1024, "MAX_GT_BOXES": 16},
        "PROPOSAL": {"C_IN": 128, "TOPK": 8},
        "GRIDPOOL": {"NUM_GRIDPOINTS": 4, "MLPS_PN": [[512, 32, 16], [512, 32, 16]],
                     "MLPS_REDUCTION": [128, 32, 32]},
        "REFINEMENT": {"MLPS": [32, 16]},
        "DATA": {"CACHEDIR": str(root / "cache"), "SPLITDIR": str(root / "splits"),
                 "ROOTDIR": str(root / "kitti")},
    }


@pytest.fixture(scope="module")
def mini_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("pv_train")
    write_fake_kitti(str(root / "kitti"), Config(), n_frames=4)
    os.makedirs(root / "splits")
    (root / "splits" / "train.txt").write_text("0\n1\n")
    (root / "splits" / "val.txt").write_text("2\n3\n")
    yml = root / "pv.yaml"
    yml.write_text(yaml.safe_dump(_yaml_doc(root)))
    return root, yml


@pytest.mark.parametrize("mode", MODES)
def test_train_cli_then_eval_cli(mini_set, mode):
    """train_cli --model pvrcnn|pvrcnn2 takes one step and checkpoints;
    eval_cli loads the checkpoint as the model it holds, and --model
    pvrcnn2 refuses a stage-1 checkpoint."""
    root, yml = mini_set
    ckdir = root / f"ck_{mode}"
    recs = train_cli.main(["--config", str(yml), "--model", mode, "--batch-size", "2",
                           "--workers", "0", "--epochs", "1", "--ckpt-dir", str(ckdir),
                           "--metrics-jsonl", str(root / f"{mode}.jsonl"),
                           "--device", "cpu"])
    assert len(recs) == 1 and recs[0]["steps"] == 1
    assert np.isfinite(recs[0]["losses"]).all()
    ckpt = torch.load(recs[0]["checkpoint"], weights_only=True)
    assert ckpt["step"] == 1
    assert tpv.has_stage2(ckpt["model"]) == (mode == "pvrcnn2")
    for kind in ("pvrcnn", "pvrcnn2"):
        args = ["--config", str(yml), "--model", kind, "--ckpt", recs[0]["checkpoint"],
                "--batch-size", "2", "--device", "cpu"]
        if mode == "pvrcnn" and kind == "pvrcnn2":
            with pytest.raises(ValueError, match="stage-1 tree"):
                eval_cli.main(args)
            continue
        table, timing = eval_cli.main(args)
        assert timing["frames"] == 2 and set(table) == {0}
        assert all(np.isfinite(v) for v in table[0].values())
