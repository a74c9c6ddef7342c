"""Training parity of the whole model: one SECOND training step of the port against the
JAX package's at tiny_cfg on the CPU, from the JAX init carried across by
convert.py: loss, every gradient, batch-norm statistics, the optimizer
over several steps, state conversion both ways and the checkpoint."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vision3d_tpu.core.anchors import make_anchors
from vision3d_tpu.core.targets import assign_targets_batch
from vision3d_tpu.models.losses import proposal_loss
from vision3d_tpu.training.train import create_train_state, make_train_step
from vision3d_tpu_torch import convert
from vision3d_tpu_torch.training import checkpoint as tckpt
from vision3d_tpu_torch.training import train as ttrain

from test_train import synthetic_train_batch
from torch_parity import port_cfg

SPE = 10   # steps per epoch of the schedule under test


@pytest.fixture(scope="module", autouse=True)
def plain_f32_convs():
    """oneDNN's float32 conv backward on the CPU is a reduced-accuracy
    algorithm (the RPN's 3x3 backward-data is off by ~8e-3 of the gradient's
    scale; the port in float64 agrees with JAX's float32 to 5e-6). Like
    TF32 on the card, it is switched off where floats are compared. Two
    intra-op threads: at tiny_cfg more gain nothing, and beside other test
    workers they spin on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            yield
    finally:
        torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


@pytest.fixture(scope="module")
def jax_run(tiny_cfg):
    """The JAX side, jitted once: the init, loss + gradients + new batch
    statistics at the init, and the states and losses of three steps."""
    batch = synthetic_train_batch(tiny_cfg, np.random.default_rng(0))
    model, tx, state = create_train_state(
        tiny_cfg, jax.random.PRNGKey(0), steps_per_epoch=SPE,
        example_batch=(batch["points"][:1], batch["num_points"][:1]))
    anchors = jnp.asarray(make_anchors(tiny_cfg))

    def loss_fn(params, stats, batch):
        targets = jax.lax.stop_gradient(assign_targets_batch(
            batch["boxes"], batch["class_idx"], batch["gt_mask"],
            batch["box_ignore"], anchors, tiny_cfg))
        (cls_map, reg_map), mutated = model.apply(
            {"params": params, "batch_stats": stats}, batch["points"],
            batch["num_points"], train=True, mutable=["batch_stats"])
        losses = proposal_loss(cls_map, reg_map, targets, tiny_cfg)
        return losses["loss"], (losses, mutated["batch_stats"])

    (_, (losses, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params, state.batch_stats, batch)
    step = jax.jit(make_train_step(model, tx, tiny_cfg))
    states, step_losses = [state], []
    for _ in range(3):
        s, out = step(states[-1], batch)
        states.append(s)
        step_losses.append(float(out["loss"]))
    return dict(batch=_np(batch), state0=_np({"params": state.params,
                                              "batch_stats": state.batch_stats}),
                losses=_np(losses), grads=_np(grads), stats=_np(stats),
                states=states, step_losses=step_losses)


def _port(tiny_cfg, variables):
    cfg = port_cfg(tiny_cfg)
    model, tx, state = ttrain.create_train_state(
        cfg, steps_per_epoch=SPE, device="cpu",
        state_dict=convert.state_dict_from_flax(variables))
    return cfg, model, tx, state


def _batch(jax_run):
    return {k: torch.from_numpy(np.array(v)) for k, v in jax_run["batch"].items()}


@pytest.fixture(scope="module")
def port_run(tiny_cfg, jax_run):
    """The port's forward + backward at the same init and batch, and its
    own three steps."""
    cfg, model, tx, state = _port(tiny_cfg, jax_run["state0"])
    batch = _batch(jax_run)
    step = ttrain.make_train_step(model, tx, cfg)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    state, out = step(state, batch)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    first = {k: float(v) for k, v in out.items()}
    stats = {k: v.clone() for k, v in model.state_dict().items()}
    step_losses = [first["loss"]]
    for _ in range(2):
        state, out = step(state, batch)
        step_losses.append(float(out["loss"]))
    return dict(model=model, tx=tx, state=state, step=step, batch=batch, sd0=sd0,
                grads=grads, first=first, stats=stats, step_losses=step_losses,
                diag={k: int(v) for k, v in state.diagnostics.items()})


def test_loss_matches_jax(jax_run, port_run):
    """f32 sums in other orders through 14 sparse convs, the RPN and the
    head: 1e-4 relative on each loss term."""
    for k in ("loss", "cls_loss", "reg_loss"):
        np.testing.assert_allclose(port_run["first"][k], float(jax_run["losses"][k]),
                                   rtol=1e-4)
    assert set(port_run["diag"]) == {"voxelizer_dropped", "stage1_dropped",
                                     "stage2_dropped", "stage3_dropped",
                                     "stage4_dropped"}


def test_every_gradient_matches_jax_grad(jax_run, port_run):
    """Every parameter's gradient against jax.grad through the custom
    VJPs: 1e-3 of that tensor's max."""
    ref = convert.state_dict_from_flax({"params": jax_run["grads"]})
    assert set(ref) == set(port_run["grads"])
    for name, got in port_run["grads"].items():
        r = ref[name].numpy()
        np.testing.assert_allclose(got.numpy(), r, atol=1e-3 * float(np.abs(r).max()),
                                   rtol=0, err_msg=name)


def test_bn_running_stats_match_jax_after_a_step(jax_run, port_run):
    """Masked BN and the RPN BN both update with the BIASED batch
    variance at momentum 0.01: 1e-5 (of 1 + |value|)."""
    ref = convert.state_dict_from_flax({"params": jax_run["state0"]["params"],
                                        "batch_stats": jax_run["stats"]})
    names = [k for k in ref if "running_" in k]
    assert len(names) == 2 * (10 + 4 + 7)
    moved = 0
    for k in names:
        np.testing.assert_allclose(port_run["stats"][k].numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
        moved += not torch.equal(port_run["stats"][k], port_run["sd0"][k])
    assert moved == len(names)


def test_three_steps_match_jax(jax_run, port_run):
    """Clip + Adam + schedule + BN statistics over three steps: the loss of
    each step to 1e-3 relative."""
    np.testing.assert_allclose(port_run["step_losses"], jax_run["step_losses"],
                               rtol=1e-3)
    assert port_run["state"].step == 3


def test_jax_train_state_converts_both_ways(tiny_cfg, jax_run):
    """A JAX TrainState after two steps (parameters, batch statistics,
    Adam moments, count) carried into the port: the third step's loss
    equals JAX's to 1e-4, and the state goes back bit for bit."""
    s2 = jax_run["states"][2]
    variables = _np({"params": s2.params, "batch_stats": s2.batch_stats})
    adam = _adam_state(s2.opt_state)
    cfg, model, tx, state = _port(tiny_cfg, variables)
    mu, nu = _np(adam.mu), _np(adam.nu)
    sd = tx.state_dict()
    sd["state"] = convert.opt_state_from_optax(mu, nu, int(adam.count), model)
    tx.load_state_dict(sd)
    state.step = int(s2.step)

    back = convert.flax_from_state_dict(model.state_dict())
    mu2, nu2, count = convert.optax_from_opt_state(tx.state_dict()["state"], model)
    assert count == 2
    for a, b in ((back["params"], variables["params"]),
                 (back["batch_stats"], variables["batch_stats"]), (mu2, mu), (nu2, nu)):
        la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, y)

    _, out = ttrain.make_train_step(model, tx, cfg)(state, _batch(jax_run))
    np.testing.assert_allclose(float(out["loss"]), jax_run["step_losses"][2], rtol=1e-4)
    assert state.step == 3


def test_loss_decreases_over_12_steps(port_run):
    losses = list(port_run["step_losses"])
    state = port_run["state"]
    for _ in range(9):
        state, out = port_run["step"](state, port_run["batch"])
        losses.append(float(out["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert state.step == 12


def test_checkpoint_round_trip_bit_equal(tiny_cfg, jax_run, port_run, tmp_path):
    """save -> maybe_resume into a fresh state: model, Adam moments and
    step bit-equal, the newest epoch wins, and the next step's loss is
    the same float."""
    src = port_run["state"]
    cfg, model, tx, fresh = _port(tiny_cfg, jax_run["state0"])
    assert tckpt.maybe_resume(str(tmp_path), fresh) == (fresh, 0)
    tckpt.save_checkpoint(str(tmp_path), fresh, 2)
    path = tckpt.save_checkpoint(str(tmp_path), src, 10)
    assert path.endswith("epoch_10")
    state, epoch = tckpt.maybe_resume(str(tmp_path), fresh)
    assert epoch == 11 and state.step == src.step
    for k, v in src.model.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    a, b = src.optimizer.state_dict()["state"], tx.state_dict()["state"]
    assert set(a) == set(b) and len(a) > 0
    for i in a:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[i][key], b[i][key]), (i, key)
    batch = port_run["batch"]
    _, o1 = ttrain.make_train_step(model, tx, cfg)(state, batch)
    _, o2 = port_run["step"](src, batch)
    assert float(o1["loss"]) == float(o2["loss"])


def test_fresh_init_statistics(tiny_cfg):
    """init_second draws the JAX package's distributions: sparse convs std
    sqrt(2/Cout), RPN xavier-normal, head normal(0.01) with the focal-prior
    cls bias; the same generator seed gives the same weights."""
    cfg = port_cfg(tiny_cfg)
    m1, _, _ = ttrain.create_train_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    m2, _, _ = ttrain.create_train_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert m1.training
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    w = m1.cnn.subm[5].weight                       # (27*64, 64)
    np.testing.assert_allclose(float(w.detach().std()), (2 / 64) ** 0.5, rtol=0.05)
    r = m1.rpn[1][0].weight                         # (128, 128, 3, 3)
    np.testing.assert_allclose(float(r.detach().std()), (2 / (9 * 256)) ** 0.5, rtol=0.05)
    for block in m1.rpn:                            # flax's truncated xavier-normal
        r = block[0].weight.detach()
        sigma = (2 / ((r.shape[0] + r.shape[1]) * r.shape[2] * r.shape[3])) ** 0.5
        assert float(r.abs().max()) <= 2.2737 * sigma
    np.testing.assert_allclose(float(m1.head.conv_reg.weight.detach().std()), 0.01, rtol=0.1)
    np.testing.assert_allclose(m1.head.conv_cls.bias.detach().numpy(), -np.log(99.0),
                               rtol=1e-6)
    assert float(m1.head.conv_reg.bias.detach().abs().max()) == 0.0


def test_dense_late_training_stages_are_not_ported(tiny_cfg):
    """Dense late stages in training are ported (the name is the test's
    from before): a step at ``train_dense_from_stage = 2`` runs stages 2-3
    as dense masked volumes and matches the all-sparse step at 4 from the
    same weights, the loss to 1e-5 relative and every gradient to 1e-4 of
    its tensor's max (tests/test_torch_train_backends.py holds both against
    JAX)."""
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             synthetic_train_batch(tiny_cfg, np.random.default_rng(0)).items()}
    runs = []
    for dense_from in (2, 4):
        cfg = port_cfg(tiny_cfg.replace(train_dense_from_stage=dense_from))
        model, tx, state = ttrain.create_train_state(cfg, device="cpu")
        state, out = ttrain.make_train_step(model, tx, cfg)(state, batch)
        runs.append((float(out["loss"]), set(state.diagnostics),
                     {n: p.grad.clone() for n, p in model.named_parameters()}))
    (l2, d2, g2), (l4, d4, g4) = runs
    np.testing.assert_allclose(l2, l4, rtol=1e-5)
    assert d2 == {"voxelizer_dropped", "stage1_dropped", "stage2_dropped"} and d2 < d4
    for name, r in g4.items():
        np.testing.assert_allclose(g2[name].numpy(), r.numpy(), rtol=0,
                                   atol=1e-4 * float(r.abs().max()), err_msg=name)
