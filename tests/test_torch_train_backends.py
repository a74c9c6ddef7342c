"""SECOND training in the forms of the JAX package's ``make_train_step``
beside the all-sparse voxel one: dense late stages
(``train_dense_from_stage`` 2 or 3) and the column backend
(``SPARSE_BACKEND: column``, at 4 and at 2), the port against the JAX
package on the CPU at tiny_cfg, and the modules these forms add:
``dense_from_sparse`` / ``DensifyFn`` against ``densify_gather``, the
transposed BEV rulebook against a brute-force inversion, ``ColumnConvFn``'s
backward against ``jax.vjp`` of ``column_conv_dz``, and the column batch
norm's training statistics against ``MaskedBatchNormFlat``. Port against
port: voxel at 3 and PV-RCNN two-stage at 2 against the same model at 4
(the dense and the sparse stages compute the same sites).

Both packages start from the port's seeded init carried to flax by
convert.py; the JAX side is one ``jax.jit`` of the loss and its gradient
per form, which also hands back every ReLU's input (``capture_intermediates``
of the batch norms): a ReLU input within float32 noise of zero can be
positive in one package and not in the other, and such a gate moves the
gradients of every layer before it (one of the column form's did, by 1.2e-3
of the first conv's gradient), so the port's backward takes JAX's gates
(``chip_smoke.relu_gates``, as tests/test_torch_pvrcnn_train.py does) and
the count of gates that differ is bounded. The JAX jit runs with XLA's optimisation passes off while it compiles (the
compile is these tests' cost, the run is nothing). oneDNN is off and two intra-op threads, as in
tests/test_torch_train.py. The CUDA kernels of these paths are held
against their plain versions in tests/test_torch_cuda.py."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision3d_tpu.core.anchors import make_anchors as j_make_anchors
from vision3d_tpu.core.targets import assign_targets_batch as j_assign_targets
from vision3d_tpu.models import sparse_cnn as jscnn
from vision3d_tpu.models.losses import proposal_loss as j_proposal_loss
from vision3d_tpu.models.second import Second as JSecond
from vision3d_tpu.ops import column_sparse as jcsp
from vision3d_tpu_torch import convert
from vision3d_tpu_torch.core.anchors import make_anchors
from vision3d_tpu_torch.core.targets import assign_targets_batch
from vision3d_tpu_torch.models import sparse_cnn as tscnn
from vision3d_tpu_torch.models.losses import proposal_loss
from vision3d_tpu_torch.ops import column_conv as tcc
from vision3d_tpu_torch.ops import column_sparse as tcsp
from vision3d_tpu_torch.ops import sparse as tsp
from vision3d_tpu_torch.training import train as ttrain

from test_torch_column import quick_compile
from test_torch_pvrcnn import pv_cfg
from test_train import synthetic_train_batch
from torch_parity import ROOT, port_cfg, sorted_key_sets

sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# f32 sums in other orders through 14 convs, the RPN and the head: each
# loss term to 1e-4 relative, every gradient to 1e-3 of its tensor's max,
# running statistics to 1e-5 of 1 + |value| (tests/test_torch_train.py)
LOSS_TOL, GRAD_TOL, STAT_TOL = 1e-4, 1e-3, 1e-5
# the same port model with its late stages dense or sparse
PORT_LOSS_TOL, PORT_GRAD_TOL = 1e-5, 1e-4
FORMS = {"voxel2": dict(train_dense_from_stage=2),
         "column4": dict(sparse_backend="column"),
         "column2": dict(sparse_backend="column", train_dense_from_stage=2)}


@pytest.fixture(scope="module", autouse=True)
def plain_f32():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            yield
    finally:
        torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def init(tiny_cfg):
    """One seeded init for every form: the port's state dict, its flax
    tree, and the batch of tests/test_torch_train.py."""
    model, _, _ = ttrain.create_train_state(port_cfg(tiny_cfg),
                                            torch.Generator().manual_seed(0), device="cpu")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batch = {k: np.asarray(v) for k, v in
             synthetic_train_batch(tiny_cfg, np.random.default_rng(0)).items()}
    return sd, convert.flax_from_state_dict(sd), batch


def _feeds_relu(mdl, method):
    """The JAX modules whose outputs are ReLU inputs: the batch norms."""
    return method == "__call__" and type(mdl).__name__ in (
        "MaskedBatchNorm", "MaskedBatchNormFlat", "BatchNorm")


def _jax_gates(inter, shapes):
    """JAX's ReLU inputs -> the port's gates (x > 0) in its call order
    (stage by stage the subm convs then the strided one, then the RPN's
    seven) and its shapes: dense volumes and the RPN channel-first, column
    rows (B, N, D, C)."""
    paths, subm = [], 0
    for si, n in enumerate((2, 2, 3, 3)):
        for _ in range(n):
            paths.append(("cnn", f"SubMConv_{subm}", "MaskedBatchNorm_0"))
            subm += 1
        paths.append(("cnn", f"SparseConvDown_{si}", "MaskedBatchNorm_0"))
    paths += [("rpn", f"ConvBNReLU_{i}", "BatchNorm_0") for i in range(7)]
    assert len(paths) == len(jax.tree_util.tree_leaves(inter)) == len(shapes)
    gates = []
    for path, shape in zip(paths, shapes):
        node = inter
        for k in path:
            node = node[k]
        z = np.asarray(node["__call__"][0])
        if z.ndim == 5 or path[0] == "rpn":      # channels-last -> channel-first
            z = np.moveaxis(z, -1, 1)
        gates.append(torch.from_numpy(z > 0).reshape(shape))
    return gates


def _port_step(cfg, sd, batch, gates=None):
    """The port's training-mode forward, loss and backward, on the ReLU
    gates ``gates`` where given: (losses, gradients, state dict after the
    forward, counters, ReLU gates that differed from ``gates``, the ReLU
    inputs' shapes)."""
    own = []
    with chip_smoke.relu_gates(own if gates is None else gates,
                               replay=gates is not None) as differ:
        out = _port_forward_backward(cfg, sd, batch)
    return out + (sum(differ), [g.shape for g in own])


def _port_forward_backward(cfg, sd, batch):
    model, _, _ = ttrain.create_train_state(cfg, device="cpu", state_dict=sd)
    b = {k: _t(v) for k, v in batch.items()}
    anchors = torch.as_tensor(make_anchors(cfg))
    with torch.no_grad():
        targets = assign_targets_batch(b["boxes"], b["class_idx"], b["gt_mask"],
                                       b["box_ignore"], anchors, cfg)
    cls_map, reg_map, diag = model(b["points"], b["num_points"])
    losses = proposal_loss(cls_map, reg_map, targets, cfg)
    losses["loss"].backward()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()},
            {k: int(v) for k, v in diag.items()})


@pytest.fixture(scope="module", params=list(FORMS))
def form_run(request, tiny_cfg, init):
    """One form on both sides: JAX's loss, gradients and new batch
    statistics from one jit, and the port's step from the same weights."""
    sd, variables, batch = init
    jcfg = tiny_cfg.replace(**FORMS[request.param])
    model = JSecond(jcfg)
    anchors = jnp.asarray(j_make_anchors(jcfg))

    def loss_fn(params, stats, batch):
        targets = jax.lax.stop_gradient(j_assign_targets(
            batch["boxes"], batch["class_idx"], batch["gt_mask"], batch["box_ignore"],
            anchors, jcfg))
        (cls_map, reg_map), mutated = model.apply(
            {"params": params, "batch_stats": stats}, batch["points"], batch["num_points"],
            train=True, mutable=["batch_stats", "intermediates"],
            capture_intermediates=_feeds_relu)
        losses = j_proposal_loss(cls_map, reg_map, targets, jcfg)
        return losses["loss"], (losses, mutated["batch_stats"], mutated["intermediates"])

    with quick_compile():
        (_, (losses, stats, inter)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"], batch)
    ref_grads = convert.state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray,
                                                                               grads)})
    ref_stats = convert.state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": variables["params"], "batch_stats": stats}))
    cfg = port_cfg(jcfg)
    gates = _jax_gates(inter, _port_step(cfg, sd, batch)[-1])
    port = _port_step(cfg, sd, batch, gates)
    return dict(form=request.param, jax_losses={k: float(v) for k, v in losses.items()},
                jax_grads=ref_grads, jax_stats=ref_stats, sd0=sd, port=port,
                n_gates=sum(g.numel() for g in gates))


def test_loss_matches_jax(form_run):
    losses, _, _, diag, differ, _ = form_run["port"]
    assert differ <= 1e-5 * form_run["n_gates"], differ
    for k in ("loss", "cls_loss", "reg_loss"):
        np.testing.assert_allclose(losses[k], form_run["jax_losses"][k], rtol=LOSS_TOL,
                                   err_msg=k)
    assert losses["reg_loss"] > 0
    column = form_run["form"].startswith("column")
    sparse_stages = 4 if form_run["form"].endswith("4") else 2
    name = "stage{}_columns_dropped" if column else "stage{}_dropped"
    want = {"voxelizer_dropped"} | {name.format(i + 1) for i in range(sparse_stages)}
    assert set(diag) == want | ({"stage0_columns_dropped"} if column else set())
    assert all(v == 0 for k, v in diag.items() if k != "voxelizer_dropped")


def test_every_gradient_matches_jax(form_run):
    grads = form_run["port"][1]
    ref = form_run["jax_grads"]
    assert set(ref) == set(grads)
    for name, got in grads.items():
        r = ref[name].numpy()
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(got.numpy(), r, atol=GRAD_TOL * float(np.abs(r).max()),
                                   rtol=0, err_msg=name)


def test_bn_running_stats_match_jax(form_run):
    """Every running statistic moved, and equals JAX's: the dense stages'
    masked BN on the channel axis, the column stages' one-pass variance."""
    stats = form_run["port"][2]
    ref = form_run["jax_stats"]
    names = [k for k in ref if "running_" in k]
    assert len(names) == 2 * (10 + 4 + 7)
    for k in names:
        np.testing.assert_allclose(stats[k].numpy(), ref[k].numpy(), rtol=STAT_TOL,
                                   atol=STAT_TOL, err_msg=k)
        assert not torch.equal(stats[k], form_run["sd0"][k]), k


@pytest.mark.parametrize("grid", [(11, 16, 14), (50, 6, 8)])
def test_dense_from_sparse_matches_jax(grid):
    """Features and occupancy bit-equal to JAX's training densify (its CSR
    gather at D <= 48, its row scatter at D > 48), and the gradient of the
    table bit-equal to ``jax.vjp``'s (one gather at each row's own cell)."""
    rng = np.random.default_rng(sum(grid))
    b, n, c = 2, 300, 8
    keys, mask = sorted_key_sets(rng, grid, b, n, 120, 280)
    feats = rng.normal(size=(b, n, c)).astype(np.float32)
    cot = rng.normal(size=(b, *grid, c)).astype(np.float32)     # (B, D, H, W, C)

    def jdense(f):
        dt = jscnn.dense_from_sparse(jscnn.SparseTensor(
            feats=f, keys=jnp.asarray(keys), mask=jnp.asarray(mask), grid=grid), False)
        return dt.feats, dt.occ

    (jf, jocc), vjp = jax.vjp(jdense, jnp.asarray(feats))
    (jg,) = vjp((jnp.asarray(cot), np.zeros(jocc.shape, jax.dtypes.float0)))
    tf = _t(feats).requires_grad_()
    dt = tscnn.dense_from_sparse(tscnn.SparseTensor(feats=tf, keys=_t(keys),
                                                    mask=_t(mask), grid=grid))
    got = dt.feats.permute(0, 2, 3, 4, 1)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(jf))
    np.testing.assert_array_equal(dt.occ.numpy(), np.asarray(jocc))
    assert int(dt.occ.sum()) == int(mask.sum())
    got.backward(_t(cot))
    np.testing.assert_array_equal(tf.grad.numpy(), np.asarray(jg))


def test_densify_fn_backward_is_the_own_cell_gather():
    """DensifyFn on a flat table: forward equals plain indexing, and the
    gradient of a live row is the output gradient at its own cell, of a
    row that is not live zero, though rows route many cells to it."""
    rng = np.random.default_rng(3)
    table = _t(rng.normal(size=(41, 5)).astype(np.float32)).requires_grad_()
    own = torch.from_numpy(rng.permutation(100)[:41].astype(np.int32))
    live = torch.from_numpy(rng.uniform(size=41) < 0.7)
    idx = torch.full((100,), 40, dtype=torch.int32)
    idx[own[live].long()] = torch.arange(41, dtype=torch.int32)[live]
    out = tsp.DensifyFn.apply(table, idx, own, live)
    torch.testing.assert_close(out, table.detach()[idx.long()], rtol=0, atol=0)
    g = _t(rng.normal(size=(100, 5)).astype(np.float32))
    out.backward(g)
    want = torch.where(live[:, None], g[own.long()], 0.0)
    torch.testing.assert_close(table.grad, want, rtol=0, atol=0)


BEV_SPECS = {"subm": ((3, 3), (1, 1), (1, 1)), "down": ((3, 3), (2, 2), (1, 1)),
             "identity": ((1, 1), (1, 1), (0, 0))}


@pytest.mark.parametrize("spec", list(BEV_SPECS))
def test_transpose_bev_rulebook_inverts_the_forward(spec):
    """Every hit (o, k2) -> i of the forward rulebook appears as (i,
    K2-1-k2) -> o in the transposed one, which holds nothing else; for the
    submanifold conv the two are equal."""
    kyx, syx, pyx = BEV_SPECS[spec]
    hw = (13, 11)
    rng = np.random.default_rng(len(spec))
    keys, mask = sorted_key_sets(rng, (1, *hw), 2, 90, 40, 80)
    keys, mask = _t(keys), _t(mask)
    out_hw = tuple((hw[i] + 2 * pyx[i] - kyx[i]) // syx[i] + 1 for i in range(2))
    if spec == "subm":
        ok, om, out_hw = keys, mask, hw
    else:
        ok, om, nd = tcsp.downsample_bev_columns(keys, mask, hw, kyx, syx, pyx, 120, out_hw)
        assert int(nd.sum()) == 0
    rb = tcsp.build_bev_rulebook_batched(keys, mask, hw, kyx, syx, pyx, ok, om, out_hw)
    rbt = tcsp.transpose_bev_rulebook_batched(keys, mask, hw, kyx, syx, pyx, ok, om,
                                              out_hw)
    k2 = kyx[0] * kyx[1]
    n, m = keys.shape[1], ok.shape[1]
    want = np.full((2, n, k2), m, np.int32)
    rbn = rb.numpy().reshape(2, m, k2)
    for bb, o, k in zip(*np.nonzero(rbn < n)):
        assert want[bb, rbn[bb, o, k], k2 - 1 - k] == m     # one reader per (i, tap)
        want[bb, rbn[bb, o, k], k2 - 1 - k] = o
    assert rbt.dtype == torch.int32
    np.testing.assert_array_equal(rbt.numpy().reshape(2, n, k2), want)
    assert (want < m).sum() > 20
    if spec == "subm":
        torch.testing.assert_close(rbt, rb, rtol=0, atol=0)


# (kernel, stride, pad, C, Cout, D) of every column conv form in
# SpMiddleFHD.block_specs: the subm conv and the three strided specs
COLUMN_SPECS = {"subm": ((3, 3, 3), (1, 1, 1), (1, 1, 1), 16, 16, 11),
                "down_p111": ((3, 3, 3), (2, 2, 2), (1, 1, 1), 16, 32, 12),
                "down_p011": ((3, 3, 3), (2, 2, 2), (0, 1, 1), 32, 64, 11),
                "down_k311": ((3, 1, 1), (2, 1, 1), (0, 0, 0), 64, 64, 6)}


@pytest.mark.parametrize("spec", list(COLUMN_SPECS))
def test_column_conv_backward_matches_jax_vjp(spec):
    """ColumnConvFn's backward, decomposed as on the card (dX a column conv
    over the transposed rulebook with flipped, transposed weights on
    z-interleaved gradient rows; dW a row regather and one GEMM), against
    jax.vjp of column_conv_dz: the output, dX and dW to 1e-5 of their
    scale. D 12 at the padded strided conv and D 6 at the (3, 1, 1) conv
    leave an input row that the forward's floor division drops (a
    trailing zero row after the interleave)."""
    kernel, stride, pad, c, cout, d = COLUMN_SPECS[spec]
    kyx, syx, pyx = kernel[1:], stride[1:], pad[1:]
    hw = (12, 10)
    rng = np.random.default_rng(len(spec) + c)
    keys, mask = sorted_key_sets(rng, (1, *hw), 2, 70, 40, 65)
    keys, mask = _t(keys), _t(mask)
    out_hw = tuple((hw[i] + 2 * pyx[i] - kyx[i]) // syx[i] + 1 for i in range(2))
    if kyx == (1, 1) and syx == (1, 1):
        ok, om = keys, mask
    else:
        ok, om, _ = tcsp.downsample_bev_columns(keys, mask, hw, kyx, syx, pyx, 90, out_hw)
    rb = tcsp.build_bev_rulebook_batched(keys, mask, hw, kyx, syx, pyx, ok, om, out_hw)
    rbt = tcsp.transpose_bev_rulebook_batched(keys, mask, hw, kyx, syx, pyx, ok, om, out_hw)
    k = kernel[0] * kyx[0] * kyx[1]
    x = (rng.normal(size=(2, 70, d, c)) * (rng.uniform(size=(2, 70, d, 1)) < 0.5)
         * mask.numpy()[..., None, None]).astype(np.float32).reshape(2, 70, d * c)
    w = (rng.normal(size=(k * c, cout)) / np.sqrt(k * c)).astype(np.float32)
    d_out = (d + 2 * pad[0] - kernel[0]) // stride[0] + 1
    g = rng.normal(size=(2, ok.shape[1], d_out * cout)).astype(np.float32)

    def jconv(xx, ww):
        return jcsp.column_conv_dz(xx, jnp.asarray(rb.numpy()), ww, kernel, d, c,
                                   stride[0], pad[0])

    with quick_compile():
        ref, (rdx, rdw) = jax.jit(lambda xx, ww, gg: (
            jconv(xx, ww), jax.vjp(jconv, xx, ww)[1](gg)))(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    out = tcc.ColumnConvFn.apply(tx, rb, rbt, tw, kernel, d, c, stride[0], pad[0],
                                 torch.float32)
    out.backward(_t(g))
    for got, want in ((out.detach(), ref), (tx.grad, rdx), (tw.grad, rdw)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_column_bn_training_statistics_match_masked_bn_flat():
    """The column batch norm in training mode (``bn_relu`` on the one-pass
    statistics, as the column representation runs it on its rows) against
    ``MaskedBatchNormFlat(train=True)`` on the same rows and parameters:
    its output (ReLU'd and masked), and the running mean and the one-pass
    variance after the update, with a constant channel (variance 0)."""
    rng = np.random.default_rng(5)
    b, n, d, c = 2, 40, 7, 16
    x = rng.normal(1.0, 2.0, size=(b, n, d, c)).astype(np.float32)
    x[..., 3] = 5.0                            # constant channel: var 0, E[x^2] ~ mean^2
    site = rng.uniform(size=(b, n, d)) < 0.4
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    mean0 = rng.normal(size=c).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, c).astype(np.float32)
    flat = jnp.asarray(x.reshape(b, n, d * c))
    maskf = jcsp.expand_site_mask(jnp.asarray(site), c)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    y, mutated = jscnn.MaskedBatchNormFlat(channels=c).apply(
        variables, flat, maskf, True, mutable=["batch_stats"])
    want = np.asarray(jax.nn.relu(y) * maskf)
    bn = tscnn.MaskedBatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
        bn.running_mean.copy_(_t(mean0))
        bn.running_var.copy_(_t(var0))
    got = tscnn.bn_relu(bn, _t(x), _t(site), one_pass=True).reshape(b, n, d * c)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), mutated["batch_stats"]["mean"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), mutated["batch_stats"]["var"],
                               rtol=1e-6, atol=1e-6)


def _assert_same_step(cfg, sd, batch, step_of):
    """One step of the port at ``cfg`` and at ``train_dense_from_stage = 4``
    from one state dict, ``step_of(cfg, sd, batch) -> (losses, gradients)``:
    the losses and every gradient agree."""
    (l_dense, g_dense), (l_sparse, g_sparse) = (
        step_of(c, sd, batch) for c in (cfg, cfg.replace(train_dense_from_stage=4)))
    for k, v in l_sparse.items():
        np.testing.assert_allclose(l_dense[k], v, rtol=PORT_LOSS_TOL, err_msg=k)
    assert set(g_dense) == set(g_sparse)
    for name, r in g_sparse.items():
        np.testing.assert_allclose(g_dense[name].numpy(), r.numpy(), rtol=0,
                                   atol=PORT_GRAD_TOL * float(r.abs().max()), err_msg=name)


def test_port_voxel_dense_from_3_matches_all_sparse(tiny_cfg, init):
    sd, _, batch = init
    cfg = port_cfg(tiny_cfg.replace(train_dense_from_stage=3))
    _assert_same_step(cfg, sd, batch, lambda c, s, b: _port_forward_backward(c, s, b)[:2])


def _pvrcnn2_step(cfg, sd, batch):
    model, tx, state = ttrain.create_pvrcnn_train_state(cfg, device="cpu", state_dict=sd)
    grads, update = {}, tx.step

    def grab_then_update(count):
        grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters()})
        update(count)

    tx.step = grab_then_update
    step = ttrain.make_pvrcnn_train_step(model, tx, cfg, train_stage2=True, seed=0)
    _, losses = step(state, {k: _t(v) for k, v in batch.items()})
    return {k: float(v) for k, v in losses.items()}, grads


def test_port_pvrcnn2_dense_from_2_matches_all_sparse():
    """PV-RCNN's two-stage step reads its stride-4 scale back from the dense
    stage 2 (``DenseTensor.to_voxel_sparse``), and the keypoints, ball
    queries and grid pool then see what the sparse stages give."""
    cfg = port_cfg(pv_cfg()).replace(train_dense_from_stage=2)
    model, _, _ = ttrain.create_pvrcnn_train_state(cfg, torch.Generator().manual_seed(1),
                                                   device="cpu")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batch = {k: np.asarray(v) for k, v in
             synthetic_train_batch(pv_cfg(), np.random.default_rng(1), n=400).items()}
    _assert_same_step(cfg, sd, batch, _pvrcnn2_step)
