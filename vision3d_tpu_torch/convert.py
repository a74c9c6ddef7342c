"""JAX package parameters <-> the port's state_dict, and optax's Adam
state <-> ``torch.optim.Adam``'s.

The input is the flax ``{"params": ..., "batch_stats": ...}`` tree of a
``vision3d_tpu`` SECOND model as nested dicts of numpy arrays;
``load_npz`` rebuilds it from the ``.npz`` that
``tools/export_torch_weights.py`` writes, keyed by flax path
(``"params/cnn/SubMConv_0/kernel"``). The port
keeps the JAX layout for its sparse-conv weights, so the mapping is
renames plus the 2D conv transposes (HWIO -> OIHW).
``flax_from_state_dict`` is the inverse map. Adam's moments are trees
shaped like the parameters, so ``opt_state_from_optax`` /
``optax_from_opt_state`` carry them through the same renames.
"""

import numpy as np
import torch

N_DOWN = 4
N_RPN = 7     # 6 3x3 + one 1x1 ConvBNReLU


def unflatten(flat) -> dict:
    """{"a/b/c": array} -> nested dicts."""
    tree = {}
    for key, val in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(val)
    return tree


def load_npz(path) -> dict:
    """Read an exported weight file into the nested flax tree."""
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


def _leaves(n_subm, s):
    """[(state_dict name, flax collection, flax path, is 2D conv kernel)]
    of a model with ``n_subm`` submanifold convs, for the trees present
    (``s`` None: parameters only)."""
    out = []

    def bn(prefix, path):
        out.append((f"{prefix}.weight", "params", path + ("scale",), False))
        out.append((f"{prefix}.bias", "params", path + ("bias",), False))
        if s is not None:
            out.append((f"{prefix}.running_mean", "batch_stats", path + ("mean",), False))
            out.append((f"{prefix}.running_var", "batch_stats", path + ("var",), False))

    for kind, n, name in (("subm", n_subm, "SubMConv"),
                          ("down", N_DOWN, "SparseConvDown")):
        for i in range(n):
            path = ("cnn", f"{name}_{i}")
            out.append((f"cnn.{kind}.{i}.weight", "params", path + ("kernel",), False))
            bn(f"cnn.{kind}.{i}.bn", path + ("MaskedBatchNorm_0",))
    for i in range(N_RPN):
        path = ("rpn", f"ConvBNReLU_{i}")
        out.append((f"rpn.{i}.0.weight", "params", path + ("Conv_0", "kernel"), True))
        bn(f"rpn.{i}.1", path + ("BatchNorm_0",))
    for name, conv in (("conv_cls", "Conv_0"), ("conv_reg", "Conv_1")):
        out.append((f"head.{name}.weight", "params", ("head", conv, "kernel"), True))
        out.append((f"head.{name}.bias", "params", ("head", conv, "bias"), False))
    return out


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def state_dict_from_flax(variables) -> dict:
    """Map the flax tree onto ``models.second.Second``'s state_dict; with
    no ``batch_stats`` in ``variables``, onto its named parameters only.
    The tree may be SpMiddleFHD's or SpMiddleFHDLite's (no ``SubMConv_*``)."""
    trees = {"params": variables["params"],
             "batch_stats": variables.get("batch_stats")}
    n_subm = sum(k.startswith("SubMConv_") for k in trees["params"]["cnn"])
    sd = {}
    for name, coll, path, conv2d in _leaves(n_subm, trees["batch_stats"]):
        x = np.array(_get(trees[coll], path), dtype=np.float32)
        sd[name] = torch.from_numpy(np.transpose(x, (3, 2, 0, 1)) if conv2d else x)
    if trees["batch_stats"] is not None:
        for i in range(N_RPN):
            sd[f"rpn.{i}.1.num_batches_tracked"] = torch.tensor(0)
    return sd


def flax_from_state_dict(sd) -> dict:
    """The inverse: a state_dict (or a dict of named parameters) -> the
    flax ``{"params": ..., "batch_stats": ...}`` tree of numpy arrays
    (``batch_stats`` only when ``sd`` holds running statistics)."""
    with_stats = any(k.endswith("running_mean") for k in sd)
    n_subm = sum(k.startswith("cnn.subm.") and k.endswith(".bn.weight") for k in sd)
    flat = {}
    for name, coll, path, conv2d in _leaves(n_subm, True if with_stats else None):
        x = sd[name].detach().cpu().numpy()
        flat["/".join((coll,) + path)] = (np.transpose(x, (2, 3, 1, 0))
                                          if conv2d else x)
    return unflatten(flat)


def opt_state_from_optax(mu, nu, count, model) -> dict:
    """optax ``ScaleByAdamState(count, mu, nu)`` (mu, nu: flax parameter
    trees of numpy arrays) -> a ``torch.optim.Adam.load_state_dict``
    ``state`` mapping for ``model.parameters()`` in order."""
    m = state_dict_from_flax({"params": mu})
    v = state_dict_from_flax({"params": nu})
    return {i: {"step": torch.tensor(float(count)), "exp_avg": m[name],
                "exp_avg_sq": v[name]}
            for i, (name, _) in enumerate(model.named_parameters())}


def optax_from_opt_state(state, model):
    """The inverse: Adam's per-parameter ``state`` (indexed in
    ``model.parameters()`` order) -> (mu tree, nu tree, count)."""
    names = [name for name, _ in model.named_parameters()]
    mu = flax_from_state_dict({n: state[i]["exp_avg"] for i, n in enumerate(names)})
    nu = flax_from_state_dict({n: state[i]["exp_avg_sq"] for i, n in enumerate(names)})
    return mu["params"], nu["params"], int(state[0]["step"])
