"""JAX package parameters <-> the port's state_dict, and optax's Adam
state <-> ``torch.optim.Adam``'s.

The input is the flax ``{"params": ..., "batch_stats": ...}`` tree of a
``vision3d_tpu`` SECOND or PV-RCNN model as nested dicts of numpy arrays;
``load_npz`` rebuilds it from the ``.npz`` that
``tools/export_torch_weights.py`` writes, keyed by flax path
(``"params/cnn/SubMConv_0/kernel"``). The port
keeps the JAX layout for its sparse-conv weights, so the mapping is
renames plus the 2D conv transposes (HWIO -> OIHW) and, for PV-RCNN's
Dense layers, the (in, out) -> (out, in) transposes of ``nn.Linear``.
``flax_from_state_dict`` is the inverse map. Adam's moments are trees
shaped like the parameters, so ``opt_state_from_optax`` /
``optax_from_opt_state`` carry them through the same renames; both take
SECOND's trees and PV-RCNN's of either stage.
"""

import re

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


# PV-RCNN's point branch: (flax path, state_dict name) templates whose
# {0}, {1}, {2} are module indices; "T" marks a Dense kernel to transpose.
_SA = (("pnets_{0}/SharedMLP_{1}", "pnets.{0}.mlps.{1}"),
       ("roi_grid_pool/SetAbstractionMSG_0/SharedMLP_{1}", "roi_grid_pool.sa.mlps.{1}"))
_PV_RULES = [rule for fx, sd in _SA for rule in (
    (f"params/{fx}/Dense_{{2}}/kernel", f"{sd}.linears.{{2}}.weight", "T"),
    (f"params/{fx}/MaskedBatchNorm_{{2}}/scale", f"{sd}.bns.{{2}}.weight", ""),
    (f"params/{fx}/MaskedBatchNorm_{{2}}/bias", f"{sd}.bns.{{2}}.bias", ""),
    (f"batch_stats/{fx}/MaskedBatchNorm_{{2}}/mean", f"{sd}.bns.{{2}}.running_mean", ""),
    (f"batch_stats/{fx}/MaskedBatchNorm_{{2}}/var", f"{sd}.bns.{{2}}.running_var", ""))
] + [
    ("params/roi_grid_pool/MLP_0/Dense_{2}/kernel", "roi_grid_pool.mlp.linears.{2}.weight", "T"),
    ("params/refinement/MLP_0/Dense_{2}/kernel", "refinement.mlp.linears.{2}.weight", "T"),
    ("params/refinement/MLP_0/Dense_{2}/bias", "refinement.mlp.linears.{2}.bias", ""),
    ("params/refinement/Dense_0/kernel", "refinement.out.weight", "T"),
    ("params/refinement/Dense_0/bias", "refinement.out.bias", ""),
    ("params/keypoint_seg/kernel", "keypoint_seg.weight", "T"),
    ("params/keypoint_seg/bias", "keypoint_seg.bias", ""),
]


def _template_regex(template):
    pat = re.escape(template)
    for i in range(3):
        pat = pat.replace(re.escape(f"{{{i}}}"), f"(?P<i{i}>[0-9]+)")
    return re.compile(pat + "$")


_PV_REGEX = [(_template_regex(r[0]), _template_regex(r[1])) for r in _PV_RULES]


def _translate(name, src, dst):
    """Rewrite ``name`` by the first PV-RCNN rule whose ``src`` template
    (0: flax, 1: state_dict) matches: (name, transpose) or None."""
    for rule, regex in zip(_PV_RULES, _PV_REGEX):
        m = regex[src].match(name)
        if m:
            idx = {k[1:]: v for k, v in m.groupdict().items()}
            out = rule[dst]
            for i, v in idx.items():
                out = out.replace(f"{{{i}}}", v)
            return out, rule[2] == "T"
    return None


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _pvrcnn_from_flax(trees) -> dict:
    """The point-branch entries of the state_dict from a PV-RCNN tree; every
    leaf outside cnn / rpn / head must map."""
    sd = {}
    for coll in ("params", "batch_stats"):
        if trees[coll] is None:
            continue
        for path, x in _flat(trees[coll], f"{coll}/"):
            if path.split("/")[1] in ("cnn", "rpn", "head"):
                continue
            hit = _translate(path, 0, 1)
            if hit is None:
                raise KeyError(f"no state_dict name for the flax leaf {path}")
            name, transpose = hit
            x = np.array(x, dtype=np.float32)
            sd[name] = torch.from_numpy(np.ascontiguousarray(x.T) if transpose else x)
    return sd


def is_pvrcnn(variables) -> bool:
    return "pnets_0" in variables["params"]


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def state_dict_from_flax(variables) -> dict:
    """Map the flax tree onto ``models.second.Second``'s state_dict, or of a
    PV-RCNN tree (``pnets_*``) onto ``models.pvrcnn.PV_RCNN``'s; with no
    ``batch_stats`` in ``variables``, onto its named parameters only. The
    trunk may be SpMiddleFHD's or SpMiddleFHDLite's (no ``SubMConv_*``)."""
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
    if is_pvrcnn(variables):
        sd.update(_pvrcnn_from_flax(trees))
    return sd


def pvrcnn_state_dict_from_flax(variables) -> dict:
    """``state_dict_from_flax`` of a tree that must be PV-RCNN's: a SECOND
    tree raises rather than load a trunk with no point branch."""
    if not is_pvrcnn(variables):
        raise ValueError("not a PV-RCNN weight tree (no params/pnets_0): "
                         f"top-level modules {sorted(variables['params'])}")
    return state_dict_from_flax(variables)


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
    for name, t in sd.items():
        hit = _translate(name, 1, 0)
        if hit is not None:
            x = t.detach().cpu().numpy()
            flat[hit[0]] = np.ascontiguousarray(x.T) if hit[1] else x
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
    ``model.parameters()`` order) -> (mu tree, nu tree, count). A parameter
    that has never had a gradient has no entry (``torch.optim.Adam`` skips
    it; stage-1 PV-RCNN training leaves the point branch so): its moments
    are zeros, as optax's after zero gradients, and the count is the
    step of the parameters that have one."""
    named = list(model.named_parameters())

    def moment(key):
        return {n: state[i][key] if i in state else torch.zeros_like(p)
                for i, (n, p) in enumerate(named)}

    count = max((int(s["step"]) for s in state.values()), default=0)
    return (flax_from_state_dict(moment("exp_avg"))["params"],
            flax_from_state_dict(moment("exp_avg_sq"))["params"], count)
