"""JAX package parameters -> the port's state_dict.

The input is the flax ``{"params": ..., "batch_stats": ...}`` tree of a
``vision3d_tpu`` SECOND model as nested dicts of numpy arrays;
``load_npz`` rebuilds it from the ``.npz`` that
``tools/export_torch_weights.py`` writes, keyed by flax path
(``"params/cnn/SubMConv_0/kernel"``). The port
keeps the JAX layout for its sparse-conv weights, so the mapping is
renames plus the 2D conv transposes (HWIO -> OIHW).
"""

import numpy as np
import torch

N_SUBM = 10   # SpMiddleFHD: 2 + 2 + 3 + 3 submanifold convs
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


def state_dict_from_flax(variables) -> dict:
    """Map the flax tree onto ``models.second.Second``'s state_dict."""
    p, s = variables["params"], variables["batch_stats"]
    sd = {}

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def bn(prefix, pp, ss):
        sd[f"{prefix}.weight"] = t(pp["scale"])
        sd[f"{prefix}.bias"] = t(pp["bias"])
        sd[f"{prefix}.running_mean"] = t(ss["mean"])
        sd[f"{prefix}.running_var"] = t(ss["var"])

    for kind, n, name in (("subm", N_SUBM, "SubMConv"),
                          ("down", N_DOWN, "SparseConvDown")):
        for i in range(n):
            pp, ss = p["cnn"][f"{name}_{i}"], s["cnn"][f"{name}_{i}"]
            sd[f"cnn.{kind}.{i}.weight"] = t(pp["kernel"])
            bn(f"cnn.{kind}.{i}.bn", pp["MaskedBatchNorm_0"],
               ss["MaskedBatchNorm_0"])

    for i in range(N_RPN):
        pp, ss = p["rpn"][f"ConvBNReLU_{i}"], s["rpn"][f"ConvBNReLU_{i}"]
        sd[f"rpn.{i}.0.weight"] = t(np.transpose(pp["Conv_0"]["kernel"],
                                                 (3, 2, 0, 1)))
        bn(f"rpn.{i}.1", pp["BatchNorm_0"], ss["BatchNorm_0"])
        sd[f"rpn.{i}.1.num_batches_tracked"] = torch.tensor(0)

    for name, conv in (("conv_cls", "Conv_0"), ("conv_reg", "Conv_1")):
        pp = p["head"][conv]
        sd[f"head.{name}.weight"] = t(np.transpose(pp["kernel"], (3, 2, 0, 1)))
        sd[f"head.{name}.bias"] = t(pp["bias"])
    return sd
