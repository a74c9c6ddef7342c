"""Weights from the seed, on the device.

A model file's ``param_shapes`` lists every tensor of the model's state
dict, by the program's names, from the configuration file alone, each with
its distribution; the program loads the result with
``load_state_dict(strict=True)``, so a name or shape that differs fails
there. ``draw`` fills them from a generator on the device in two calls.
``bn`` and ``shared_mlp`` list the tensors of a batch norm (scale 1, bias
0) and of a PointNet shared MLP (normal(0, sqrt(2/out)) weights, each
followed by a batch norm), the parts that model files share. A model file's
``calibrate`` then gives every batch norm the statistics of one
calibration batch, computed by the plain reference
(``reference.Ctx("calib")``).
"""

import math

import torch

TRUNC_STD = 0.87962566103423978     # std of a unit normal cut at +-2


def bn(prefix, c, out, tracked=False):
    out[prefix + ".weight"] = ((c,), ("const", 1.0))
    out[prefix + ".bias"] = ((c,), ("const", 0.0))
    out[prefix + ".running_mean"] = ((c,), ("const", 0.0))
    out[prefix + ".running_var"] = ((c,), ("const", 1.0))
    if tracked:
        out[prefix + ".num_batches_tracked"] = ((), ("count", 0))


def shared_mlp(prefix, cin, widths, out):
    for layer, w in enumerate(widths):
        out[f"{prefix}.linears.{layer}.weight"] = ((w, cin), ("normal", math.sqrt(2.0 / w)))
        bn(f"{prefix}.bns.{layer}", w, out)
        cin = w


def draw(shapes: dict, seed: int, device) -> dict:
    """A fresh float32 state dict on ``device`` from ``seed``, given a model
    file's ``param_shapes``, {name: (shape, (kind, parameter))}: every
    normal tensor from one ``randn`` and every cut normal from one ``rand``
    (inverse CDF between the 2.275% and 97.725% quantiles)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {k: math.prod(s) for k, (s, _) in shapes.items()}
    n_norm = sum(sizes[k] for k, (_, (kind, _)) in shapes.items() if kind == "normal")
    n_trunc = sum(sizes[k] for k, (_, (kind, _)) in shapes.items() if kind == "trunc")
    normal = torch.randn(n_norm, generator=gen, device=device)
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    uni = torch.rand(n_trunc, generator=gen, device=device, dtype=torch.float64)
    trunc = (math.sqrt(2.0) * torch.erfinv(2 * (lo + (1 - 2 * lo) * uni) - 1)).float()
    sd, i_n, i_t = {}, 0, 0
    for k, (shape, (kind, p)) in shapes.items():
        n = sizes[k]
        if kind == "normal":
            sd[k] = (normal[i_n:i_n + n] * p).reshape(shape)
            i_n += n
        elif kind == "trunc":
            sd[k] = (trunc[i_t:i_t + n] * p).reshape(shape)
            i_t += n
        elif kind == "const":
            sd[k] = torch.full(shape, p, dtype=torch.float32, device=device)
        else:
            sd[k] = torch.zeros(shape, dtype=torch.int64, device=device)
    return sd


class no_tf32:
    """TF32 off for matmuls and convolutions while the reference runs."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False
