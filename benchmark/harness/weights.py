"""Weights from the seed, on the device, and their batch-norm calibration.

``param_shapes`` lists every tensor of the model's state dict, by the
program's names, from the configuration file alone; the program loads the
result with ``load_state_dict(strict=True)``, so a name or shape that
differs fails there. ``draw`` fills them from a generator on the device in
two calls, with the distributions of the port's ``init_second`` /
``init_pvrcnn`` (a frozen copy): sparse convs normal(0, sqrt(2/Cout)); RPN
convs Xavier-normal cut at two standard deviations and widened so the
standard deviation stays sqrt(2/fan_avg); head kernels normal(0.01) with
the classification bias at the focal prior p = 0.01; the point branch's
shared MLPs normal(0, sqrt(2/out)); the grid-pool reduction and
refinement MLPs and the refinement output normal(0.01), biases 0; the
keypoint segmentation LeCun-normal cut at two standard deviations; batch
norms scale 1, bias 0. ``calibrate`` then gives every batch norm the
statistics of one calibration batch, computed by the plain reference
(``reference.Ctx("calib")``), so that activations stay at unit scale and
PV-RCNN's proposals decode inside the scene.
"""

import math

import torch

from harness import reference as ref

TRUNC_STD = 0.87962566103423978     # std of a unit normal cut at +-2
PRIOR = 0.01


def _bn(prefix, c, out, tracked=False):
    out[prefix + ".weight"] = ((c,), ("const", 1.0))
    out[prefix + ".bias"] = ((c,), ("const", 0.0))
    out[prefix + ".running_mean"] = ((c,), ("const", 0.0))
    out[prefix + ".running_var"] = ((c,), ("const", 1.0))
    if tracked:
        out[prefix + ".num_batches_tracked"] = ((), ("count", 0))


def _shared_mlp(prefix, cin, widths, out):
    for layer, w in enumerate(widths):
        out[f"{prefix}.linears.{layer}.weight"] = ((w, cin), ("normal", math.sqrt(2.0 / w)))
        _bn(f"{prefix}.bns.{layer}", w, out)
        cin = w


def param_shapes(cfg: dict) -> dict:
    """{name: (shape, (kind, parameter))} in the program's state-dict
    order."""
    out = {}
    cin, li = cfg["c_in"], 0
    for si, (chans, (cout, kernel, _, _)) in enumerate(ref.BLOCKS):
        for ch in chans:
            out[f"cnn.subm.{li}.weight"] = ((27 * cin, ch), ("normal", math.sqrt(2.0 / ch)))
            _bn(f"cnn.subm.{li}.bn", ch, out)
            cin, li = ch, li + 1
        cin = cout
    for si, (chans, (cout, kernel, _, _)) in enumerate(ref.BLOCKS):
        cin = chans[-1]
        kv = kernel[0] * kernel[1] * kernel[2]
        out[f"cnn.down.{si}.weight"] = ((kv * cin, cout), ("normal", math.sqrt(2.0 / cout)))
        _bn(f"cnn.down.{si}.bn", cout, out)
    c = cfg["proposal"]["c_in"]
    for j in range(ref.RPN_LAYERS):
        k = 3 if j < ref.RPN_LAYERS - 1 else 1
        s = math.sqrt(2.0 / (2 * c * k * k)) / TRUNC_STD
        out[f"rpn.{j}.0.weight"] = ((c, c, k, k), ("trunc", s))
        _bn(f"rpn.{j}.1", c, out, tracked=True)
    n = cfg["num_classes"] * len(cfg["anchors"][0]["yaw"])
    out["head.conv_cls.weight"] = ((n, c, 1, 1), ("normal", 0.01))
    out["head.conv_cls.bias"] = ((n,), ("const", -math.log((1 - PRIOR) / PRIOR)))
    out["head.conv_reg.weight"] = ((n * 7, c, 1, 1), ("normal", 0.01))
    out["head.conv_reg.bias"] = ((n * 7,), ("const", 0.0))
    if cfg["bench"]["model"] == "second":
        return out
    for i, mlps in enumerate(cfg["psa"]["mlps"]):
        for j, widths in enumerate(mlps):
            _shared_mlp(f"pnets.{i}.mlps.{j}", widths[0] + 3, widths[1:], out)
    gp = cfg["gridpool"]
    for j, widths in enumerate(gp["mlps_pn"]):
        _shared_mlp(f"roi_grid_pool.sa.mlps.{j}", widths[0] + 3, widths[1:], out)
    red = gp["mlps_reduction"]
    for j in range(len(red) - 1):
        out[f"roi_grid_pool.mlp.linears.{j}.weight"] = ((red[j + 1], red[j]), ("normal", 0.01))
    cin = red[-1]
    for j, w in enumerate(cfg["refinement"]["mlps"]):
        out[f"refinement.mlp.linears.{j}.weight"] = ((w, cin), ("normal", 0.01))
        out[f"refinement.mlp.linears.{j}.bias"] = ((w,), ("const", 0.0))
        cin = w
    out["refinement.out.weight"] = ((8, cin), ("normal", 0.01))
    out["refinement.out.bias"] = ((8,), ("const", 0.0))
    kin = gp["mlps_pn"][0][0]
    out["keypoint_seg.weight"] = ((cfg["num_classes"] + 1, kin),
                                  ("trunc", math.sqrt(1.0 / kin) / TRUNC_STD))
    out["keypoint_seg.bias"] = ((cfg["num_classes"] + 1,), ("const", 0.0))
    return out


def draw(cfg: dict, seed: int, device) -> dict:
    """A fresh float32 state dict on ``device`` from ``seed``: every normal
    tensor from one ``randn`` and every cut normal from one ``rand``
    (inverse CDF between the 2.275% and 97.725% quantiles)."""
    shapes = param_shapes(cfg)
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


@torch.no_grad()
def calibrate(cfg: dict, sd: dict, batch: dict, anchors, u=None) -> dict:
    """Every batch norm's running mean and (biased) variance set to the
    statistics of ``batch``, layer by layer as a forward with batch
    statistics meets them; PV-RCNN's second stage pools the reference's own
    top proposals with the grid draws ``u``. Returns ``sd``."""
    with no_tf32():
        ctx = ref.Ctx("calib")
        need = cfg["bench"]["model"] == "pvrcnn2"
        x, cls, reg, scales = ref.second_maps(ctx, sd, cfg, batch["points"],
                                              batch["num_points"], need_scales=need)
        if need:
            kp, pf, _ = ref.point_branch(ctx, sd, cfg, batch["points"], batch["num_points"],
                                         x, scales)
            boxes, logits = ref.decode_all(cls, reg, anchors)
            _, idx = ref.topk_stable(logits, cfg["proposal"]["topk"])
            proposals = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 7))
            ref.stage2(ctx, sd, cfg, proposals, kp, pf, u)
    return sd
