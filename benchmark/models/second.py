"""SECOND (Yan et al., Sensors 2018) on the benchmark: the model file that a
configuration names with ``"bench": {"model": "second"}``.

What the harness needs of this architecture, and nothing of any other:
its parameter shapes, the batch-norm calibration, how the port's model is
built, driven and hooked, the reference's control, judge and work counts,
and the training step on both sides. The mathematics is the plain
reference's (``harness/reference.py``), the generic comparisons
``harness/compare.py``'s.

Weights follow the port's ``init_second`` (a frozen copy): sparse convs
normal(0, sqrt(2/Cout)); RPN convs Xavier-normal cut at two standard
deviations and widened so the standard deviation stays sqrt(2/fan_avg);
head kernels normal(0.01) with the classification bias at the focal prior
p = 0.01; batch norms scale 1, bias 0.
"""

import math

import numpy as np
import torch

from harness import compare, reference as ref, weights
from harness.compare import (choice_gap, decoded_at, mismatches, nms_mismatch, program_choice,
                             rel_gap)

PRIOR = 0.01
# the leaf whose gradient the ``dw_scale`` fault doubles: a stage-2 sparse
# conv, whose dW the program regathers with kernel B4
DW_FAULT_LEAF = "cnn.subm.4.weight"


def param_shapes(cfg: dict) -> dict:
    """{name: (shape, (kind, parameter))} in the program's state-dict
    order: the middle extractor, the RPN and the head."""
    out = {}
    cin, li = cfg["c_in"], 0
    for si, (chans, (cout, kernel, _, _)) in enumerate(ref.BLOCKS):
        for ch in chans:
            out[f"cnn.subm.{li}.weight"] = ((27 * cin, ch), ("normal", math.sqrt(2.0 / ch)))
            weights.bn(f"cnn.subm.{li}.bn", ch, out)
            cin, li = ch, li + 1
        cin = cout
    for si, (chans, (cout, kernel, _, _)) in enumerate(ref.BLOCKS):
        cin = chans[-1]
        kv = kernel[0] * kernel[1] * kernel[2]
        out[f"cnn.down.{si}.weight"] = ((kv * cin, cout), ("normal", math.sqrt(2.0 / cout)))
        weights.bn(f"cnn.down.{si}.bn", cout, out)
    c = cfg["proposal"]["c_in"]
    for j in range(ref.RPN_LAYERS):
        k = 3 if j < ref.RPN_LAYERS - 1 else 1
        s = math.sqrt(2.0 / (2 * c * k * k)) / weights.TRUNC_STD
        out[f"rpn.{j}.0.weight"] = ((c, c, k, k), ("trunc", s))
        weights.bn(f"rpn.{j}.1", c, out, tracked=True)
    n = cfg["num_classes"] * len(cfg["anchors"][0]["yaw"])
    out["head.conv_cls.weight"] = ((n, c, 1, 1), ("normal", 0.01))
    out["head.conv_cls.bias"] = ((n,), ("const", -math.log((1 - PRIOR) / PRIOR)))
    out["head.conv_reg.weight"] = ((n * 7, c, 1, 1), ("normal", 0.01))
    out["head.conv_reg.bias"] = ((n * 7,), ("const", 0.0))
    return out


@torch.no_grad()
def calibrate(cfg: dict, sd: dict, batch: dict, anchors, u=None) -> dict:
    """Every batch norm's running mean and (biased) variance set to the
    statistics of ``batch``, layer by layer as a forward with batch
    statistics meets them, so that activations stay at unit scale.
    Returns ``sd``."""
    with weights.no_tf32():
        ref.second_maps(ref.Ctx("calib"), sd, cfg, batch["points"], batch["num_points"])
    return sd


def draws(seed, index, batch, cfg):
    """SECOND draws nothing at random in a forward."""
    return None


def build(pcfg, sd, dev):
    from vision3d_tpu_torch.models.second import Second

    with torch.device(dev):
        model = Second(pcfg)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def capture(model, cur):
    """Hooks that put the head's maps into ``cur``; returns the handles."""
    return [model.head.register_forward_hook(lambda _m, _a, o: cur.update(cls=o[0], reg=o[1]))]


def infer(model, batch, anchors, u):
    det, _ = model.inference(batch["points"], batch["num_points"], anchors)
    return det


def control(cfg, sd, batch, anchors, u):
    """The reference in float8 in the program's place: the same outputs
    the program's timed path gives."""
    with weights.no_tf32(), torch.no_grad():
        ctx = ref.Ctx("eval", quant=True)
        _, cls, reg, _ = ref.second_maps(ctx, sd, cfg, batch["points"], batch["num_points"])
        scores, idx = compare.program_choice(cls, cfg["proposal"]["topk"])
        boxes = compare.decoded_at(reg, anchors, idx)
        out = dict(cls=cls, reg=reg)
        keep = ref.nms_keep(boxes, scores, cfg["proposal"]["nms_iou_threshold"],
                            cfg["iou_angle_mode"])
        valid = keep & (scores > cfg["anchors"][0]["score_thresh"])
        out["det"] = (boxes, scores, torch.zeros_like(idx, dtype=torch.int32), valid)
    return out


@torch.no_grad()
def judge(cfg, prog, batch, sd, anchors, u):
    """Numbers of one SECOND batch. ``prog``: cls, reg (the head's maps)
    and det (boxes, scores, class_idx, valid)."""
    with weights.no_tf32():
        _, cls_r, reg_r, _ = ref.second_maps(ref.Ctx("eval"), sd, cfg, batch["points"],
                                            batch["num_points"])
    k = cfg["proposal"]["topk"]
    s_p, idx = program_choice(prog["cls"], k)
    boxes, scores, _, valid = prog["det"]
    return dict(cls_gap=rel_gap(prog["cls"], cls_r), reg_gap=rel_gap(prog["reg"], reg_r),
                choice_gap=choice_gap(cls_r, idx, k),
                decode_mismatch=(mismatches(boxes, decoded_at(prog["reg"], anchors, idx))
                                 + mismatches(scores, s_p)),
                nms_mismatch=nms_mismatch(boxes, scores, valid, cfg),
                boxes_over_thresh=int((scores > cfg["anchors"][0]["score_thresh"]).sum()))


@torch.no_grad()
def counts(cfg, sd, batch, anchors, u):
    """The reference's work of one forward (``reference.Ctx.counts``)."""
    with weights.no_tf32():
        ctx = ref.Ctx("eval")
        ref.second_maps(ctx, sd, cfg, batch["points"], batch["num_points"])
    return ctx.counts


# ----------------------------------------------------------------- training

def train_program(pcfg, sd, dev, steps_per_epoch, anchors):
    """The port's training state and step: (model, optimizer, state,
    ``step_fn(state, batch) -> (state, losses)``)."""
    from vision3d_tpu_torch.training.train import create_train_state, make_train_step

    model, tx, state = create_train_state(pcfg, steps_per_epoch=steps_per_epoch, device=dev,
                                          state_dict=sd)
    return model, tx, state, make_train_step(model, tx, pcfg, anchors=anchors)


def capture_train(model, maps):
    """A hook that copies a training forward's head maps into ``maps``."""
    return model.head.register_forward_hook(
        lambda _m, _a, o: maps.update(cls=o[0].detach().clone(), reg=o[1].detach().clone()))


def trainable(cfg):
    return [k for k in param_shapes(cfg)
            if not k.endswith((".running_mean", ".running_var", ".num_batches_tracked"))]


def reference_steps(cfg, sd, batches, anchors, quant=False, over_ranks=False):
    """The reference's first steps from the same weights: (loss of each
    step, the first gradient's norm per leaf as Adam gets it, after the
    clip, the change of each leaf after the steps, the first step's head
    maps, its counts). ``over_ranks``: ``batches`` are this rank's shares of
    global batches, and the ranks together take the global batches' steps
    (batch-norm statistics, the loss normaliser, the gradients and the
    loss summed over the ranks); the maps are this rank's rows."""
    names = trainable(cfg)
    params = {k: sd[k].clone().requires_grad_(True) for k in names}
    bufs = {k: v for k, v in sd.items() if k not in params}
    opt = torch.optim.Adam(list(params.values()), lr=ref.lr_at(cfg, 0), betas=(0.9, 0.999),
                           eps=1e-8)
    losses, first, maps, step_counts = [], None, None, None
    with weights.no_tf32():
        for i, batch in enumerate(batches):
            opt.zero_grad(set_to_none=True)
            with torch.no_grad():
                targets = ref.assign_targets(batch["boxes"], batch["gt_mask"], anchors, cfg)
            ctx = ref.Ctx("train", quant, over_ranks)
            _, cls, reg, _ = ref.second_maps(ctx, {**bufs, **params}, cfg, batch["points"],
                                             batch["num_points"])
            loss = ref.proposal_loss(cls, reg, targets, cfg["train"]["lam"],
                                     total=ctx.total)["loss"]
            loss.backward()
            grads = [p.grad for p in params.values() if p.grad is not None]
            if ctx.world > 1:
                ref.sum_over_ranks_(grads)
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            if norm >= cfg["train"]["grad_clip_norm"]:
                torch._foreach_mul_(grads, cfg["train"]["grad_clip_norm"] / norm)
            if i == 0:
                first = {k: float(p.grad.norm()) if p.grad is not None else 0.0
                         for k, p in params.items()}
                step_counts = ctx.counts
                maps = dict(cls=cls.detach(), reg=reg.detach())
            for group in opt.param_groups:
                group["lr"] = ref.lr_at(cfg, i)
            opt.step()
            losses.append(float(ctx.total(loss.detach())))
            del cls, reg, loss
    change = {k: float((params[k].detach() - sd[k]).norm()) for k in names}
    return losses, first, change, maps, step_counts


def train_numbers(cfg, got, want):
    losses_p, first_p, change_p, maps_p = got
    losses_r, first_r, change_r, maps_r, _ = want
    n = min(len(maps_p["cls"]), len(maps_r["cls"]))    # a half batch compares its half
    med = float(np.median([first_r[k] for k in first_r]))
    counted = [k for k in first_r if first_r[k] >= 1e-3 * med]
    shapes = param_shapes(cfg)
    grad = compare.leaf_gaps(first_p, first_r, counted)
    step = compare.leaf_gaps(change_p, change_r, counted)
    return dict(loss_gap=max(abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r)),
                grad_gap=max(grad.values()),
                grad_gap_weights=max(v for k, v in grad.items() if len(shapes[k][0]) >= 2),
                step_gap=max(step.values()),
                loss_gap_first=abs(losses_p[0] - losses_r[0]) / abs(losses_r[0]),
                cls_gap_first=compare.rel_gap(maps_p["cls"][:n], maps_r["cls"][:n]),
                reg_gap_first=compare.rel_gap(maps_p["reg"][:n], maps_r["reg"][:n]),
                grad_gap_median=float(np.median(list(grad.values()))),
                step_gap_median=float(np.median(list(step.values()))),
                leaves_counted=len(counted))
