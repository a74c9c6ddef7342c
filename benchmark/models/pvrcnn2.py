"""PV-RCNN (Shi et al., CVPR 2020), both stages, on the benchmark: the model
file that a configuration names with ``"bench": {"model": "pvrcnn2"}``.

SECOND's trunk (``second.py``: its shapes and maps) plus the point branch
(FPS keypoints, five set abstractions, the BEV sample), RoI grid pooling
and refinement. The mathematics is the plain reference's
(``harness/reference.py``), the generic comparisons ``harness/compare.py``'s.

Weights follow the port's ``init_pvrcnn`` (a frozen copy): SECOND's, then
the point branch's shared MLPs normal(0, sqrt(2/out)); the grid-pool
reduction and refinement MLPs and the refinement output normal(0.01),
biases 0; the keypoint segmentation LeCun-normal cut at two standard
deviations; batch norms scale 1, bias 0.
"""

import math

import torch

from harness import compare, files, reference as ref, traffic, weights
from harness.compare import (choice_gap, decoded_at, mismatches, nms_mismatch, program_choice,
                             rel_gap, rms_gap)

second = files.model("second")


def param_shapes(cfg: dict) -> dict:
    """{name: (shape, (kind, parameter))} in the program's state-dict
    order: SECOND's, then the point branch, grid pool and refinement."""
    out = second.param_shapes(cfg)
    for i, mlps in enumerate(cfg["psa"]["mlps"]):
        for j, widths in enumerate(mlps):
            weights.shared_mlp(f"pnets.{i}.mlps.{j}", widths[0] + 3, widths[1:], out)
    gp = cfg["gridpool"]
    for j, widths in enumerate(gp["mlps_pn"]):
        weights.shared_mlp(f"roi_grid_pool.sa.mlps.{j}", widths[0] + 3, widths[1:], out)
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
                                  ("trunc", math.sqrt(1.0 / kin) / weights.TRUNC_STD))
    out["keypoint_seg.bias"] = ((cfg["num_classes"] + 1,), ("const", 0.0))
    return out


def _proposals(cfg, cls, reg, anchors):
    """The reference's own top proposals of its maps."""
    boxes, logits = ref.decode_all(cls, reg, anchors)
    _, idx = ref.topk_stable(logits, cfg["proposal"]["topk"])
    return torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 7))


@torch.no_grad()
def calibrate(cfg: dict, sd: dict, batch: dict, anchors, u=None) -> dict:
    """Every batch norm's running mean and (biased) variance set to the
    statistics of ``batch``, layer by layer as a forward with batch
    statistics meets them; the second stage pools the reference's own top
    proposals with the grid draws ``u``, so that they decode inside the
    scene. Returns ``sd``."""
    with weights.no_tf32():
        ctx = ref.Ctx("calib")
        x, cls, reg, scales = ref.second_maps(ctx, sd, cfg, batch["points"],
                                              batch["num_points"], need_scales=True)
        kp, pf, _ = ref.point_branch(ctx, sd, cfg, batch["points"], batch["num_points"],
                                     x, scales)
        ref.stage2(ctx, sd, cfg, _proposals(cfg, cls, reg, anchors), kp, pf, u)
    return sd


def draws(seed, index, batch, cfg):
    """The RoI grid points' uniform draws of pool batch ``index``."""
    return traffic.grid_draws(seed, index, batch, cfg["proposal"]["topk"],
                              cfg["gridpool"]["num_gridpoints"])


def build(pcfg, sd, dev):
    from vision3d_tpu_torch.models.pvrcnn import PV_RCNN

    with torch.device(dev):
        model = PV_RCNN(pcfg, two_stage=True)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def capture(model, cur):
    """Hooks that put into ``cur`` the head's maps, the point features, the
    proposals and keypoints that enter grid pooling, and the refinement's
    outputs; returns the handles."""
    return [model.head.register_forward_hook(lambda _m, _a, o: cur.update(cls=o[0], reg=o[1])),
            model.keypoint_seg.register_forward_pre_hook(
                lambda _m, a: cur.update(point_features=a[0])),
            model.roi_grid_pool.register_forward_pre_hook(
                lambda _m, a: cur.update(proposals=a[0], keypoints=a[1])),
            model.refinement.register_forward_hook(lambda _m, _a, o: cur.update(refine=o))]


def infer(model, batch, anchors, u):
    det, _ = model.inference_two_stage(batch["points"], batch["num_points"], anchors, u=u)
    return det


def control(cfg, sd, batch, anchors, u):
    """The reference in float8 in the program's place: the same outputs
    the program's timed path gives."""
    with weights.no_tf32(), torch.no_grad():
        ctx = ref.Ctx("eval", quant=True)
        x, cls, reg, scales = ref.second_maps(ctx, sd, cfg, batch["points"], batch["num_points"],
                                              need_scales=True)
        scores, idx = compare.program_choice(cls, cfg["proposal"]["topk"])
        boxes = compare.decoded_at(reg, anchors, idx)
        out = dict(cls=cls, reg=reg)
        kp, pf, _ = ref.point_branch(ctx, sd, cfg, batch["points"], batch["num_points"],
                                     x, scales)
        out.update(keypoints=kp, point_features=pf, proposals=boxes)
        boxes, conf_logit, deltas = ref.stage2(ctx, sd, cfg, boxes, kp, pf, u)
        out["refine"] = (deltas, conf_logit)
        scores = torch.sigmoid(conf_logit) * scores
        keep = ref.nms_keep(boxes, scores, cfg["proposal"]["nms_iou_threshold"],
                            cfg["iou_angle_mode"])
        valid = keep & (scores > cfg["anchors"][0]["score_thresh"])
        out["det"] = (boxes, scores, torch.zeros_like(idx, dtype=torch.int32), valid)
    return out


@torch.no_grad()
def judge(cfg, prog, batch, sd, anchors, u):
    """Numbers of one PV-RCNN two-stage batch. ``prog`` adds keypoints,
    point features, the proposals that entered RoI grid pooling and the
    refinement's outputs (box deltas, confidence logits). The reference
    pools the program's proposals on its own keypoints and features; the
    proposals themselves are judged by ``choice_gap`` and
    ``decode_mismatch``."""
    with weights.no_tf32():
        ctx = ref.Ctx("eval")
        x, cls_r, reg_r, scales = ref.second_maps(ctx, sd, cfg, batch["points"],
                                                 batch["num_points"], need_scales=True)
        kp_r, pf_r, _ = ref.point_branch(ctx, sd, cfg, batch["points"], batch["num_points"],
                                         x, scales)
        proposals = prog["proposals"].float()
        _, logit_r, deltas_r = ref.stage2(ctx, sd, cfg, proposals, kp_r, pf_r, u)
    k = cfg["proposal"]["topk"]
    s_p, idx = program_choice(prog["cls"], k)
    deltas_p, logit_p = prog["refine"]
    boxes, scores, _, valid = prog["det"]
    decode = (mismatches(proposals, decoded_at(prog["reg"], anchors, idx))
              + mismatches(boxes, ref.decode(deltas_p.float(), proposals))
              + mismatches(scores, torch.sigmoid(logit_p.float()) * s_p))
    return dict(cls_gap=rel_gap(prog["cls"], cls_r), reg_gap=rel_gap(prog["reg"], reg_r),
                keypoint_mismatch=int((prog["keypoints"] != kp_r).any(-1).sum()),
                point_feat_gap=rel_gap(prog["point_features"], pf_r),
                choice_gap=choice_gap(cls_r, idx, k),
                refine_gap=max(rel_gap(deltas_p, deltas_r), rel_gap(logit_p, logit_r)),
                refine_rms=max(rms_gap(deltas_p, deltas_r), rms_gap(logit_p, logit_r)),
                decode_mismatch=decode,
                nms_mismatch=nms_mismatch(boxes, scores, valid, cfg),
                boxes_over_thresh=int((scores > cfg["anchors"][0]["score_thresh"]).sum()))


@torch.no_grad()
def counts(cfg, sd, batch, anchors, u):
    """The reference's work of one two-stage forward, its grid pool on the
    reference's own top proposals."""
    with weights.no_tf32():
        ctx = ref.Ctx("eval")
        x, cls, reg, scales = ref.second_maps(ctx, sd, cfg, batch["points"],
                                              batch["num_points"], need_scales=True)
        kp, pf, _ = ref.point_branch(ctx, sd, cfg, batch["points"], batch["num_points"],
                                     x, scales)
        ref.stage2(ctx, sd, cfg, _proposals(cfg, cls, reg, anchors), kp, pf, u)
    return ctx.counts
