"""The generic numbers that decide ``correct``: the program's outputs of
the timed path against the plain reference's, on the same weights and
inputs. A model file's ``judge`` (inference) or ``train_numbers``
(training) computes its cell's numbers from these.

``*_gap``: the largest absolute difference of a map or of features over
the reference's standard deviation of that tensor. ``choice_gap``: the
program's top boxes are the anchors its own class map ranks first (a stable
descending sort of the scores, the program's rule); each is judged by how
far the reference's logit there lies below the reference's own K-th best,
as a served token is judged by how far its logit lies below the
reference's best. ``decode_mismatch`` (exact): elements of the program's
boxes and scores that differ from the reference's decode of the program's
own maps at those anchors. ``nms_mismatch`` (exact): rows whose validity
differs from the reference's NMS of the program's own boxes and scores.
"""

import numpy as np
import torch

from harness import reference as ref


def rel_gap(prog, want):
    return float((prog.float() - want).abs().max() / want.std().clamp(min=1e-30))


def rms_gap(prog, want):
    """The root-mean-square difference over the reference's standard
    deviation: steady where a few elements jump (a max over a group whose
    top two are near equal)."""
    return float((prog.float() - want).square().mean().sqrt() / want.std().clamp(min=1e-30))


def mismatches(got, want):
    return int((got.float() != want.float()).sum())


def program_choice(cls, topk):
    """The top ``topk`` anchors of a class map by sigmoid score, ties to the
    lower index: (scores (B, K), anchor indices (B, K))."""
    scores = torch.sigmoid(cls.reshape(cls.shape[0], -1).float())
    s, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[:, :topk], idx[:, :topk]


def decoded_at(reg, anchors, idx):
    """The boxes a regression map decodes to at anchors ``idx`` (B, K)."""
    deltas = torch.gather(reg.reshape(reg.shape[0], -1, 7).float(), 1,
                          idx[..., None].expand(-1, -1, 7))
    return ref.decode(deltas, anchors.reshape(-1, 7)[idx])


def choice_gap(cls_r, idx, topk):
    logits = cls_r.reshape(cls_r.shape[0], -1)
    kth = ref.topk_stable(logits, topk)[0][:, -1:]
    return float((kth - torch.gather(logits, 1, idx)).clamp(min=0).max() / cls_r.std())


def nms_mismatch(boxes, scores, valid, cfg):
    keep = ref.nms_keep(boxes.float(), scores.float(), cfg["proposal"]["nms_iou_threshold"],
                        cfg["iou_angle_mode"])
    keep &= scores > cfg["anchors"][0]["score_thresh"]
    return int((keep != valid).sum())


def leaf_gaps(prog: dict, want: dict, counted) -> dict:
    """Each counted leaf's gap of norms, over the larger of the reference's
    norm of that leaf and of the median counted leaf."""
    med = float(np.median([want[k] for k in counted]))
    return {k: abs(prog[k] - want[k]) / max(want[k], med) for k in counted}
