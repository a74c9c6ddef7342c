"""KITTI 3D detection AP (R40), host numpy: a copy of
``vision3d_tpu/eval/kitti_eval.py``, so the same detection and
ground-truth lists give the JAX package's AP table exactly.

``evaluate`` / ``evaluate_all`` follow the official protocol (the kitti
devkit's eval.cpp): a first matching pass collects true-positive scores
without a threshold (each valid gt takes the highest-SCORE unmatched
detection above the class IoU threshold), ``get_thresholds`` subsamples
those scores at ~1/40 recall steps, and per-threshold matching passes
(each gt takes the highest-IoU unmatched detection with score >= the
threshold) give a 41-point precision curve, right-max smoothed and
averaged over points 1..40 (so one perfect detection of one gt scores 0.0
under R40). ``evaluate_pooled`` is the exact pooled precision-recall
integral at 40 recall points (descending-score global ranking).

3D IoU = exact rotated BEV polygon intersection x z-overlap / union, in
radians whatever the training-time angle mode. A gt with level above the
difficulty is ignored: a match to it counts neither as TP nor as FP, and
it is not in the recall denominator. Not modelled, as in the JAX package:
2D-box height filtering of detections, don't-care regions and AOS.
"""

from collections import defaultdict

import numpy as np

from vision3d_tpu_torch.core.iou_host import rotated_box_intersection

CLASS_IOU_THRESH = {0: 0.7, 1: 0.5, 2: 0.5}
N_RECALL_POINTS = 40


def box3d_iou_matrix(boxes1, boxes2):
    """(M, 7) x (N, 7) -> (M, N) 3D IoU with exact rotated BEV footprints."""
    if len(boxes1) == 0 or len(boxes2) == 0:
        return np.zeros((len(boxes1), len(boxes2)), np.float32)
    bev_cols = [0, 1, 3, 4, 6]
    b1 = boxes1[:, None, :]
    b2 = boxes2[None, :, :]
    bev_inter = rotated_box_intersection(
        b1[..., bev_cols], b2[..., bev_cols], angle_mode="radians"
    )
    z1lo = b1[..., 2] - b1[..., 5] / 2
    z1hi = b1[..., 2] + b1[..., 5] / 2
    z2lo = b2[..., 2] - b2[..., 5] / 2
    z2hi = b2[..., 2] + b2[..., 5] / 2
    zo = np.maximum(np.minimum(z1hi, z2hi) - np.maximum(z1lo, z2lo), 0.0)
    inter = bev_inter * zo
    v1 = b1[..., 3] * b1[..., 4] * b1[..., 5]
    v2 = b2[..., 3] * b2[..., 4] * b2[..., 5]
    union = v1 + v2 - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def _match_frame(det_boxes, det_scores, gt_boxes, gt_ignored, iou_thresh):
    """Returns (tp_flags, fp_flags) per detection + n_valid_gt."""
    order = np.argsort(-det_scores, kind="stable")
    n_gt = len(gt_boxes)
    gt_taken = np.zeros(n_gt, bool)
    tp = np.zeros(len(det_boxes), bool)
    fp = np.zeros(len(det_boxes), bool)
    iou = box3d_iou_matrix(det_boxes, gt_boxes) if n_gt else None
    for i in order:
        if n_gt:
            cand = np.where(~gt_taken, iou[i], -1.0)
            j = int(np.argmax(cand))
            if cand[j] >= iou_thresh:
                gt_taken[j] = True
                if not gt_ignored[j]:
                    tp[i] = True
                # match to an ignored gt: neither TP nor FP
                continue
        fp[i] = True
    return tp, fp


def average_precision_r40(scores, tp, fp, n_gt):
    """AP at 40 recall positions from pooled detections."""
    if n_gt == 0 or len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp_c = np.cumsum(tp[order])
    fp_c = np.cumsum(fp[order])
    recall = tp_c / n_gt
    precision = tp_c / np.maximum(tp_c + fp_c, 1)
    ap = 0.0
    for r in np.linspace(1 / N_RECALL_POINTS, 1.0, N_RECALL_POINTS):
        mask = recall >= r
        ap += precision[mask].max() if mask.any() else 0.0
    return 100.0 * ap / N_RECALL_POINTS


def _select_frames(detections, ground_truths, class_idx, difficulty):
    """Per-frame (det_boxes, det_scores, gt_boxes, gt_ignored) for a class."""
    frames = []
    for det, gt in zip(detections, ground_truths):
        dsel = det["class_idx"] == class_idx
        gsel = gt["class_idx"] == class_idx
        glevels = gt.get("levels", np.full(len(gsel), 1))[gsel]
        gignored = (glevels > difficulty) | (glevels < 0)
        frames.append(
            (det["boxes"][dsel], det["scores"][dsel], gt["boxes"][gsel],
             gignored)
        )
    return frames


N_SAMPLE_PTS = 41


def get_thresholds(tp_scores, n_gt):
    """Official threshold subsampling (devkit eval.cpp getThresholds):
    pick TP scores so consecutive thresholds advance recall by ~1/40."""
    scores = np.sort(np.asarray(tp_scores))[::-1]
    thresholds = []
    current_recall = 0.0
    for i, s in enumerate(scores):
        l_recall = (i + 1) / n_gt
        r_recall = (i + 2) / n_gt if i < len(scores) - 1 else l_recall
        if (r_recall - current_recall) < (current_recall - l_recall) and (
            i < len(scores) - 1
        ):
            continue
        thresholds.append(float(s))
        current_recall += 1.0 / (N_SAMPLE_PTS - 1)
    return thresholds


def _match_official(det_scores, iou, gt_ignored, iou_thresh, score_thresh,
                    compute_fp):
    """One official matching pass over one frame.

    Pass 1 (compute_fp=False, score_thresh=-inf): each gt takes the
    highest-SCORE unassigned detection above the IoU threshold; returns
    TP scores. Pass 2 (compute_fp=True): only detections with score >=
    score_thresh participate; each gt takes the highest-IoU unassigned
    detection; returns (tp, fp).
    """
    n_det = len(det_scores)
    assigned = np.zeros(n_det, bool)
    eligible = det_scores >= score_thresh
    tp_scores, tp, fn = [], 0, 0
    for i in range(len(gt_ignored)):
        det_idx = -1
        best = -np.inf  # best score (pass 1) or best IoU (pass 2)
        for j in range(n_det):
            if assigned[j] or not eligible[j]:
                continue
            if iou[j, i] < iou_thresh:
                continue
            metric = iou[j, i] if compute_fp else det_scores[j]
            if metric > best:
                best = metric
                det_idx = j
        if det_idx < 0:
            if not gt_ignored[i]:
                fn += 1
            continue
        assigned[det_idx] = True
        if not gt_ignored[i]:
            tp += 1
            tp_scores.append(float(det_scores[det_idx]))
    if not compute_fp:
        return tp_scores
    fp = int((eligible & ~assigned).sum())
    return tp, fp


def evaluate(detections, ground_truths, class_idx=0, difficulty=2):
    """Official-protocol 3D AP@R40 for one class at one difficulty.

    Args:
      detections: list per frame of dict(boxes (D,7), scores (D,),
        class_idx (D,)).
      ground_truths: list per frame of dict(boxes (G,7), class_idx (G,),
        levels (G,) — KITTI difficulty level 1/2/3/4).
      difficulty: 1 easy, 2 moderate, 3 hard (gt above it is ignored).
    """
    iou_thresh = CLASS_IOU_THRESH.get(class_idx, 0.5)
    frames = _select_frames(detections, ground_truths, class_idx, difficulty)
    ious = [
        box3d_iou_matrix(db, gb) for db, _, gb, _ in frames
    ]  # (D, G) per frame, reused across thresholds

    n_gt = sum(int((~gi).sum()) for _, _, _, gi in frames)
    if n_gt == 0:
        return 0.0
    tp_scores = []
    for (db, ds, gb, gi), iou in zip(frames, ious):
        tp_scores += _match_official(ds, iou, gi, iou_thresh, -np.inf, False)
    thresholds = get_thresholds(tp_scores, n_gt)

    precision = np.zeros(N_SAMPLE_PTS)
    for t_idx, t in enumerate(thresholds):
        tp_tot = fp_tot = 0
        for (db, ds, gb, gi), iou in zip(frames, ious):
            tp, fp = _match_official(ds, iou, gi, iou_thresh, t, True)
            tp_tot += tp
            fp_tot += fp
        precision[t_idx] = tp_tot / max(tp_tot + fp_tot, 1)
    # right-max smoothing, then R40 average over points 1..40
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    return 100.0 * float(precision[1:].sum()) / (N_SAMPLE_PTS - 1)


def evaluate_pooled(detections, ground_truths, class_idx=0, difficulty=2):
    """Exact pooled PR-integral 3D AP@R40 (see module docstring)."""
    thresh = CLASS_IOU_THRESH.get(class_idx, 0.5)
    all_scores, all_tp, all_fp = [], [], []
    n_gt_total = 0
    for det, gt in zip(detections, ground_truths):
        dsel = det["class_idx"] == class_idx
        dboxes = det["boxes"][dsel]
        dscores = det["scores"][dsel]
        gsel = gt["class_idx"] == class_idx
        gboxes = gt["boxes"][gsel]
        glevels = gt.get("levels", np.full(len(gsel), 1))[gsel]
        gignored = (glevels > difficulty) | (glevels < 0)
        n_gt_total += int((~gignored).sum())
        tp, fp = _match_frame(dboxes, dscores, gboxes, gignored, thresh)
        all_scores.append(dscores)
        all_tp.append(tp)
        all_fp.append(fp)
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    tp = np.concatenate(all_tp) if all_tp else np.zeros(0, bool)
    fp = np.concatenate(all_fp) if all_fp else np.zeros(0, bool)
    return average_precision_r40(scores, tp, fp, n_gt_total)


def evaluate_all(detections, ground_truths, num_classes=3):
    """AP table {class -> {difficulty -> AP}}."""
    out = defaultdict(dict)
    for c in range(num_classes):
        for d, name in [(1, "easy"), (2, "moderate"), (3, "hard")]:
            out[c][name] = evaluate(detections, ground_truths, c, d)
    return dict(out)
