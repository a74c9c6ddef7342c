"""KITTI validation evaluation with the PyTorch port: run SECOND or
PV-RCNN over a split and report the official-protocol 3D AP@R40 table
(counterpart of ``vision3d_tpu/eval_cli.py``).

    python -m vision3d_tpu_torch.eval_cli --config configs/second/all_classes.yaml \\
        --ckpt ./ckpts/epoch_11 --split val [--out-json ap.json] \\
        [--model second|pvrcnn|pvrcnn2|voxel_rcnn]

``--ckpt`` loads a checkpoint this package trained (``train_cli``);
``--weights`` loads the ``.npz`` export of a JAX checkpoint
(``tools/export_torch_weights.py``); with neither, SECOND takes the trained
3-class weights in ``vision3d_tpu_torch/weights/`` and PV-RCNN fresh
weights (``init_pvrcnn`` from a CPU generator seeded 0, as the JAX CLI
evaluates a ``PRNGKey(0)`` init). ``--weights`` for PV-RCNN must hold a
PV-RCNN tree: SECOND's raises. ``--model pvrcnn`` runs the one-stage
inference (the BEV branch) of the model the weights hold (a stage-1 tree,
as ``train_cli --model pvrcnn`` writes, or a two-stage one; the fresh
init is stage 1's, as the JAX CLI's), ``pvrcnn2`` the two-stage inference,
which a stage-1 tree cannot run (it raises), with its
grid points drawn from a CPU generator re-seeded 0 for every batch (the
JAX CLI passes ``PRNGKey(0)`` to every batch), so the CPU and the card
draw the same. ``--model voxel_rcnn`` runs Voxel R-CNN's two-stage
inference (``models/voxel_rcnn.py``) on the config's geometry, anchors and
thresholds with its own architecture (``voxel_rcnn_config``), from a
``--ckpt`` tree or fresh weights (``init_voxel_rcnn`` from a CPU generator
seeded 0). Inference runs under ``torch.no_grad()`` in the config's
``compute_dtype``, on ``cuda`` unless ``--device cpu``.
"""

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from vision3d_tpu_torch.inference_cli import DEFAULT_WEIGHTS, load_state_dict


def infer_batch(model, model_kind, points, num_points, anchors):
    """Detections of one batch, by the inference ``model_kind`` names."""
    with torch.no_grad():
        if model_kind == "voxel_rcnn":
            det, _ = model.inference_two_stage(points, num_points, anchors)
        elif model_kind == "pvrcnn2":
            det, _ = model.inference_two_stage(
                points, num_points, anchors,
                generator=torch.Generator().manual_seed(0))
        else:
            det, _ = model.inference(points, num_points, anchors)
    return det


def run_eval(cfg, model, anchors, dataset, batch_size=8, verbose=True,
             model_kind="second"):
    """Detections of ``model`` (eval mode, on its device) over ``dataset``
    -> (AP table {class -> {easy/moderate/hard -> AP}}, timing dict with
    the frames evaluated and the seconds the loop took). ``model_kind``:
    "second", "pvrcnn" (a PV_RCNN's one-stage inference), "pvrcnn2"
    (its two-stage inference) or "voxel_rcnn"."""
    from vision3d_tpu_torch.data.loader import DataLoader
    from vision3d_tpu_torch.eval.kitti_eval import evaluate_all
    from vision3d_tpu_torch.models.head import extract_detections

    device = anchors.device
    loader = DataLoader(dataset, cfg, batch_size=batch_size, shuffle=False,
                        drop_last=False)
    detections, ground_truths = [], []
    t0 = time.perf_counter()
    for batch in loader:
        det = infer_batch(model, model_kind,
                          torch.from_numpy(batch["points"]).to(device),
                          torch.from_numpy(batch["num_points"]).to(device), anchors)
        for b, d in enumerate(extract_detections(det)):
            fi = int(batch["frame_idx"][b])
            if fi < 0:
                continue
            anno = dataset.annotations[fi]
            detections.append(d)
            ground_truths.append(
                dict(
                    boxes=anno["boxes"],
                    class_idx=np.asarray(anno["class_idx"]),
                    levels=np.asarray(anno.get("levels", np.ones(len(anno["boxes"])))),
                )
            )
    seconds = time.perf_counter() - t0
    table = evaluate_all(detections, ground_truths, cfg.num_classes)
    timing = dict(frames=len(detections), seconds=seconds)
    if verbose:
        for c, row in table.items():
            name = cfg.anchors[c].names[0] if c < len(cfg.anchors) else str(c)
            print(f"{name}: " + " ".join(f"{k}={v:.2f}" for k, v in row.items()))
        print(f"eval: {len(detections)} frames in {seconds:.2f} s "
              f"({len(detections) / seconds:.2f} frames/s)", flush=True)
    return table, timing


def with_data_overrides(cfg, args):
    """``cfg`` with the dataset paths given on the command line."""
    overrides = {k: v for k, v in (("rootdir", args.data_root),
                                   ("splitdir", args.split_dir),
                                   ("cachedir", args.cache_dir)) if v}
    if overrides:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, **overrides))
    return cfg


def add_data_args(ap):
    ap.add_argument("--data-root", default=None, help="KITTI training/ dir")
    ap.add_argument("--split-dir", default=None)
    ap.add_argument("--cache-dir", default=None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--ckpt", default=None, help="checkpoint from train_cli")
    ap.add_argument("--weights", default=None,
                    help=".npz from tools/export_torch_weights.py (SECOND: "
                         f"by default {DEFAULT_WEIGHTS.name})")
    ap.add_argument("--split", default="val")
    ap.add_argument("--batch-size", type=int, default=8)
    add_data_args(ap)
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--model", default="second",
                    choices=["second", "pvrcnn", "pvrcnn2", "voxel_rcnn"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from vision3d_tpu_torch.config import Config
    from vision3d_tpu_torch.data.kitti import KittiDataset

    cfg = with_data_overrides(
        Config.from_yaml(args.config) if args.config else Config(), args)
    dataset = KittiDataset(cfg, split=args.split)
    device = torch.device(args.device)
    if args.model == "second":
        from vision3d_tpu_torch.models.second import create_second

        if not args.weights:
            args.weights = str(DEFAULT_WEIGHTS)
        model, anchors = create_second(cfg, device=device,
                                       state_dict=load_state_dict(args))
    elif args.model == "voxel_rcnn":
        from vision3d_tpu_torch.models.voxel_rcnn import create_voxel_rcnn, voxel_rcnn_config

        if args.weights:
            raise ValueError("--model voxel_rcnn takes a --ckpt tree or fresh weights: "
                             "the JAX package has no Voxel R-CNN to export")
        cfg = voxel_rcnn_config(cfg)
        model, anchors = create_voxel_rcnn(cfg, device=device,
                                           state_dict=load_state_dict(args) if args.ckpt else None)
    else:
        from vision3d_tpu_torch import convert
        from vision3d_tpu_torch.models.pvrcnn import create_pvrcnn, has_stage2

        sd = None
        if args.ckpt:
            sd = load_state_dict(args)
        elif args.weights:
            sd = convert.pvrcnn_state_dict_from_flax(convert.load_npz(args.weights))
        two_stage = args.model == "pvrcnn2" or (sd is not None and has_stage2(sd))
        model, anchors = create_pvrcnn(cfg, device=device, state_dict=sd,
                                       two_stage=two_stage)
    table, timing = run_eval(cfg, model, anchors, dataset, args.batch_size,
                             model_kind=args.model)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(table, f, indent=2)
    return table, timing


if __name__ == "__main__":
    main()
