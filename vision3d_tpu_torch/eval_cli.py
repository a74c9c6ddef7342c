"""KITTI validation evaluation with the PyTorch port: run SECOND over a
split and report the official-protocol 3D AP@R40 table (counterpart of
``vision3d_tpu/eval_cli.py``).

    python -m vision3d_tpu_torch.eval_cli --config configs/second/all_classes.yaml \\
        --ckpt ./ckpts/epoch_11 --split val [--out-json ap.json]

``--ckpt`` loads a checkpoint this package trained (``train_cli``);
``--weights`` loads the ``.npz`` export of a JAX checkpoint
(``tools/export_torch_weights.py``); with neither, the trained 3-class
weights in ``vision3d_tpu_torch/weights/``. Inference runs under
``torch.no_grad()`` in the config's ``compute_dtype``, on ``cuda`` unless
``--device cpu``. SECOND only: PV-RCNN is not ported yet (ROADMAP A11).
"""

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from vision3d_tpu_torch.inference_cli import DEFAULT_WEIGHTS, load_state_dict


def run_eval(cfg, model, anchors, dataset, batch_size=8, verbose=True):
    """Detections of ``model`` (eval mode, on its device) over ``dataset``
    -> (AP table {class -> {easy/moderate/hard -> AP}}, timing dict with
    the frames evaluated and the seconds the loop took)."""
    from vision3d_tpu_torch.data.loader import DataLoader
    from vision3d_tpu_torch.eval.kitti_eval import evaluate_all
    from vision3d_tpu_torch.models.head import extract_detections

    device = anchors.device
    loader = DataLoader(dataset, cfg, batch_size=batch_size, shuffle=False,
                        drop_last=False)
    detections, ground_truths = [], []
    t0 = time.perf_counter()
    for batch in loader:
        with torch.no_grad():
            det, _ = model.inference(
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
    ap.add_argument("--weights", default=str(DEFAULT_WEIGHTS),
                    help=".npz from tools/export_torch_weights.py")
    ap.add_argument("--split", default="val")
    ap.add_argument("--batch-size", type=int, default=8)
    add_data_args(ap)
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--model", default="second",
                    choices=["second", "pvrcnn", "pvrcnn2"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model != "second":
        raise NotImplementedError(
            f"--model {args.model}: PV-RCNN is not ported yet (ROADMAP A11)")

    from vision3d_tpu_torch.config import Config
    from vision3d_tpu_torch.data.kitti import KittiDataset
    from vision3d_tpu_torch.models.second import create_second

    cfg = with_data_overrides(
        Config.from_yaml(args.config) if args.config else Config(), args)
    dataset = KittiDataset(cfg, split=args.split)
    model, anchors = create_second(cfg, device=torch.device(args.device),
                                   state_dict=load_state_dict(args))
    table, timing = run_eval(cfg, model, anchors, dataset, args.batch_size)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(table, f, indent=2)
    return table, timing


if __name__ == "__main__":
    main()
