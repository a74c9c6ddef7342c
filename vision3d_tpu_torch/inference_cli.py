"""Single-frame SECOND inference and BEV image with the PyTorch port
(counterpart of ``vision3d_tpu/inference_cli.py``).

    python -m vision3d_tpu_torch.inference_cli \\
        --config configs/second/all_classes.yaml \\
        [--ckpt ./ckpts/epoch_11 | --weights weights.npz] \\
        --velo data/.../000032.bin [--out dets.png] [--device cpu]

Reads a KITTI velodyne ``.bin`` (float32 x, y, z, intensity), pads it to
the config's point capacity as the loader does, loads a checkpoint this
package trained (``--ckpt``) or weights exported by
``tools/export_torch_weights.py`` (``--weights``, by default the trained
3-class weights), prints the detections in the JAX CLI's format and, with
``--out``, writes a PNG of the points and boxes from above (no image
library needed). Runs on ``cuda`` unless ``--device cpu``.
"""

import argparse
from pathlib import Path

import numpy as np
import torch

DEFAULT_WEIGHTS = (Path(__file__).resolve().parent / "weights"
                   / "second_all_classes_epoch11.npz")


def load_state_dict(args) -> dict:
    """The model weights the command line names: ``args.ckpt`` (a
    checkpoint of ``train_cli``) if given, else ``args.weights`` (an
    ``.npz`` export of a JAX checkpoint)."""
    if args.ckpt:
        from vision3d_tpu_torch.training.checkpoint import model_state_dict

        return model_state_dict(args.ckpt)
    from vision3d_tpu_torch import convert

    return convert.state_dict_from_flax(convert.load_npz(args.weights))


def format_detection(box, score, cls) -> str:
    return (f"class={int(cls)} score={score:.3f} "
            f"xyz=({box[0]:.2f},{box[1]:.2f},{box[2]:.2f}) "
            f"wlh=({box[3]:.2f},{box[4]:.2f},{box[5]:.2f}) yaw={box[6]:.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--ckpt", default=None, help="checkpoint from train_cli")
    ap.add_argument("--weights", default=str(DEFAULT_WEIGHTS),
                    help=".npz from tools/export_torch_weights.py")
    ap.add_argument("--velo", required=True, help="velodyne .bin file")
    ap.add_argument("--out", default=None, help="output BEV image path (PNG)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from vision3d_tpu_torch.config import Config
    from vision3d_tpu_torch.data.kitti import read_velo
    from vision3d_tpu_torch.data.loader import pad_points
    from vision3d_tpu_torch.models.head import extract_detections
    from vision3d_tpu_torch.models.second import create_second

    cfg = Config.from_yaml(args.config) if args.config else Config()
    points_np = read_velo(args.velo)
    padded, n = pad_points(points_np, cfg.capacity.max_points,
                           np.random.default_rng(0))
    device = torch.device(args.device)
    model, anchors = create_second(cfg, device=device,
                                   state_dict=load_state_dict(args))
    points = torch.from_numpy(padded)[None].to(device)
    num = torch.tensor([n], dtype=torch.int32, device=device)
    with torch.no_grad():
        det, _ = model.inference(points, num, anchors)
    dets = extract_detections(det)[0]
    for i in np.argsort(-dets["scores"]):
        print(format_detection(dets["boxes"][i], dets["scores"][i],
                               dets["class_idx"][i]))

    if args.out:
        from vision3d_tpu_torch.utils.bev_drawer import Drawer, write_png

        write_png(args.out, Drawer(points_np, [dets["boxes"]]).image)
        print(f"wrote {args.out}")
    return dets


if __name__ == "__main__":
    main()
