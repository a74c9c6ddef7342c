"""Single-frame SECOND inference with the PyTorch port (counterpart of
``vision3d_tpu/inference_cli.py``).

    python -m vision3d_tpu_torch.inference_cli \
        --config configs/second/all_classes.yaml \
        --weights vision3d_tpu_torch/weights/second_all_classes_epoch11.npz \
        --velo data/.../000032.bin [--device cpu]

Reads a KITTI velodyne ``.bin`` (float32 x, y, z, intensity), pads it to
the config's point capacity as the JAX loader does, loads weights exported
by ``tools/export_torch_weights.py``, and prints the detections in the JAX
CLI's format. Runs on ``cuda`` unless ``--device cpu``.
"""

import argparse
from pathlib import Path

import numpy as np
import torch

DEFAULT_WEIGHTS = (Path(__file__).resolve().parent / "weights"
                   / "second_all_classes_epoch11.npz")


def pad_points(points: np.ndarray, capacity: int, rng) -> tuple:
    """Pad by resampling or subsample down to ``capacity`` points
    (``vision3d_tpu/data/loader.py:55``); returns (padded, n_real)."""
    n = len(points)
    if n == 0:
        return np.zeros((capacity, points.shape[1]), points.dtype), 0
    if n >= capacity:
        return points[rng.choice(n, capacity, replace=False)], capacity
    pad_idx = rng.integers(0, n, capacity - n)
    return np.concatenate([points, points[pad_idx]]), n


def format_detection(box, score, cls) -> str:
    return (f"class={int(cls)} score={score:.3f} "
            f"xyz=({box[0]:.2f},{box[1]:.2f},{box[2]:.2f}) "
            f"wlh=({box[3]:.2f},{box[4]:.2f},{box[5]:.2f}) yaw={box[6]:.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--weights", default=str(DEFAULT_WEIGHTS),
                    help=".npz from tools/export_torch_weights.py")
    ap.add_argument("--velo", required=True, help="velodyne .bin file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from vision3d_tpu_torch import convert
    from vision3d_tpu_torch.config import Config
    from vision3d_tpu_torch.models.head import extract_detections
    from vision3d_tpu_torch.models.second import create_second

    cfg = Config.from_yaml(args.config) if args.config else Config()
    points_np = np.fromfile(args.velo, dtype=np.float32).reshape(-1, 4)
    padded, n = pad_points(points_np, cfg.capacity.max_points,
                           np.random.default_rng(0))
    device = torch.device(args.device)
    sd = convert.state_dict_from_flax(convert.load_npz(args.weights))
    model, anchors = create_second(cfg, device=device, state_dict=sd)
    points = torch.from_numpy(padded)[None].to(device)
    num = torch.tensor([n], dtype=torch.int32, device=device)
    with torch.no_grad():
        det, _ = model.inference(points, num, anchors)
    dets = extract_detections(det)[0]
    for i in np.argsort(-dets["scores"]):
        print(format_detection(dets["boxes"][i], dets["scores"][i],
                               dets["class_idx"][i]))


if __name__ == "__main__":
    main()
