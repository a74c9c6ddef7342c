"""Dataset layer: KITTI parsing, augmentation and fixed-capacity batching,
in numpy (a copy of ``vision3d_tpu/data``)."""

from vision3d_tpu_torch.data.kitti import KittiDataset, KittiDatasetTrain
from vision3d_tpu_torch.data.loader import DataLoader, collate, pad_points

__all__ = ["DataLoader", "KittiDataset", "KittiDatasetTrain", "collate", "pad_points"]
