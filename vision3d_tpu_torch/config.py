"""Frozen, hashable configuration for the PyTorch port of vision3d-tpu.

A copy of ``vision3d_tpu/config.py`` (the port imports nothing of the JAX
package), field for field, so both packages parse the same YAML files and
a ``Config`` means the same model in either. One field is the port's
own, for Voxel R-CNN, which the JAX package lacks: ``voxel_rcnn``; at its
default every JAX configuration builds the same model here. Mirrors every field of the reference's yacs config (reference:
vision3d/core/config.py:1-110) and parses the same YAML override files
(e.g. configs/second/car.yaml) verbatim, but is an immutable dataclass so
it can be closed over by jit-compiled functions without retracing hazards.

TPU-specific additions (fixed capacities required for static shapes) live
in the ``Capacity`` sub-config; they are semantically equivalent to the
reference's own hard caps (MAX_VOXELS, MAX_OCCUPANCY, TOPK).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import yaml


def _freeze(x):
    """Recursively convert lists to tuples so the config is hashable."""
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Per-class anchor spec (reference: core/config.py:22-47)."""

    names: tuple = ("Car", "Van")
    wlh: tuple = (1.6, 3.9, 1.56)
    yaw: tuple = (0.0, math.pi / 2)
    iou_thresh: tuple = (0.45, 0.60)
    score_thresh: float = 0.3
    center_z: float = -1.0
    radius: float = 1.0  # refinement match radius; absent upstream (see SURVEY P7)

    def __post_init__(self):
        for f in ("names", "wlh", "yaw", "iou_thresh"):
            object.__setattr__(self, f, _freeze(getattr(self, f)))


@dataclasses.dataclass(frozen=True)
class PSAConfig:
    """Point-set-abstraction spec (reference: core/config.py:50-69)."""

    radii: tuple = ((0.4, 0.8), (0.4, 0.8), (0.8, 1.2), (1.2, 2.4), (2.4, 4.8))
    mlps: tuple = (
        ((1, 8, 16), (1, 8, 16)),
        ((4, 8, 16), (4, 8, 16)),
        ((32, 32, 32), (32, 32, 32)),
        ((64, 64, 64), (64, 64, 64)),
        ((64, 64, 64), (64, 64, 64)),
    )

    def __post_init__(self):
        object.__setattr__(self, "radii", _freeze(self.radii))
        object.__setattr__(self, "mlps", _freeze(self.mlps))


@dataclasses.dataclass(frozen=True)
class GridPoolConfig:
    """RoI grid pooling spec (reference: core/config.py:71-76)."""

    num_gridpoints: int = 16
    radii_pn: tuple = (0.8, 1.6)
    mlps_pn: tuple = ((512, 192, 96), (512, 192, 96))
    mlps_reduction: tuple = (16 * 192, 256, 256)

    def __post_init__(self):
        object.__setattr__(self, "radii_pn", _freeze(self.radii_pn))
        object.__setattr__(self, "mlps_pn", _freeze(self.mlps_pn))
        object.__setattr__(self, "mlps_reduction", _freeze(self.mlps_reduction))


@dataclasses.dataclass(frozen=True)
class ProposalConfig:
    """Proposal head spec (reference: core/config.py:78-81)."""

    c_in: int = 128
    topk: int = 100
    nms_iou_threshold: float = 0.01  # reference hardcodes in detector/proposal.py:54


@dataclasses.dataclass(frozen=True)
class RefinementConfig:
    """Refinement head spec (reference: core/config.py:83-85)."""

    mlps: tuple = (256, 128)

    def __post_init__(self):
        object.__setattr__(self, "mlps", _freeze(self.mlps))


@dataclasses.dataclass(frozen=True)
class VoxelRCNNConfig:
    """Voxel R-CNN's RoI head (Deng et al., AAAI 2021; OpenPCDet
    ``kitti_models/voxel_rcnn_car.yaml`` ROI_HEAD), the port's own: the JAX
    package has no such model. ``scales`` index the middle extractor's
    scales (1, 2, 3: strides 2, 4, 8, ``x_conv2``-``x_conv4``), each pooled
    by a voxel query over ``query_range`` voxels (x, y, z) either way and
    ``pool_radius`` metres, ``nsample`` voxels a grid point; ``mlps`` are the
    pre-MLP (and position) width and the out-MLP width of every scale."""

    grid_size: int = 6
    scales: tuple = (1, 2, 3)
    query_range: tuple = (4, 4, 4)
    pool_radius: tuple = (0.4, 0.8, 1.6)
    nsample: int = 16
    mlps: tuple = (32, 32)
    shared_fc: tuple = (256, 256)
    cls_fc: tuple = (256, 256)
    reg_fc: tuple = (256, 256)

    def __post_init__(self):
        for f in ("scales", "query_range", "pool_radius", "mlps", "shared_fc", "cls_fc",
                  "reg_fc"):
            object.__setattr__(self, f, _freeze(getattr(self, f)))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset paths (reference: core/config.py:87-91)."""

    cachedir: str = "../data/cache/"
    splitdir: str = "../data/splitfiles/"
    rootdir: str = "../data/kitti/training/"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference: core/config.py:93-99).

    Note the reference ignores TRAIN.LR and hardcodes Adam lr=0.01 and
    OneCycle max_lr=0.01 (reference: vision3d/train.py:90, :78); we default
    ``lr``/``max_lr`` to the values actually used.
    """

    lr: float = 1e-3
    max_lr: float = 0.01
    lam: float = 1.0  # LAMBDA: reg-loss weight
    epochs: int = 80
    batch_size: int = 6
    refinement_num_negatives: int = 128
    grad_clip_norm: float = 35.0  # reference: train.py:66
    ckpt_interval_epochs: int = 3  # reference: train.py:71
    ckpt_dir: str = "./ckpts"


@dataclasses.dataclass(frozen=True)
class AugConfig:
    """Augmentation parameters (reference: core/config.py:101-108)."""

    global_scale: tuple = (0.95, 1.05)
    global_rotation: tuple = (-math.pi / 4, math.pi / 4)
    flip_horizontal: bool = True
    database_sample: bool = True
    num_sample_objects: tuple = (15, 10, 10)
    min_num_sample_pts: int = 8

    def __post_init__(self):
        object.__setattr__(self, "global_scale", _freeze(self.global_scale))
        object.__setattr__(self, "global_rotation", _freeze(self.global_rotation))
        object.__setattr__(self, "num_sample_objects", _freeze(self.num_sample_objects))


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """TPU static-shape capacities (no reference counterpart; these realize the
    reference's implicit dynamic shapes as fixed-capacity masked tensors)."""

    max_points: int = 32768      # padded points per sample (host pads/subsamples)
    max_gt_boxes: int = 64       # padded ground-truth boxes per sample
    max_detections: int = 100    # post-NMS detections kept per sample
    # Active-voxel capacity per sparse CNN stage, as multiples of MAX_VOXELS.
    # Strided sparse convs can dilate the active set; stage capacities below
    # are generous defaults validated against KITTI-like densities.
    # Active-site capacity per sparse CNN stage as a fraction of
    # max_voxels. spconv's strided convs DILATE the active set (the
    # reference keeps every site dynamically): measured on KITTI-like
    # planar clouds the chain runs ~(17k, 49k, 52k, 30k, 25k) from 18k
    # input voxels, so later stages need capacities well ABOVE 1.0 —
    # undersized caps silently truncate the highest-key (largest-y)
    # sites and blank out whole regions of the BEV map.
    stage_capacity: tuple = (1.0, 3.0, 3.2, 1.9, 1.5)
    # Active-BEV-COLUMN capacity per stage (column backend), also as
    # multiples of max_voxels. Measured on KITTI-like clouds: (13.9k,
    # 25.3k, 23.2k, 12.5k, 12.5k) columns from 18k voxels — far fewer
    # than sites because z stays dense inside a column.
    stage_column_capacity: tuple = (0.9, 1.5, 1.45, 0.85, 0.85)

    def __post_init__(self):
        object.__setattr__(self, "stage_capacity", _freeze(self.stage_capacity))
        object.__setattr__(
            self, "stage_column_capacity",
            _freeze(self.stage_column_capacity),
        )


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level config; field names follow the reference's yacs keys
    (lower-cased) so YAML overrides map 1:1 (reference: core/config.py)."""

    c_in: int = 4
    num_keypoints: int = 2048
    strides: tuple = (1, 2, 4, 8)
    samples_pn: tuple = (16, 32)

    max_voxels: int = 20000
    max_occupancy: int = 5
    voxel_size: tuple = (0.05, 0.05, 0.1)
    grid_bounds: tuple = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)

    cnn: str = "SpMiddleFHD"
    # Middle-extractor representation: "voxel" (per-voxel sorted-key
    # rulebooks with batched flat gathers — fastest measured on TPU for
    # KITTI's thin-z occupancy) or "column" (sparse BEV x dense z;
    # competitive when z-occupancy is high).
    sparse_backend: str = "voxel"

    # Z-window conv executor of the JAX package ("xla", "pallas", "auto").
    # Kept so the YAML files parse unchanged; the port ignores it: its
    # z-window conv runs the CUDA kernel on CUDA tensors and the plain
    # PyTorch version on CPU tensors (ops/zwin_conv.py).
    zwin_backend: str = "auto"

    # First sparse-CNN stage to run as a DENSE masked volume. The active
    # set dilates stage over stage (see stage_capacity) until late-stage
    # occupancy reaches 3-36%, where exact-masked dense conv3d on the MXU
    # is far cheaper than any gather-based sparse path. Stage indices
    # 0..3; 4 disables dense mode.
    dense_from_stage: int = 2

    # Dense cutover for the TRAINING graph. Default 4 = fully sparse:
    # XLA's conv3d BACKWARD materializes ~10 spatially-partitioned f32
    # temporaries (25-35GB at full KITTI geometry, > 16GB v5e HBM) and —
    # unlike activation memory — remat cannot shrink a single op's
    # backward working set. The sparse path's conv-as-backward custom
    # VJPs are memory-lean. Parameters are representation-independent,
    # so checkpoints trained at any setting evaluate at any other.
    train_dense_from_stage: int = 4

    anchors: tuple = (
        AnchorConfig(),
        AnchorConfig(
            names=("Pedestrian", "Person_sitting"),
            wlh=(0.6, 0.8, 1.73),
            iou_thresh=(0.20, 0.35),
            center_z=-0.6,
        ),
        AnchorConfig(
            names=("Cyclist",),
            wlh=(0.6, 1.76, 1.73),
            iou_thresh=(0.20, 0.35),
            center_z=-0.6,
        ),
    )
    num_proposal_sample: int = -1
    allow_low_quality_matches: bool = False
    num_classes: int = 3
    num_yaw: int = 2
    box_dof: int = 7

    psa: PSAConfig = PSAConfig()
    gridpool: GridPoolConfig = GridPoolConfig()
    proposal: ProposalConfig = ProposalConfig()
    refinement: RefinementConfig = RefinementConfig()
    voxel_rcnn: VoxelRCNNConfig = VoxelRCNNConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()
    aug: AugConfig = AugConfig()
    capacity: CapacityConfig = CapacityConfig()

    # IoU angle semantics. The reference's rotated-IoU kernel interprets
    # angles as degrees while all its callers pass radians (reference:
    # ops/csrc/box_iou_rotated/box_iou_rotated_utils.h:61 vs
    # core/proposal_targets.py:29-34); "degrees" reproduces that behavior,
    # "radians" is the corrected mode.
    iou_angle_mode: str = "degrees"

    compute_dtype: str = "float32"  # "bfloat16" for the perf path

    def __post_init__(self):
        object.__setattr__(self, "strides", _freeze(self.strides))
        object.__setattr__(self, "samples_pn", _freeze(self.samples_pn))
        object.__setattr__(self, "voxel_size", _freeze(self.voxel_size))
        object.__setattr__(self, "grid_bounds", _freeze(self.grid_bounds))
        object.__setattr__(self, "anchors", tuple(self.anchors))

    # ---- Derived geometry (reference: detector/sparse_cnn.py:40-45,
    # core/anchor_generator.py:41-45) ----

    @property
    def grid_shape_zyx(self) -> tuple:
        """Full-resolution voxel grid shape in ZYX order; the +1 on z
        replicates the reference's ``+ [0, 0, 1]`` (sparse_cnn.py:43)."""
        vs = self.voxel_size
        lo, hi = self.grid_bounds[:3], self.grid_bounds[3:]
        nx = int(round((hi[0] - lo[0]) / vs[0]))
        ny = int(round((hi[1] - lo[1]) / vs[1]))
        nz = int(round((hi[2] - lo[2]) / vs[2])) + 1
        return (nz, ny, nx)

    @property
    def bev_shape(self) -> tuple:
        """(ny, nx) of the final BEV feature map at the last stride."""
        s = self.strides[-1]
        vs = self.voxel_size
        lo, hi = self.grid_bounds[:3], self.grid_bounds[3:]
        # round, don't truncate: 38.4/0.8 is 47.999... in float64 and a
        # truncating int() desyncs the anchor grid from the CNN's BEV map
        nx = int(round((hi[0] - lo[0]) / (vs[0] * s)))
        ny = int(round((hi[1] - lo[1]) / (vs[1] * s)))
        return (ny, nx)

    @property
    def anchors_per_class(self) -> int:
        ny, nx = self.bev_shape
        return self.num_yaw * ny * nx

    def stage_voxel_capacity(self, stage: int) -> int:
        """Fixed active-voxel capacity for sparse CNN stage ``stage``."""
        cap = int(self.max_voxels * self.capacity.stage_capacity[stage])
        return max(cap, 128)

    def stage_column_capacity(self, stage: int) -> int:
        """Fixed active-BEV-column capacity for sparse CNN stage ``stage``
        (column backend; clamped so slots fit int16 lookup tables)."""
        cap = int(self.max_voxels * self.capacity.stage_column_capacity[stage])
        return min(max(cap, 128), 32000)

    # ---- YAML compatibility ----

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        with open(path) as f:
            overrides = yaml.safe_load(f) or {}
        return cls().merge(overrides)

    def merge(self, overrides: Mapping[str, Any]) -> "Config":
        """Merge a dict using the reference's UPPERCASE yacs keys."""
        return _merge_dataclass(self, overrides)


_KEY_ALIASES = {
    # yacs key -> dataclass field where they differ
    "LAMBDA": "lam",
    "RADII": "radii",
    "MLPS": "mlps",
    "NUM_GRIDPOINTS": "num_gridpoints",
    "RADII_PN": "radii_pn",
    "MLPS_PN": "mlps_pn",
    "MLPS_REDUCTION": "mlps_reduction",
}


def _merge_dataclass(obj, overrides: Mapping[str, Any]):
    updates = {}
    fields = {f.name: f for f in dataclasses.fields(obj)}
    for key, val in overrides.items():
        name = _KEY_ALIASES.get(key, key.lower())
        if name not in fields:
            raise KeyError(f"Unknown config key: {key} (-> {name})")
        cur = getattr(obj, name)
        if dataclasses.is_dataclass(cur) and isinstance(val, Mapping):
            updates[name] = _merge_dataclass(cur, val)
        elif name == "anchors":
            updates[name] = tuple(
                AnchorConfig(**{k.lower(): _freeze(v) for k, v in a.items()})
                for a in val
            )
        else:
            updates[name] = _freeze(val)
    return dataclasses.replace(obj, **updates)
