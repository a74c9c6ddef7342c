"""ctypes bindings to the native host library (a copy of
``vision3d_tpu/utils/native.py`` over ``csrc/host/vision3d_host.cpp``).

The library is compiled with ``g++`` at first use into
``build/libvision3d_host-<hash>.so`` under this package (the hash of the
source keeps a stale library from being loaded), and bound with ``ctypes``.
Every function has a numpy version elsewhere in the package
(``core.voxelize.voxelize_np``, ``core.boxes.points_in_cuboids_mask``,
``data.kitti.filter_camera_fov``); the native path is a host speed-up for
the data loader's loops, off every device path. Nothing is built when the
module is imported.
"""

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from vision3d_tpu_torch.kernels import BUILD, PACKAGE
from vision3d_tpu_torch.training.profiler import annotate

SOURCE = PACKAGE / "csrc" / "host" / "vision3d_host.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIB = None


def so_path():
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD / f"libvision3d_host-{digest}.so"


def _build(out):
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    with annotate("build"):
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], check=True,
                       capture_output=True)
    os.replace(tmp, out)


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    out = so_path()
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    c_int = ctypes.c_int

    lib.hard_voxelize.restype = c_int
    lib.hard_voxelize.argtypes = [
        f32p, c_int, c_int, f32p, f32p, i32p, c_int, c_int, f32p, i32p, i32p,
    ]
    lib.points_in_cuboids_mask.restype = None
    lib.points_in_cuboids_mask.argtypes = [f32p, c_int, c_int, f32p, c_int, u8p]
    lib.filter_camera_fov.restype = None
    lib.filter_camera_fov.argtypes = [f32p, c_int, c_int, f32p, f32p, f32p, f32p, u8p]
    _LIB = lib
    return lib


def available() -> bool:
    """True if the library builds (or is built) and loads here."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def hard_voxelize(points: np.ndarray, cfg):
    """Native equivalent of core.voxelize.voxelize_np (same truncation):
    (features (Nv, K, C), coords (Nv, 3) ZYX, occupancy (Nv,))."""
    from vision3d_tpu_torch.core.voxelize import grid_dims_xyz

    lib = _load()
    points = np.ascontiguousarray(points, np.float32)
    n, c = points.shape
    N, K = cfg.max_voxels, cfg.max_occupancy
    features = np.zeros((N, K, c), np.float32)
    coords = np.zeros((N, 3), np.int32)
    occupancy = np.zeros((N,), np.int32)
    nv = lib.hard_voxelize(
        points, n, c,
        np.asarray(cfg.voxel_size, np.float32),
        np.asarray(cfg.grid_bounds[:3], np.float32),
        np.asarray(grid_dims_xyz(cfg), np.int32),
        N, K, features, coords, occupancy,
    )
    return features[:nv], coords[:nv], occupancy[:nv]


def points_in_cuboids_mask(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(n, m) bool: point i inside box j ((m, 7) x y z w l h yaw)."""
    lib = _load()
    points = np.ascontiguousarray(points, np.float32)
    boxes = np.ascontiguousarray(boxes, np.float32)
    n = len(points)
    m = len(boxes)
    out = np.zeros((n, m), np.uint8)
    if n and m:
        lib.points_in_cuboids_mask(points, n, points.shape[1], boxes, m, out)
    return out.astype(bool)


def filter_camera_fov(calib, points: np.ndarray) -> np.ndarray:
    """The points that project into the image of ``calib`` (a
    ``data.kitti.Calib``)."""
    lib = _load()
    points = np.ascontiguousarray(points, np.float32)
    keep = np.zeros((len(points),), np.uint8)
    lib.filter_camera_fov(
        points, len(points), points.shape[1],
        np.ascontiguousarray(calib.P2, np.float32),
        np.ascontiguousarray(calib.R0, np.float32),
        np.ascontiguousarray(calib.V2C, np.float32),
        np.asarray(calib.WH, np.float32),
        keep,
    )
    return points[keep.astype(bool)]
