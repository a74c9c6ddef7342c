"""BEV occupancy image of a point cloud with box outlines (a copy of
``vision3d_tpu/utils/bev_drawer.py`` with its numpy line drawer only).

Points are scattered into a top-down density image with robust percentile
normalization, and rotated box outlines are drawn on it; ``write_png``
stores the RGB array with ``zlib`` and ``struct`` alone, so no image
library is needed.
"""

import struct
import zlib

import numpy as np

from vision3d_tpu_torch.core.boxes import box3d_to_bev_corners


def clipped_percentile(x, p=1):
    """Robust [0, 1] normalization."""
    p0, p1 = np.percentile(x, [p, 100 - p])
    return (np.clip(x, p0, p1) - p0) / (p1 - p0 + 1e-1)


def make_bev_map(points_xy, pixel_size, bounds):
    """Point density image, rows along y and columns along x."""
    lo = bounds[:2]
    hi = bounds[2:]
    mask = ((points_xy > lo) & (points_xy < hi)).all(axis=1)
    shape = np.int32(np.ceil((hi - lo) / pixel_size))[::-1]
    pix = np.int32(np.floor((points_xy[mask] - lo) / pixel_size))
    img = np.zeros(shape, np.float32)
    np.add.at(img, (pix[:, 1], pix[:, 0]), 1.0)
    return clipped_percentile(img)


def _draw_line_np(img, p0, p1, color):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) * 2
    xs = np.linspace(p0[0], p1[0], n).astype(int)
    ys = np.linspace(p0[1], p1[1], n).astype(int)
    ok = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[ok], xs[ok]] = color


class Drawer:
    """``.image`` (H, W, 3) uint8 from points and sets of boxes."""

    def __init__(self, points, boxes_sets=(), pixel_size=(0.1, 0.1),
                 bounds=(0, -30, 60, 30)):
        self.pixel_size = np.asarray(pixel_size, np.float32)
        self.bounds = np.asarray(bounds, np.float32)
        gray = (make_bev_map(points[:, :2], self.pixel_size, self.bounds)
                * 255).astype(np.uint8)
        self.image = np.stack([gray] * 3, axis=-1)
        for boxes in boxes_sets:
            self.draw_boxes(np.asarray(boxes))

    def draw_boxes(self, boxes, color=(0, 255, 0)):
        if len(boxes) == 0:
            return
        factor = np.asarray(self.image.shape[:2][::-1]) / (
            self.bounds[2:] - self.bounds[:2]
        )
        corners = (box3d_to_bev_corners(boxes) - self.bounds[:2]) * factor
        for quad in corners:
            for i in range(4):
                _draw_line_np(self.image, quad[i], quad[(i + 1) % 4],
                              np.asarray(color, np.uint8))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes (8-bit truecolour, no filter)."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {image.shape}")
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], 1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, image: np.ndarray):
    with open(path, "wb") as f:
        f.write(encode_png(image))
