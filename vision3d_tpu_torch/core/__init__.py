"""Geometry, voxelization, box codec, rotated IoU and NMS (port of
``vision3d_tpu/core``)."""
