"""Sparse-tensor plans and the z-window conv (port of ``vision3d_tpu/ops``)."""
