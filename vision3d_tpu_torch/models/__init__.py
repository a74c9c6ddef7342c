"""SECOND's modules (port of ``vision3d_tpu/models``)."""
