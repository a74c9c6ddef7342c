"""vision3d_tpu_torch: the PyTorch / CUDA (NVIDIA Hopper) port of vision3d-tpu.

A second package beside ``vision3d_tpu`` (the JAX reference). It keeps the
JAX package's module names so each counterpart is easy to find, imports
torch, numpy and yaml only, and nothing of ``vision3d_tpu``. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from vision3d_tpu_torch.config import Config

__all__ = ["Config"]
