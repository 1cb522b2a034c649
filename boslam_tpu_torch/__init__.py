"""boslam_tpu_torch — the PyTorch/CUDA port of the boslam_tpu RGBD SLAM engine.

The JAX package ``boslam_tpu`` is the reference; this package computes the
same per-frame pipeline with plain PyTorch around hand-written CUDA kernels
for Hopper (``csrc/``).  It imports neither JAX nor ``boslam_tpu``.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``.
"""

from boslam_tpu_torch.config import SlamConfig

__version__ = "0.1.0"

__all__ = ["SlamConfig", "__version__"]
