"""smilecode_tpu_torch — PyTorch/CUDA port of `smilecode_tpu`.

The JAX package is the reference; this package mirrors its module tree
(`ops/`, `kernels/`, `models/`, `losses/`, `data/`, `utils/`, `metrics.py`,
`convert.py`, `config.py`, `optim.py`, `train.py`, `infer.py`) and imports
only torch and numpy. Each Pallas TPU kernel on the ported path is a CUDA
C++ kernel for Hopper (`csrc/`, built by `kernels/_build.py` at first use),
forward and backward, with its plain PyTorch version beside it for CPU
tensors.

Layout convention, as in the JAX package: volumes are channels-last
``(B, D, H, W, C)``; deformation fields are ``(B, D, H, W, 3)`` with the last
axis ordered ``(dd, dh, dw)`` in voxels.
"""

__version__ = "0.1.0"

from smilecode_tpu_torch.ops.resize import interp_trilinear, resize_flow, upsample2_trilinear
from smilecode_tpu_torch.ops.warp import base_grid, warp

__all__ = ["warp", "base_grid", "resize_flow", "interp_trilinear", "upsample2_trilinear"]
