"""Vector field integration by scaling and squaring, PyTorch.

Counterpart of `smilecode_tpu/ops/integrate.py:vecint`: ``vec *= 1/2**nsteps``
then ``nsteps`` times ``vec = vec + warp(vec, vec)``; so ``nsteps`` bilinear
warps, each a K2 launch for CUDA tensors while ``kernels`` (the model's
kernel switch) is on.
"""

from __future__ import annotations

import torch

from smilecode_tpu_torch.ops.warp import warp


def vecint(vec: torch.Tensor, nsteps: int = 7, kernels: bool = True) -> torch.Tensor:
    """Integrate a stationary velocity field (B, D, H, W, 3) into a flow."""
    if nsteps < 0:
        raise ValueError(f"nsteps should be >= 0, found: {nsteps}")
    vec = vec * (1.0 / (2 ** nsteps))
    for _ in range(nsteps):
        vec = vec + warp(vec, vec, kernels=kernels)
    return vec
