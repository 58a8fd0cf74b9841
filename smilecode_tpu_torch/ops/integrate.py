"""Vector field integration by scaling and squaring, PyTorch.

Counterpart of `smilecode_tpu/ops/integrate.py:vecint`: ``vec *= 1/2**nsteps``
then ``nsteps`` times ``vec = vec + warp(vec, vec)``; so ``nsteps`` bilinear
warps, each a K2 launch for CUDA tensors under ``impl`` "auto", "pallas" or
"guarded".
"""

from __future__ import annotations

import torch

from smilecode_tpu_torch.ops.warp import warp


def vecint(vec: torch.Tensor, nsteps: int = 7, impl: str = "auto") -> torch.Tensor:
    """Integrate a stationary velocity field (B, D, H, W, 3) into a flow."""
    if nsteps < 0:
        raise ValueError(f"nsteps should be >= 0, found: {nsteps}")
    vec = vec * (1.0 / (2 ** nsteps))
    for _ in range(nsteps):
        vec = vec + warp(vec, vec, impl=impl)
    return vec
