"""Zero-padded box sums, channels-last (B, D, H, W, C).

Counterpart of the box sums in `smilecode_tpu/losses/core.py` and
`smilecode_tpu/models/prnet.py`: separable shifted-slice adds over a
zero-padded volume, added in the JAX package's order. The NCC loss
(`losses/core.py`) and PR++'s plain correlation
(`kernels/correlation3d.py:correlation3d_plain`) sum with them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def box_sum_axis(x: torch.Tensor, win: int, axis: int) -> torch.Tensor:
    """Box sum of width ``win`` along ``axis`` (1..3 of NDHWC), zero padding."""
    pad = win // 2
    pads = [0, 0] * (x.ndim - 1 - axis) + [pad, pad]  # F.pad lists the last axis first
    xp = F.pad(x, pads)
    size = x.shape[axis]
    out = xp.narrow(axis, 0, size)
    for o in range(1, win):
        out = out + xp.narrow(axis, o, size)
    return out


def box_sum(x: torch.Tensor, win: int) -> torch.Tensor:
    """The ``win``^3 box sum: `box_sum_axis` along D, then H, then W."""
    for axis in (1, 2, 3):
        x = box_sum_axis(x, win, axis)
    return x
