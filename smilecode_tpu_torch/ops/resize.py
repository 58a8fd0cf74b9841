"""Resizing ops with torch ``align_corners=True`` semantics, channels-last.

Counterpart of `smilecode_tpu/ops/resize.py`: separable 1D linear
interpolation with constant index gathers and the same ``x0*(1-f) + x1*f``
arithmetic, so the port agrees with the JAX package to rounding.
Layout: (B, D, H, W, C).
"""

from __future__ import annotations

import numpy as np
import torch


def _interp_axis(x: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    """1D linear interpolation along ``axis`` with align_corners=True."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if out_size == 1 or in_size == 1:
        pos = np.zeros((out_size,), np.float64)
    else:
        pos = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, in_size - 1)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    frac = (pos - i0).astype(np.float32)
    shape = [1] * x.ndim
    shape[axis] = out_size
    fr = torch.as_tensor(frac, device=x.device).to(x.dtype).reshape(shape)
    x0 = torch.index_select(x, axis, torch.as_tensor(i0, device=x.device))
    x1 = torch.index_select(x, axis, torch.as_tensor(i1, device=x.device))
    return x0 * (1 - fr) + x1 * fr


def interp_trilinear(x: torch.Tensor, out_shape) -> torch.Tensor:
    """Trilinear resize (align_corners=True) of (B, D, H, W, C) to out_shape."""
    for axis, size in zip((1, 2, 3), out_shape):
        x = _interp_axis(x, size, axis)
    return x


def upsample2_trilinear(x: torch.Tensor) -> torch.Tensor:
    """2x trilinear upsampling, align_corners=True (torch Upsample parity)."""
    _, d, h, w, _ = x.shape
    return interp_trilinear(x, (2 * d, 2 * h, 2 * w))


def resize_flow(x: torch.Tensor, factor: float) -> torch.Tensor:
    """ResizeTransform parity: resize a flow field and rescale its magnitude.

    ``factor`` is the reference's ``1 / vel_resize``; the output size is
    ``int(n * factor)`` per axis. The magnitude is rescaled after a
    downsampling and before an upsampling, as in the JAX package; factor 1
    is the identity."""
    if factor == 1:
        return x
    _, d, h, w, _ = x.shape
    out_shape = (int(d * factor), int(h * factor), int(w * factor))
    if factor < 1:
        return interp_trilinear(x, out_shape) * factor
    return interp_trilinear(x * factor, out_shape)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool3d(kernel=2, stride=2) over (B, D, H, W, C), as reshape + mean."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c)
    return x.mean(dim=(2, 4, 6))


def upsample2_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsampling of (B, D, H, W, C) (torch Upsample mode='nearest'
    parity): every voxel becomes a 2x2x2 block."""
    b, d, h, w, c = x.shape
    x = x[:, :, None, :, None, :, None, :].expand(b, d, 2, h, 2, w, 2, c)
    return x.reshape(b, 2 * d, 2 * h, 2 * w, c)
