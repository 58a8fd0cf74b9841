"""Core registration losses: local NCC and the diffusion regularizer, PyTorch.

Counterpart of `smilecode_tpu/losses/core.py` (`ncc_vxm`, `grad3d`), in the
same channels-last layout (B, D, H, W, C) and with the same arithmetic: the
five 9^3 box sums are separable shifted-slice adds over a zero-padded volume
(the reference's conv3d with padding 4), added in the JAX package's order,
then the reference's win_size mean-reconstruction algebra and its 1e-5
denominator epsilon. The JAX package has no Pallas kernel for either loss,
so these stay plain PyTorch.
"""

from __future__ import annotations

import torch

from smilecode_tpu_torch.ops.box import box_sum as _box_sum


def ncc_vxm(y_true: torch.Tensor, y_pred: torch.Tensor, win: int = 9) -> torch.Tensor:
    """Local (windowed) normalized cross-correlation loss; returns -mean(cc)."""
    ii, ji = y_true, y_pred
    i2, j2, ij = ii * ii, ji * ji, ii * ji
    i_sum = _box_sum(ii, win)
    j_sum = _box_sum(ji, win)
    i2_sum = _box_sum(i2, win)
    j2_sum = _box_sum(j2, win)
    ij_sum = _box_sum(ij, win)
    win_size = float(win ** 3)
    u_i = i_sum / win_size
    u_j = j_sum / win_size
    cross = ij_sum - u_j * i_sum - u_i * j_sum + u_i * u_j * win_size
    i_var = i2_sum - 2 * u_i * i_sum + u_i * u_i * win_size
    j_var = j2_sum - 2 * u_j * j_sum + u_j * u_j * win_size
    cc = cross * cross / (i_var * j_var + 1e-5)
    return -torch.mean(cc)


def abs_(x: torch.Tensor) -> torch.Tensor:
    """|x| with `jnp.abs`'s derivative: +1 at 0, where `torch.abs` gives 0.
    A flow is constant at a zero-initialised head, in the background and in
    a warp's out-of-volume zeros, so equal neighbours are common."""
    return torch.where(x >= 0, x, -x)


def grad3d(flow: torch.Tensor, penalty: str = "l1", loss_mult: float | None = None) -> torch.Tensor:
    """Diffusion regularizer: mean |forward difference| (or squared) per axis
    of a (B, D, H, W, C) field."""
    dd = abs_(flow[:, 1:] - flow[:, :-1])
    dh = abs_(flow[:, :, 1:] - flow[:, :, :-1])
    dw = abs_(flow[:, :, :, 1:] - flow[:, :, :, :-1])
    if penalty == "l2":
        dd, dh, dw = dd * dd, dh * dh, dw * dw
    elif penalty != "l1":
        raise ValueError(f"penalty must be l1 or l2, got {penalty!r}")
    g = (torch.mean(dd) + torch.mean(dh) + torch.mean(dw)) / 3.0
    if loss_mult is not None:
        g = g * loss_mult
    return g
