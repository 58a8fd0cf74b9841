"""Shared conv building blocks (channels-last NDHWC at the boundary).

Counterpart of `smilecode_tpu/ops/blocks.py`: ConvBlock (Conv3d +
LeakyReLU(0.1)), ConvInsBlock (+InstanceNorm3d), UpConvBlock
(ConvTranspose3d(k4, s2), a crop of one voxel per border, IN, LeakyReLU)
and DeconvBlock (UpConvBlock, skip concat, two ConvInsBlocks). Each block
owns its conv as ``main`` (``upconv`` for the transposed one) so the
`state_dict` keys are the reference's (``encoder.conv0_0.main.weight``). The JAX package's bare ``Conv3d``,
``ConvTranspose3d`` (k4 s2 p0, then cropped by the caller) and ``Dense`` are
``nn.Conv3d``, ``nn.ConvTranspose3d`` and ``nn.Linear`` here, applied to
NDHWC tensors by `conv3d_ndhwc`; ``normal_init`` is `normal_`.

Convolutions run as ``nn.Conv3d`` on ``x.permute(0, 4, 1, 2, 3)``: a
contiguous NDHWC tensor permuted that way is ``channels_last_3d`` memory, so
cuDNN takes it without a copy when the weights are channels_last_3d too
(the model converts them), and the output permuted back is contiguous NDHWC.

Parameters stay float32 (master weights). A layer run on a bf16 activation
(ModeT's `compute_dtype="bfloat16"`) casts its weight and bias to the
activation's dtype at call time, as the JAX layers do
(`smilecode_tpu/ops/blocks.py:101,107,222,238`), so autograd gives float32
parameter gradients, as `jax.grad` does through ``astype``. It also rounds
where the JAX layers round, which XLA on the CPU does after every op: the
convolution and the matmul, then the bias add (one more rounding than a
fused bias); LayerNorm as its separate ops, not `F.layer_norm`'s single
rounding; the leaky slope as a bf16 constant (JAX's weak-typed 0.1).
Float32 activations take the float32 modules unchanged. No
``torch.autocast``: its op lists run norms and softmax in float32 at cast
points of their own, which are not the JAX package's. `instance_norm` and
`leaky_relu` keep their input's dtype.

Initialisation is drawn on the CPU from an explicit ``torch.Generator``
(torch-default U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for conv and linear
layers), then copied to the parameter's device, so one seed gives the same
weights on every device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from smilecode_tpu_torch.kernels import kernel_switch
from smilecode_tpu_torch.kernels import layer_norm as k8
from smilecode_tpu_torch.kernels.conv3d_wgrad import (
    Conv3dWgradFunction,
    conv3d_wgrad,
    wgrad_route,
)


def torch_uniform_(param: torch.Tensor, fan_in: int, generator: torch.Generator | None):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) in place — torch Conv/Linear default."""
    bound = 1.0 / (fan_in ** 0.5)
    vals = torch.empty(param.shape, dtype=param.dtype).uniform_(-bound, bound, generator=generator)
    with torch.no_grad():
        param.copy_(vals)


def normal_(param: torch.Tensor, stddev: float, generator: torch.Generator | None):
    vals = torch.empty(param.shape, dtype=param.dtype).normal_(0.0, stddev, generator=generator)
    with torch.no_grad():
        param.copy_(vals)


def reset_conv_(conv: nn.Conv3d | nn.ConvTranspose3d, generator: torch.Generator | None):
    """Torch-default init. Torch takes the fan-in from the weight's second
    axis: Cin·k³ for a Conv3d (Cout, Cin, k, k, k), Cout·k³ for a
    ConvTranspose3d (Cin, Cout, k, k, k), as `smilecode_tpu/ops/blocks.py:128`."""
    fan_in = conv.weight.shape[1] * conv.kernel_size[0] * conv.kernel_size[1] * conv.kernel_size[2]
    torch_uniform_(conv.weight, fan_in, generator)
    if conv.bias is not None:
        torch_uniform_(conv.bias, fan_in, generator)


def reset_torch_default_(model: nn.Module, generator: torch.Generator | None):
    """Torch-default init of every conv, transposed conv and linear layer of
    ``model``, in module order."""
    for m in model.modules():
        if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
            reset_conv_(m, generator)
        elif isinstance(m, nn.Linear):
            torch_uniform_(m.weight, m.in_features, generator)
            if m.bias is not None:
                torch_uniform_(m.bias, m.in_features, generator)


def mark_model_(model: nn.Module, attn_impl: str):
    """Finish building ``model``: store every conv weight as
    channels_last_3d (the NDHWC activations permuted by `conv3d_ndhwc` are
    channels_last_3d, so cuDNN takes both without a copy), and set
    ``kernels``, the model's kernel switch
    (`kernels.kernel_switch(attn_impl)`), on every submodule, the model
    included. The ops and routes that reach a hand-written kernel read it
    there."""
    kernels = kernel_switch(attn_impl)
    for m in model.modules():
        if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
            m.to(memory_format=torch.channels_last_3d)
        m.kernels = kernels


def conv3d_ndhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply ``conv`` (a Conv3d, ConvTranspose3d or a Sequential of them and
    of activations) to an NDHWC tensor; returns NDHWC. A bare Conv3d runs in
    ``x``'s dtype.

    `kernels.conv3d_wgrad.wgrad_route` picks the weight gradient's path of a
    bare Conv3d and of each Conv3d child of a Sequential: a 3x3x3,
    stride-1, padding-1 float32 Conv3d of a kernel model on the card goes
    through `Conv3dWgradFunction` (the same forward; dW and db from the
    Hopper kernel K6); a "declined" one is counted in
    ``conv3d_wgrad.declined`` and, as every other, runs as below. A
    Sequential's children run in order on the channels_last_3d NCDHW view,
    each other child as the Sequential applies it."""
    xc = x.permute(0, 4, 1, 2, 3)
    if isinstance(conv, nn.Sequential):
        for child in conv:
            y = _k6_conv(child, xc)
            xc = child(xc) if y is None else y
        return xc.permute(0, 2, 3, 4, 1)
    y = _k6_conv(conv, xc)
    if y is not None:
        return y.permute(0, 2, 3, 4, 1)
    if not isinstance(conv, nn.Conv3d) or x.dtype == conv.weight.dtype:
        return conv(xc).permute(0, 2, 3, 4, 1)
    y = conv._conv_forward(xc, conv.weight.to(x.dtype), None).permute(0, 2, 3, 4, 1)
    return y if conv.bias is None else y + conv.bias.to(x.dtype)


def _k6_conv(conv: nn.Module, xc: torch.Tensor) -> torch.Tensor | None:
    """``conv`` on the NCDHW view ``xc`` through `Conv3dWgradFunction` where
    `wgrad_route` sends its weight gradient to K6; else None (a "declined"
    conv counted)."""
    voxels = xc.numel() // xc.shape[1] if xc.shape[1] else 0
    route = wgrad_route(conv, xc.dtype, xc.device.type, torch.is_grad_enabled(), voxels)
    if route == "K6":
        return Conv3dWgradFunction.apply(xc, conv.weight, conv.bias)
    if route == "declined":
        conv3d_wgrad.declined += 1
    return None


def linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``lin`` applied in ``x``'s dtype."""
    if x.dtype == lin.weight.dtype:
        return lin(x)
    return F.linear(x, lin.weight.to(x.dtype)) + lin.bias.to(x.dtype)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm`` (eps, affine) over the last axis, applied in ``x``'s dtype: in
    its parameters' dtype through `kernels.layer_norm.layer_norm` (K8 where
    `k8_route` sends it: float32 on the card in a kernel model; else
    `layer_norm_plain`), a bf16 activation as the JAX layer's separate ops."""
    if x.dtype == norm.weight.dtype:
        return k8.layer_norm(x, norm.weight, norm.bias, norm.eps, getattr(norm, "kernels", True))
    var, mean = torch.var_mean(x, dim=-1, correction=0, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + norm.eps)
    return y * norm.weight.to(x.dtype) + norm.bias.to(x.dtype)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch InstanceNorm3d (affine=False, biased var) on (B, D, H, W, C)."""
    var, mean = torch.var_mean(x, dim=(1, 2, 3), correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def leaky_relu(x: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, torch.as_tensor(alpha, dtype=x.dtype) * x)


class ConvBlock(nn.Module):
    """Conv3d + LeakyReLU(alpha) (`smilecode_tpu/ops/blocks.py:146`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, alpha: float = 0.1):
        super().__init__()
        self.main = nn.Conv3d(in_channels, out_channels, kernel_size, stride, padding)
        self.alpha = alpha

    def forward(self, x):
        return leaky_relu(conv3d_ndhwc(self.main, x), self.alpha)


class ConvInsBlock(ConvBlock):
    """Conv3d + InstanceNorm3d + LeakyReLU(alpha) (`smilecode_tpu/ops/blocks.py:161`)."""

    def forward(self, x):
        return leaky_relu(instance_norm(conv3d_ndhwc(self.main, x)), self.alpha)


class UpConvBlock(nn.Module):
    """ConvTranspose3d(k, s) then a crop of one voxel per border, IN and
    LeakyReLU(alpha): exactly 2x the input size at the defaults
    (`smilecode_tpu/ops/blocks.py:176`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 4,
                 stride: int = 2, alpha: float = 0.1):
        super().__init__()
        self.upconv = nn.ConvTranspose3d(in_channels, out_channels, kernel_size, stride)
        self.alpha = alpha

    def forward(self, x):
        x = conv3d_ndhwc(self.upconv, x)[:, 1:-1, 1:-1, 1:-1]
        return leaky_relu(instance_norm(x), self.alpha)


class DeconvBlock(nn.Module):
    """UpConvBlock to ``skip_channels``, concat the skip, then two
    ConvInsBlocks (`smilecode_tpu/ops/blocks.py:194`). The JAX names
    ``conv_0``/``conv_1`` are the Sequential ``conv.0``/``conv.1``."""

    def __init__(self, dec_channels: int, skip_channels: int):
        super().__init__()
        self.upconv = UpConvBlock(dec_channels, skip_channels)
        self.conv = nn.Sequential(ConvInsBlock(2 * skip_channels, skip_channels),
                                  ConvInsBlock(skip_channels, skip_channels))

    def forward(self, dec, skip):
        return self.conv(torch.cat([self.upconv(dec), skip], dim=-1))
