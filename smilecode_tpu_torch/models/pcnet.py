"""PCNet — dual-encoder pyramid with DFI / NFF fusion blocks, PyTorch.

Counterpart of `smilecode_tpu/models/pcnet.py`: two SEPARATE encoders
(float/fixed, c=16, 4 levels, plain stride-2 conv + residual blocks); a
bottleneck on their concat; per scale a velocity head (``reg_conv*``), a DFI
block that upsamples every cached prediction to the current scale (plain
trilinear resize, no magnitude rescale: the reference's quirk, kept),
weights each by a per-field sigmoid map, sums and integrates them
(`vecint`, 7 steps); the warped float features fuse with the fixed and
decoder features in an NFF block (3-way softmax weighting and channel
attention). Final: integrate ``pred0`` and compose
``flow = T(wf0, pred0) + pred0``.

``UpConvBlockP1`` is not the shared ``UpConvBlock``: ConvTranspose3d(k4, s2,
padding 1), then IN and LeakyReLU(0.1), with no ``[1:-1]`` crop.

Kernels: every bilinear warp reaches K2 through `ops.warp`,
the counterpart of kernel F's entry (K5 under autograd): 3 DFI `vecint`s of
7 steps, ``vecint(pred0)`` (7), the 3 feature warps, ``T(wf0, pred0)`` and
the moved image, 33 per pair.

Module names follow the reference `state_dict` keys (``encoder_float.conv0
.main.weight``, ``encoder_float.conv1.1.block.2.weight``,
``upconv2.upconv.weight``, ``dfi_1.weight_conv.0.0.weight``,
``nff_2.weight_conv.0.weight``, ``nff_2.channel_attention.fc.0.weight``);
the JAX package flattens some of them (`convert.RENAMES_BY_MODEL["pcnet"]`).
Layout: NDHWC.
"""

from __future__ import annotations

import torch
from torch import nn

from smilecode_tpu_torch.ops.blocks import (
    ConvInsBlock,
    conv3d_ndhwc,
    instance_norm,
    leaky_relu,
    mark_model_,
    reset_torch_default_,
)
from smilecode_tpu_torch.ops.integrate import vecint
from smilecode_tpu_torch.ops.resize import interp_trilinear
from smilecode_tpu_torch.ops.warp import warp

VECINT_STEPS = 7


class ResBlock(nn.Module):
    """IN -> LReLU -> conv, residual add, IN -> LReLU. ``block`` holds the
    reference's (InstanceNorm3d, LeakyReLU, Conv3d); the norm and activation
    run as the NDHWC functions of `ops/blocks.py`."""

    def __init__(self, channels: int):
        super().__init__()
        self.block = nn.Sequential(nn.InstanceNorm3d(channels), nn.LeakyReLU(0.1),
                                   nn.Conv3d(channels, channels, 3, 1, 1))

    def forward(self, x):
        out = conv3d_ndhwc(self.block[2], leaky_relu(instance_norm(x), 0.1)) + x
        return leaky_relu(instance_norm(out), 0.1)


class PCEncoder(nn.Module):
    """ConvInsBlock stem + 3x (plain stride-2 conv + ResBlock)."""

    def __init__(self, in_channels: int = 1, first_out_channel: int = 16):
        super().__init__()
        c = first_out_channel
        self.conv0 = ConvInsBlock(in_channels, c)
        for i, (cin, cout) in enumerate(((c, 2 * c), (2 * c, 4 * c), (4 * c, 8 * c)), 1):
            setattr(self, f"conv{i}", nn.Sequential(nn.Conv3d(cin, cout, 3, 2, 1), ResBlock(cout)))

    def forward(self, x):
        outs = [self.conv0(x)]
        for conv in (self.conv1, self.conv2, self.conv3):
            outs.append(conv[1](conv3d_ndhwc(conv[0], outs[-1])))
        return tuple(outs)


class UpConvBlockP1(nn.Module):
    """ConvTranspose3d(k4, s2, padding 1) + IN + LeakyReLU(0.1), no crop."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.upconv = nn.ConvTranspose3d(in_channels, out_channels, 4, 2, padding=1)

    def forward(self, x):
        return leaky_relu(instance_norm(conv3d_ndhwc(self.upconv, x)), 0.1)


class DFIBlock(nn.Module):
    """Deformation field integration of the ``5 - level`` cached predictions."""

    def __init__(self, level: int, channel: int = 16, steps: int = VECINT_STEPS):
        super().__init__()
        self.n, self.steps = 5 - level, steps
        c = channel * self.n
        self.conv = nn.Sequential(ConvInsBlock(3 * self.n, c), ConvInsBlock(c, c))
        self.weight_conv = nn.ModuleList(
            nn.Sequential(nn.Conv3d(c, 3, 3, 1, 1), nn.Sigmoid()) for _ in range(self.n))

    def forward(self, predictions):
        if len(predictions) != self.n:
            raise ValueError(f"DFIBlock expects {self.n} predictions, got {len(predictions)}")
        cache = []
        for i, p in enumerate(predictions):
            f = 2 ** (self.n - i)
            _, d, h, w, _ = p.shape
            cache.append(interp_trilinear(p, (d * f, h * f, w * f)))
        x = self.conv(torch.cat(cache, -1))
        field = None
        for p, wc in zip(cache, self.weight_conv):
            contrib = p * torch.sigmoid(conv3d_ndhwc(wc[0], x))
            field = contrib if field is None else field + contrib
        return vecint(field, self.steps, kernels=self.kernels)


class ChannelAttention(nn.Module):
    """SE-style attention from mean and max pooling through one shared
    bias-free MLP (``fc``: Linear, ReLU, Linear)."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channels, channels // reduction, bias=False), nn.ReLU(),
                                nn.Linear(channels // reduction, channels, bias=False))

    def forward(self, x):
        # torch.amax splits the gradient among tied maxima, as jnp.max does
        att = torch.sigmoid(self.fc(x.mean(dim=(1, 2, 3))) + self.fc(torch.amax(x, dim=(1, 2, 3))))
        return att[:, None, None, None, :]


class NFFBlock(nn.Module):
    """Neighborhood feature fusion of three maps of ``channels`` each."""

    def __init__(self, channels: int):
        super().__init__()
        c3 = 3 * channels
        self.conv = nn.Sequential(ConvInsBlock(c3, c3), ConvInsBlock(c3, c3))
        self.weight_conv = nn.Sequential(nn.Conv3d(c3, 3, 3, 1, 1), nn.Softmax(dim=1))
        self.channel_attention = ChannelAttention(c3)

    def forward(self, fm_a, fm_b, fm_c):
        y = self.conv(torch.cat([fm_a, fm_b, fm_c], -1))
        wmap = torch.softmax(conv3d_ndhwc(self.weight_conv[0], y), dim=-1)
        concat = torch.cat([fm_a * wmap[..., 0:1], fm_b * wmap[..., 1:2], fm_c * wmap[..., 2:3]], -1)
        return concat * self.channel_attention(concat)


class PCNet(nn.Module):
    """forward(moving, fixed) -> (y_moved, flow); volumes (B, D, H, W, 1),
    every axis a multiple of 8.

    attn_impl: "auto" sends every bilinear warp through the Hopper kernel
    wrapper (K2 for CUDA tensors, the plain version for CPU tensors);
    "plain" forces the plain version. Weights are drawn on the CPU from
    ``generator`` (`ops/blocks.py`).
    """

    def __init__(self, channels: int = 16, attn_impl: str = "auto", device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = channels
        with torch.device("meta"):
            self.encoder_float = PCEncoder(1, c)
            self.encoder_fixed = PCEncoder(1, c)
            self.conv_bottleNeck = nn.Sequential(ConvInsBlock(16 * c, 8 * c),
                                                 ConvInsBlock(8 * c, 8 * c))
            # scale 2 (1/4), 1 (1/2), 0 (full): the head below, the up-conv
            # from below, the DFI of the cached heads, the NFF of 3 maps
            self.reg_conv3 = nn.Conv3d(8 * c, 3, 3, 1, 1)
            self.upconv2 = UpConvBlockP1(8 * c, 4 * c)
            self.dfi_2 = DFIBlock(4)
            self.nff_2 = NFFBlock(4 * c)
            self.reg_conv2 = nn.Conv3d(12 * c, 3, 3, 1, 1)
            self.upconv1 = UpConvBlockP1(12 * c, 2 * c)
            self.dfi_1 = DFIBlock(3)
            self.nff_1 = NFFBlock(2 * c)
            self.reg_conv1 = nn.Conv3d(6 * c, 3, 3, 1, 1)
            self.upconv0 = UpConvBlockP1(6 * c, c)
            self.dfi_0 = DFIBlock(2)
            self.nff_0 = NFFBlock(c)
            self.reg_conv0 = nn.Sequential(nn.Conv3d(3 * c, c, 3, 1, 1), nn.Conv3d(c, 3, 3, 1, 1))
        self.to_empty(device=device or "cpu")
        reset_torch_default_(self, generator)
        mark_model_(self, attn_impl)

    def _warp(self, src, flow):
        return warp(src, flow, kernels=self.kernels)

    def forward(self, moving, fixed):
        f0m, f1m, f2m, f3m = self.encoder_float(moving)
        f0f, f1f, f2f, f3f = self.encoder_fixed(fixed)
        concat = self.conv_bottleNeck(torch.cat([f3f, f3m], -1))

        cache = []
        for reg, upconv, dfi, nff, ff, fm in (
                (self.reg_conv3, self.upconv2, self.dfi_2, self.nff_2, f2f, f2m),
                (self.reg_conv2, self.upconv1, self.dfi_1, self.nff_1, f1f, f1m),
                (self.reg_conv1, self.upconv0, self.dfi_0, self.nff_0, f0f, f0m)):
            cache.append(conv3d_ndhwc(reg, concat))
            deconv = upconv(concat)
            wf = dfi(cache)
            concat = nff(ff, self._warp(fm, wf), deconv)

        pred0 = vecint(conv3d_ndhwc(self.reg_conv0, concat), VECINT_STEPS, kernels=self.kernels)
        flow = self._warp(wf, pred0) + pred0
        return self._warp(moving, flow), flow
