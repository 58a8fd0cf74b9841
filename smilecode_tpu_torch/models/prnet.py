"""PRNet / PRNet++ — dual-stream pyramid with progressive refinement, PyTorch.

Counterpart of `smilecode_tpu/models/prnet.py`. A shared `BackBone` (a
5-level ReLU conv encoder, c=8, and a nearest-upsample U-Net decoder) runs
on x and y separately and yields 5-scale features, coarse to fine:
[4c@1/8, 4c@1/4, 2c@1/2, 2c@full, c@full]. A PRBlock warps the x features
by the upsampled, doubled incoming flow and predicts a residual flow from
the concat with an N(0, 1e-5) conv; a PR++ block adds `correlation3d` and
two conv stacks with a residual connection.

PRNet composes its 5 flows at the end. PR++ composes as it goes,
``flow = T(flow, w) + w``: T warps the COARSER flow by the finer field, so
the warp's source is smaller than its flow and the coordinates are rescaled
by (S-1)/(F-1) < 1, with no 2x magnitude rescale (a reference quirk the JAX
package keeps, `smilecode_tpu/models/prnet.py:12-15`).

Kernels: every bilinear warp reaches K2 through `ops.warp`,
the counterpart of kernel F's entry (K5 under autograd): 4 feature warps, 4
compositions and the moved image, 9 per pair; in PR++ three compositions
have a source coarser than the flow. PR++'s five correlations go through
`kernels.correlation3d.correlation3d` (K7 on the card, its adjoint under
autograd; the plain version for CPU tensors and for attn_impl "plain").

Module names follow the reference `state_dict` keys (``net.encoder.block1
.main.weight``, ``net.decoder1.Conv.main.weight``, ``prblock2.flow.weight``,
``prblock3.conv1.0.weight``). Layout: NDHWC.
"""

from __future__ import annotations

import torch
from torch import nn

from smilecode_tpu_torch.kernels.correlation3d import correlation3d
from smilecode_tpu_torch.ops.blocks import (
    conv3d_ndhwc,
    mark_model_,
    normal_,
    reset_torch_default_,
)
from smilecode_tpu_torch.ops.resize import upsample2_nearest, upsample2_trilinear
from smilecode_tpu_torch.ops.warp import warp


class ReluConvBlock(nn.Module):
    """Conv3d + ReLU."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.main = nn.Conv3d(in_channels, out_channels, 3, stride, 1)

    def forward(self, x):
        return torch.relu(conv3d_ndhwc(self.main, x))


class PREncoder(nn.Module):
    """5 levels: full (c), then 4 stride-2 levels (2c, 2c, 4c, 4c)."""

    def __init__(self, in_channels: int = 1, first_channel: int = 8):
        super().__init__()
        c = first_channel
        self.block1 = ReluConvBlock(in_channels, c)
        self.block2 = ReluConvBlock(c, 2 * c, 2)
        self.block3 = ReluConvBlock(2 * c, 2 * c, 2)
        self.block4 = ReluConvBlock(2 * c, 4 * c, 2)
        self.block5 = ReluConvBlock(4 * c, 4 * c, 2)

    def forward(self, x):
        outs = [self.block1(x)]
        for block in (self.block2, self.block3, self.block4, self.block5):
            outs.append(block(outs[-1]))
        return tuple(outs)


class DecoderBlock(nn.Module):
    """Nearest 2x upsample, skip concat, ReluConvBlock (``Conv``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.Conv = ReluConvBlock(in_channels, out_channels)

    def forward(self, x, skip):
        return self.Conv(torch.cat([upsample2_nearest(x), skip], -1))


class BackBone(nn.Module):
    """Encoder and decoder shared by both volumes; ``forward(x, y)`` returns
    each one's features, coarse to fine."""

    def __init__(self, first_channel: int = 8):
        super().__init__()
        c = first_channel
        self.encoder = PREncoder(1, c)
        self.decoder1 = DecoderBlock(8 * c, 4 * c)
        self.decoder2 = DecoderBlock(6 * c, 4 * c)
        self.decoder3 = DecoderBlock(6 * c, 2 * c)
        self.decoder4 = DecoderBlock(3 * c, 2 * c)
        self.decoder5 = ReluConvBlock(2 * c, c)

    def _run(self, v):
        out1, out2, out3, out4, out5 = self.encoder(v)  # full .. 1/16
        o1 = self.decoder1(out5, out4)
        o2 = self.decoder2(o1, out3)
        o3 = self.decoder3(o2, out2)
        o4 = self.decoder4(o3, out1)
        return [o1, o2, o3, o4, self.decoder5(o4)]

    def forward(self, x, y):
        return self._run(x), self._run(y)


class _FlowBlock(nn.Module):
    """What PRBlock and PRPlusPlusBlock share: the incoming flow (doubled
    and upsampled unless ``scale`` is False) warps x; ``flow`` is the
    N(0, 1e-5), zero-bias flow head."""

    def __init__(self, in_flow: bool, scale: bool):
        super().__init__()
        self.in_flow, self.scale = in_flow, scale

    def _warp_x(self, x, flow):
        if not self.in_flow:
            return x
        if self.scale:
            flow = upsample2_trilinear(flow * 2)
        return warp(x, flow, kernels=self.kernels)

    def reset_flow_head(self, generator):
        normal_(self.flow.weight, 1e-5, generator)
        nn.init.zeros_(self.flow.bias)


class PRBlock(_FlowBlock):
    """Residual flow from concat(warped x, y)."""

    def __init__(self, channels: int, in_flow: bool = True, scale: bool = True):
        super().__init__(in_flow, scale)
        self.flow = nn.Conv3d(2 * channels, 3, 3, 1, 1)

    def forward(self, x, y, flow=None):
        return conv3d_ndhwc(self.flow, torch.cat([self._warp_x(x, flow), y], -1))


class PRPlusPlusBlock(_FlowBlock):
    """Residual flow from concat(warped x, correlation, y) through two conv
    stacks (``conv1``, ``conv2``) with a residual connection."""

    def __init__(self, channels: int, in_flow: bool = True, scale: bool = True):
        super().__init__(in_flow, scale)
        c, c_in = channels, 2 * channels + 27
        self.conv1 = nn.Sequential(nn.Conv3d(c_in, c_in, 3, 1, 1), nn.Conv3d(c_in, c, 3, 1, 1))
        self.conv2 = nn.Sequential(nn.Conv3d(c, c, 3, 1, 1), nn.Conv3d(c, c, 3, 1, 1))
        self.flow = nn.Conv3d(c, 3, 3, 1, 1)

    def forward(self, x, y, flow=None):
        x = self._warp_x(x, flow)
        corr = correlation3d(x, y, self.kernels)
        h = torch.relu(conv3d_ndhwc(self.conv1, torch.cat([x, corr, y], -1)))
        res = torch.relu(conv3d_ndhwc(self.conv2, h))
        return conv3d_ndhwc(self.flow, h + res)


class _PRBase(nn.Module):
    """The BackBone ``net`` and the five blocks ``prblock1..5``; forward
    (moving, fixed) -> (y_moved, flow), volumes (B, D, H, W, 1) with every
    axis a multiple of 16. attn_impl: "auto" sends every bilinear warp
    through the Hopper kernel wrapper (K2 for CUDA tensors, the plain
    version for CPU tensors); "plain" forces the plain version. Weights are
    drawn on the CPU from ``generator`` (`ops/blocks.py`)."""

    block_type: type

    def __init__(self, first_channel: int = 8, attn_impl: str = "auto", device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = first_channel
        # blocks 1..5 on the features [4c, 4c, 2c, 2c, c]; block 1 takes no
        # flow, block 5 no upsampling
        specs = ((4 * c, False, False), (4 * c, True, True), (2 * c, True, True),
                 (2 * c, True, True), (c, True, False))
        with torch.device("meta"):
            self.net = BackBone(c)
            for i, (ch, in_flow, scale) in enumerate(specs, 1):
                setattr(self, f"prblock{i}", self.block_type(ch, in_flow, scale))
        self.to_empty(device=device or "cpu")
        reset_torch_default_(self, generator)
        for i in range(1, 6):
            getattr(self, f"prblock{i}").reset_flow_head(generator)
        mark_model_(self, attn_impl)

    def _warp(self, src, flow):
        return warp(src, flow, kernels=self.kernels)


class PRNet(_PRBase):
    """Five residual flows, composed at the end."""

    block_type = PRBlock

    def forward(self, x, y):
        ox, oy = self.net(x, y)
        f1 = self.prblock1(ox[0], oy[0])
        f2 = self.prblock2(ox[1], oy[1], f1)
        f3 = self.prblock3(ox[2], oy[2], f2)
        f4 = self.prblock4(ox[3], oy[3], f3)
        f5 = self.prblock5(ox[4], oy[4], f4)

        flow = self._warp(upsample2_trilinear(f1 * 2), f2)
        flow = self._warp(upsample2_trilinear(flow * 2), f3)
        flow = self._warp(upsample2_trilinear(flow * 2), f4)
        flow = self._warp(flow, f5)
        return self._warp(x, flow), flow


class PRNetPlusPlus(_PRBase):
    """Flows composed as they come, ``flow = T(flow, w) + w``, T warping the
    coarser flow by the finer field (blocks 2-4)."""

    block_type = PRPlusPlusBlock

    def forward(self, x, y):
        ox, oy = self.net(x, y)
        flow = self.prblock1(ox[0], oy[0])
        for i in range(1, 5):
            w = getattr(self, f"prblock{i + 1}")(ox[i], oy[i], flow)
            flow = self._warp(flow, w) + w
        return self._warp(x, flow), flow
