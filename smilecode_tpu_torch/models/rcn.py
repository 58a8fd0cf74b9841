"""VTN and RCN (recursive cascaded networks) baselines, PyTorch.

Counterpart of `smilecode_tpu/models/rcn.py`. VTN: concat(moving, fixed)
2-channel input, a 6-level stride-2 conv encoder (c=16..32c, LeakyReLU 0.1),
a FlowNet-style decoder predicting a flow at each level plus an upsampled
flow skip, and a final bias-free `Pred0` transposed-conv flow head with
N(0, 1e-5) weights. RCN stacks ``n_cascade`` VTNs: ``flow = w + T(flow, w)``,
re-warping the ORIGINAL moving image each time, and returns
``(moved, flow, *subflows)`` (``return_aux=False``: ``(moved, flow)``).

Six stride-2 convs followed by k4 s2 up-convs concatenated with the skips
need every spatial axis to be a multiple of 64 (at the LPBA size
160x192x160 level 5 would concatenate 5x6x5 with 6x6x6, in the JAX package
too); the models raise before any compute otherwise. 128x192x128 is the
largest crop of an LPBA volume they take.

Kernels: every bilinear warp reaches K2 through
`ops.warp`, the counterpart of kernel F's entry: VTN 1
per pair, RCN ``2 * n_cascade - 1`` (19 for the reference's 10).

Module names follow the reference `state_dict` keys (``encoder.conv1.main
.weight``, ``Pred6.weight``, ``Upsamp6to5.upconv.weight``,
``Deconv5.upconv.weight``, ``Pred0.upconv.weight``, ``vtn.0.…``); the JAX
package flattens ``Upsamp*``/``Pred0`` (`convert.RENAMES_BY_MODEL`).
Layout: NDHWC.
"""

from __future__ import annotations

import torch
from torch import nn

from smilecode_tpu_torch.ops.blocks import (
    ConvBlock,
    conv3d_ndhwc,
    leaky_relu,
    mark_model_,
    normal_,
    reset_torch_default_,
)
from smilecode_tpu_torch.ops.warp import warp

MULTIPLE = 64  # 2**6: every spatial axis of a VTN input


def check_vtn_shape(moving, fixed) -> None:
    """Raise, naming the shapes, unless both volumes are (B, D, H, W, 1)
    with D, H, W multiples of 64."""
    shape = tuple(moving.shape)
    if tuple(fixed.shape) != shape or len(shape) != 5 or shape[-1] != 1:
        raise ValueError(f"VTN expects two equal (B, D, H, W, 1) volumes, got "
                         f"{shape} and {tuple(fixed.shape)}")
    if any(s % MULTIPLE for s in shape[1:4]):
        raise ValueError(f"VTN needs every spatial axis to be a multiple of {MULTIPLE} (six "
                         f"stride-2 levels whose up-convs must meet their skips), got "
                         f"{shape[1:4]}; 128x192x128 is the largest crop of 160x192x160 "
                         "it takes")


def _crop(x):
    return x[:, 1:-1, 1:-1, 1:-1, :]


class UpConvFlow(nn.Module):
    """ConvTranspose3d(k4, s2, bias=False) + crop (``Upsamp*``, ``Pred0``)."""

    def __init__(self, in_channels: int, out_channels: int = 3):
        super().__init__()
        self.upconv = nn.ConvTranspose3d(in_channels, out_channels, 4, 2, bias=False)

    def forward(self, x):
        return _crop(conv3d_ndhwc(self.upconv, x))


class UpConvLeakyReLU(nn.Module):
    """ConvTranspose3d(k4, s2) + crop + LeakyReLU(0.1) (``Deconv*``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.upconv = nn.ConvTranspose3d(in_channels, out_channels, 4, 2)

    def forward(self, x):
        return leaky_relu(_crop(conv3d_ndhwc(self.upconv, x)), 0.1)


class VTNEncoder(nn.Module):
    """6 stride-2 levels, channels c, 2c, 4c, 8c, 16c, 32c."""

    def __init__(self, in_channels: int = 2, first_out_channel: int = 16):
        super().__init__()
        c = first_out_channel
        self.conv1 = ConvBlock(in_channels, c, 3, 2, 1)
        self.conv2 = ConvBlock(c, 2 * c, 3, 2, 1)
        self.conv3_0 = ConvBlock(2 * c, 4 * c, 3, 2, 1)
        self.conv3_1 = ConvBlock(4 * c, 4 * c, 3, 1, 1)
        self.conv4_0 = ConvBlock(4 * c, 8 * c, 3, 2, 1)
        self.conv4_1 = ConvBlock(8 * c, 8 * c, 3, 1, 1)
        self.conv5_0 = ConvBlock(8 * c, 16 * c, 3, 2, 1)
        self.conv5_1 = ConvBlock(16 * c, 16 * c, 3, 1, 1)
        self.conv6_0 = ConvBlock(16 * c, 32 * c, 3, 2, 1)
        self.conv6_1 = ConvBlock(32 * c, 32 * c, 3, 1, 1)

    def forward(self, x):
        out1 = self.conv1(x)
        out2 = self.conv2(out1)
        out3 = self.conv3_1(self.conv3_0(out2))
        out4 = self.conv4_1(self.conv4_0(out3))
        out5 = self.conv5_1(self.conv5_0(out4))
        out6 = self.conv6_1(self.conv6_0(out5))
        return out1, out2, out3, out4, out5, out6


class VTN(nn.Module):
    """forward(moving, fixed) -> (warped moving, flow), or the flow alone
    with ``do_warp=False`` (RCN's cascade members). Build it under
    ``torch.device("meta")`` and call `reset_parameters`, or through
    `build_vtn`/`RCN`, which do."""

    def __init__(self, channels: int = 16, flow_multiplier: float = 1.0, do_warp: bool = True):
        super().__init__()
        c = channels
        self.flow_multiplier = flow_multiplier
        self.do_warp = do_warp
        self.encoder = VTNEncoder(2, c)
        self.Pred6 = nn.Conv3d(32 * c, 3, 3, 1, 1)
        self.Upsamp6to5 = UpConvFlow(3)
        self.Deconv5 = UpConvLeakyReLU(32 * c, 16 * c)
        skip = {5: 16 * c, 4: 8 * c, 3: 4 * c, 2: 2 * c, 1: c}
        cin = 32 * c + 3  # concat5 = conv5, deconv5, w
        for lvl in (5, 4, 3, 2):
            setattr(self, f"Pred{lvl}", nn.Conv3d(cin, 3, 3, 1, 1))
            setattr(self, f"Upsamp{lvl}to{lvl - 1}", UpConvFlow(3))
            setattr(self, f"Deconv{lvl - 1}", UpConvLeakyReLU(cin, skip[lvl - 1]))
            cin = 2 * skip[lvl - 1] + 3
        self.Pred0 = UpConvFlow(cin)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Torch-default init, then N(0, 1e-5) for ``Pred0``."""
        reset_torch_default_(self, generator)
        normal_(self.Pred0.upconv.weight, 1e-5, generator)

    def forward(self, moving, fixed):
        check_vtn_shape(moving, fixed)
        conv1, conv2, conv3, conv4, conv5, conv6 = self.encoder(torch.cat([moving, fixed], -1))
        skips = {5: conv5, 4: conv4, 3: conv3, 2: conv2, 1: conv1}
        w = self.Upsamp6to5(conv3d_ndhwc(self.Pred6, conv6))
        concat = torch.cat([conv5, self.Deconv5(conv6), w], -1)
        for lvl in (5, 4, 3, 2):
            w = getattr(self, f"Upsamp{lvl}to{lvl - 1}")(
                conv3d_ndhwc(getattr(self, f"Pred{lvl}"), concat))
            deconv = getattr(self, f"Deconv{lvl - 1}")(concat)
            concat = torch.cat([skips[lvl - 1], deconv, w], -1)
        flow = self.Pred0(concat) * self.flow_multiplier
        if self.do_warp:
            return warp(moving, flow, kernels=self.kernels), flow
        return flow


def build_vtn(channels: int = 16, attn_impl: str = "auto", device=None,
              generator: torch.Generator | None = None) -> VTN:
    """A VTN on ``device`` with weights drawn from ``generator``.
    attn_impl "auto": its warp reaches K2 for CUDA tensors; "plain": the
    plain version."""
    with torch.device("meta"):
        model = VTN(channels)
    model.to_empty(device=device or "cpu")
    model.reset_parameters(generator)
    mark_model_(model, attn_impl)
    return model


class RCN(nn.Module):
    """Recursive cascade of ``n_cascade`` VTNs (module list ``vtn``).
    forward -> (moved, flow, *subflows), or (moved, flow) with
    ``return_aux=False``. attn_impl as in `build_vtn`."""

    def __init__(self, n_cascade: int = 10, channels: int = 16, flow_multiplier: float = 1.0,
                 return_aux: bool = True, attn_impl: str = "auto", device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.return_aux = return_aux
        with torch.device("meta"):
            self.vtn = nn.ModuleList(VTN(channels, flow_multiplier, do_warp=False)
                                     for _ in range(n_cascade))
        self.to_empty(device=device or "cpu")
        for v in self.vtn:
            v.reset_parameters(generator)
        mark_model_(self, attn_impl)

    def forward(self, moving, fixed):
        check_vtn_shape(moving, fixed)
        flow, subflows, moved = None, [], moving
        for i, vtn in enumerate(self.vtn):
            w = vtn(moved, fixed)
            subflows.append(w)
            flow = w if i == 0 else w + warp(flow, w, kernels=self.kernels)
            moved = warp(moving, flow, kernels=self.kernels)
        if self.return_aux:
            return (moved, flow, *subflows)
        return moved, flow
