"""ModeT — Motion Decomposition Transformer, PyTorch.

Counterpart of `smilecode_tpu/models/modet.py` (the reference graph, not the
TPU planes layout): a 5-level shared conv encoder on both volumes; per
level, linear projections of the fixed (query) and warped-moving (key)
features feed neighborhood attention that emits per-head 3-vector
subfields; a competitive weighting module (CWM) fuses subfields at the
coarse levels; fields compose coarse-to-fine.

Keeps the reference's quirks: qk scale = ``qk_scale or head_dim**-0.5``
(the reference trains with 1), CWM multiplies the fused field by 2, level 2
composes THEN upsamples, levels 1-2 have one head and no CWM.

Module names follow the reference `state_dict` keys (``encoder.conv0_0.main
.weight``, ``cwm5.conv.0.main.weight``, ``projblock5.proj.weight``,
``mdt5.rpb``), so `smilecode_tpu.convert.convert_state_dict` maps a port
`state_dict` onto the JAX model and a reference ``.pth.tar`` loads directly.
No buffers are registered.

Layout: channels-last NDHWC; flow (B, D, H, W, 3) voxel displacements.

``compute_dtype="bfloat16"`` runs the feature path in bf16, as the JAX
module does (`smilecode_tpu/models/modet.py:153-210`): the encoder,
projections, attention inputs, CWM and the feature warps; the CWM outputs
(levels 5-3) and attention outputs (levels 2-1) are cast to float32, so flow
composition, upsampling and the final warp of the float32 moving image run
in float32, and the outputs are float32. Parameters stay float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from smilecode_tpu_torch.config import COMPUTE_DTYPES
from smilecode_tpu_torch.ops.attention import neighborhood_attention_3d
from smilecode_tpu_torch.ops.blocks import (
    ConvBlock,
    ConvInsBlock,
    conv3d_ndhwc,
    layer_norm,
    linear,
    mark_model_,
    normal_,
    reset_conv_,
)
from smilecode_tpu_torch.ops.resize import avg_pool2, upsample2_trilinear
from smilecode_tpu_torch.ops.warp import warp


class Encoder(nn.Module):
    """5-scale conv pyramid, channels (2c, 4c, 8c, 16c, 32c), AvgPool3d(2)."""

    def __init__(self, in_channels: int = 1, first_out_channel: int = 4):
        super().__init__()
        c = first_out_channel
        self.conv0_0 = ConvBlock(in_channels, c)
        self.conv0_1 = ConvInsBlock(c, 2 * c)
        self.conv0_2 = ConvInsBlock(2 * c, 2 * c)
        self.conv1_1 = ConvInsBlock(2 * c, 4 * c)
        self.conv1_2 = ConvInsBlock(4 * c, 4 * c)
        self.conv2_1 = ConvInsBlock(4 * c, 8 * c)
        self.conv2_2 = ConvInsBlock(8 * c, 8 * c)
        self.conv3_1 = ConvInsBlock(8 * c, 16 * c)
        self.conv3_2 = ConvInsBlock(16 * c, 16 * c)
        self.conv4_1 = ConvInsBlock(16 * c, 32 * c)
        self.conv4_2 = ConvInsBlock(32 * c, 32 * c)

    def forward(self, x):
        out0 = self.conv0_2(self.conv0_1(self.conv0_0(x)))
        out1 = self.conv1_2(self.conv1_1(avg_pool2(out0)))
        out2 = self.conv2_2(self.conv2_1(avg_pool2(out1)))
        out3 = self.conv3_2(self.conv3_1(avg_pool2(out2)))
        out4 = self.conv4_2(self.conv4_1(avg_pool2(out3)))
        return out0, out1, out2, out3, out4


class ProjectionLayer(nn.Module):
    """Linear proj (weight ~ N(0, 1e-5), bias 0) + LayerNorm (eps 1e-5)
    over the full heads*head_dim channel."""

    def __init__(self, in_channels: int, dim: int = 6):
        super().__init__()
        self.proj = nn.Linear(in_channels, dim)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, feat):
        return layer_norm(self.norm, linear(self.proj, feat))


class CWM(nn.Module):
    """Competitive weighting: upsample x2 then softmax-weighted fusion of the
    per-head subfields (softmax over the fields axis), times 2."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.num_fields = in_channels // 3
        self.conv = nn.ModuleList([
            ConvInsBlock(in_channels, channels),
            ConvInsBlock(channels, channels),
            nn.Conv3d(channels, self.num_fields, 3, 1, 1),
        ])

    def forward(self, x):
        x = upsample2_trilinear(x)
        w = self.conv[1](self.conv[0](x))
        w = torch.softmax(conv3d_ndhwc(self.conv[2], w), dim=-1)
        b, d, h, ww, _ = x.shape
        fields = x.reshape(b, d, h, ww, self.num_fields, 3)  # head-major
        return 2.0 * torch.sum(fields * w[..., None], dim=-2)


class ModeTransformer(nn.Module):
    """Neighborhood attention -> per-head subfields; holds the zero-init RPB
    (heads, 3, 3, 3)."""

    def __init__(self, dim: int, num_heads: int, qk_scale: float | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = float(qk_scale or self.head_dim ** -0.5)
        self.rpb = nn.Parameter(torch.zeros(num_heads, 3, 3, 3))

    def forward(self, q, k):
        b, d, h, w, _ = q.shape
        q = q.reshape(b, d, h, w, self.num_heads, self.head_dim)
        k = k.reshape(b, d, h, w, self.num_heads, self.head_dim)
        return neighborhood_attention_3d(q, k, self.rpb, scale=self.scale, kernels=self.kernels)


class ModeT(nn.Module):
    """Full coarse-to-fine model. forward(moving, fixed) -> (y_moved, flow);
    volumes (B, D, H, W, 1) float32.

    attn_impl: "auto" sends the attention and the bilinear warps through the
    Hopper kernel wrappers (kernels for CUDA tensors, plain versions for CPU
    tensors); "plain" forces the plain PyTorch versions of both.

    compute_dtype: "" (float32) or "bfloat16" (the feature path in bf16; see
    the module docstring). Per pair the bf16 path runs 5 bf16 attentions and
    9 warps: 4 of bf16 features, 4 float32 flow compositions and the
    float32 moved image.

    Parameters are created on ``device`` and drawn from ``generator`` on the
    CPU (`ops/blocks.py`), so a seed gives the same weights on every device.
    """

    def __init__(self, channels: int = 4, head_dim: int = 6,
                 num_heads: Sequence[int] = (8, 4, 2, 1, 1), qk_scale: float | None = None,
                 attn_impl: str = "auto", compute_dtype: str | None = "", device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if (compute_dtype or "") not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype!r}")
        self.compute_dtype = getattr(torch, compute_dtype) if compute_dtype else None
        c, nh = channels, tuple(num_heads)
        enc_ch = (2 * c, 4 * c, 8 * c, 16 * c, 32 * c)  # levels 1..5
        with torch.device("meta"):
            self.encoder = Encoder(1, c)
            for level, heads in zip((5, 4, 3, 2, 1), nh):
                dim = head_dim * heads
                setattr(self, f"projblock{level}", ProjectionLayer(enc_ch[level - 1], dim))
                setattr(self, f"mdt{level}", ModeTransformer(dim, heads, qk_scale))
                if level >= 3:
                    setattr(self, f"cwm{level}", CWM(3 * heads, 3 * heads * 2))
        self.to_empty(device=device or "cpu")
        self.reset_parameters(generator)
        mark_model_(self, attn_impl)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Torch-default conv init, N(0, 1e-5) projection weights, zero
        projection bias, unit/zero LayerNorm, zero RPB — in module order."""
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                reset_conv_(m, generator)
            elif isinstance(m, nn.Linear):
                normal_(m.weight, 1e-5, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, ModeTransformer):
                nn.init.zeros_(m.rpb)

    # the graph's ops; `parallel.modet_sp.SpatialOps` has their D-sharded versions
    def encode(self, x):
        return self.encoder(x)

    def attend(self, level, f, m):
        proj = getattr(self, f"projblock{level}")
        return getattr(self, f"mdt{level}")(proj(f), proj(m))

    def fuse(self, level, x):
        return getattr(self, f"cwm{level}")(x)

    def warp(self, src, flow):
        return warp(src, flow, kernels=self.kernels)

    def upsample(self, x):
        return upsample2_trilinear(x)

    def forward(self, moving, fixed, ops=None):
        """``ops``: what provides encode/attend/fuse/warp/upsample, by
        default this module (`parallel.modet_sp.modet_forward_spatial`
        passes the D-sharded ones)."""
        ops = self if ops is None else ops
        cd = self.compute_dtype
        m1, m2, m3, m4, m5 = ops.encode(moving.to(cd) if cd else moving)
        f1, f2, f3, f4, f5 = ops.encode(fixed.to(cd) if cd else fixed)
        # the bf16 path's CWM and attention outputs return to float32; any
        # other dtype (float32, or float64 in tests) is kept
        def f32(t):
            return t.float() if cd else t

        # level 5 (1/16)
        flow = f32(ops.fuse(5, ops.attend(5, f5, m5)))  # now at 1/8

        # level 4 (1/8)
        w = f32(ops.fuse(4, ops.attend(4, f4, ops.warp(m4, flow))))
        flow = ops.warp(ops.upsample(2 * flow), w) + w  # at 1/4

        # level 3 (1/4)
        w = f32(ops.fuse(3, ops.attend(3, f3, ops.warp(m3, flow))))
        flow = ops.warp(ops.upsample(2 * flow), w) + w  # at 1/2

        # level 2 (1/2): single head, no CWM; compose THEN upsample
        w = f32(ops.attend(2, f2, ops.warp(m2, flow)))
        flow = ops.upsample(2 * (ops.warp(flow, w) + w))  # at full res

        # level 1 (full res): single head, no CWM
        w = f32(ops.attend(1, f1, ops.warp(m1, flow)))
        flow = ops.warp(flow, w) + w

        y_moved = ops.warp(moving, flow)
        return y_moved, flow
