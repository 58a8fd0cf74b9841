"""Im2grid — coordinate-translator registration baseline, PyTorch.

Counterpart of `smilecode_tpu/models/im2grid.py`: the 5-level shared
encoder of ModeT (c=4); `PositionalEncodingLayer` is a zero-init linear
projection plus an additive fixed cos/sin 3D positional encoding scaled by
a learned alpha; one parameter-free `cotr` (1-head neighborhood attention,
no qk scale, no rpb) gives soft coordinate offsets at every level; fields
compose as ``flow = up(2*(T(flow, w) + w))`` at levels 5..2 and
``T(flow, w) + w`` at level 1.

Kernels: `cotr` reaches K1 (`kernels/modet_attn.py`) with one head,
head_dim 6 and no rpb; each bilinear warp reaches K2 through
`ops.warp`, the counterpart of kernel F's entry. Per pair:
5 K1 and 9 K2 launches.

Module names follow the reference `state_dict` keys (``encoder.conv0_0.main
.weight``, ``peblock5.proj.weight``, ``peblock5.alpha``). Layout: NDHWC.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from smilecode_tpu_torch.models.modet import Encoder
from smilecode_tpu_torch.ops.attention import neighborhood_attention_3d
from smilecode_tpu_torch.ops.blocks import mark_model_, reset_torch_default_
from smilecode_tpu_torch.ops.resize import upsample2_trilinear
from smilecode_tpu_torch.ops.warp import warp


def _axis_emb(n: int) -> np.ndarray:
    """(n, 2) [cos, sin] of pos·pi/(n-1), computed as the JAX package does."""
    pos = np.arange(n, dtype=np.float32) * (np.pi / (n - 1))
    return np.stack([np.cos(pos), np.sin(pos)], -1)


def _sincos_pe(d: int, h: int, w: int, channels: int, dim: int, device=None) -> torch.Tensor:
    """The reference's additive PE (D, H, W, dim): per-axis [cos, sin] blocks
    of ``channels`` channels each (only the first 2 of a block are set),
    truncated to ``dim``; `smilecode_tpu/models/im2grid.py:_sincos_pe`."""
    emb = torch.zeros((d, h, w, channels * 3), device=device)
    for axis, n in enumerate((d, h, w)):
        shape = [1, 1, 1, 2]
        shape[axis] = n
        emb[..., axis * channels:axis * channels + 2] = torch.from_numpy(
            _axis_emb(n)).to(device).reshape(shape)
    return emb[..., :dim]


class PositionalEncodingLayer(nn.Module):
    """Zero-init proj + alpha-scaled fixed PE."""

    def __init__(self, in_channels: int, dim: int = 6):
        super().__init__()
        self.dim = dim
        self.proj = nn.Linear(in_channels, dim)
        self.alpha = nn.Parameter(torch.ones(1))

    def forward(self, feat):
        feat = self.proj(feat)
        _, d, h, w, _ = feat.shape
        channels = int(np.ceil(self.dim / 6) * 2)
        if channels % 2:
            channels += 1
        emb = _sincos_pe(d, h, w, channels, self.dim, feat.device).to(feat.dtype)
        return feat + self.alpha.to(feat.dtype) * emb


def cotr(q, k, kernels: bool = True):
    """Shared single-head neighborhood attention, no scale, no rpb.
    Parameter-free. (B, D, H, W, C) each -> (B, D, H, W, 3); ``kernels``
    is the model's kernel switch."""
    b, d, h, w, c = q.shape
    return neighborhood_attention_3d(q.reshape(b, d, h, w, 1, c), k.reshape(b, d, h, w, 1, c),
                                     None, scale=1.0, kernels=kernels)


class Im2grid(nn.Module):
    """forward(moving, fixed) -> (y_moved, flow); volumes (B, D, H, W, 1).

    attn_impl: "auto" sends the attention and the bilinear warps through the
    Hopper kernel wrappers (kernels for CUDA tensors, plain versions for CPU
    tensors); "plain" forces the plain PyTorch versions of both. Weights are
    drawn on the CPU from ``generator`` (`ops/blocks.py`).
    """

    def __init__(self, channels: int = 4, attn_impl: str = "auto", device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = channels
        enc_ch = (2 * c, 4 * c, 8 * c, 16 * c, 32 * c)  # levels 1..5
        with torch.device("meta"):
            self.encoder = Encoder(1, c)
            for level in (5, 4, 3, 2, 1):
                setattr(self, f"peblock{level}", PositionalEncodingLayer(enc_ch[level - 1]))
        self.to_empty(device=device or "cpu")
        self.reset_parameters(generator)
        mark_model_(self, attn_impl)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Torch-default conv init; zero projections, unit alpha."""
        reset_torch_default_(self, generator)
        for m in self.modules():
            if isinstance(m, PositionalEncodingLayer):
                nn.init.zeros_(m.proj.weight)
                nn.init.zeros_(m.proj.bias)
                nn.init.ones_(m.alpha)

    def _warp(self, src, flow):
        return warp(src, flow, kernels=self.kernels)

    def _level(self, level, f, m):
        pe = getattr(self, f"peblock{level}")
        return cotr(pe(f), pe(m), self.kernels)

    def forward(self, moving, fixed):
        m1, m2, m3, m4, m5 = self.encoder(moving)
        f1, f2, f3, f4, f5 = self.encoder(fixed)

        w = self._level(5, f5, m5)
        flow = upsample2_trilinear(2 * w)
        for level, f, m in ((4, f4, m4), (3, f3, m3), (2, f2, m2)):
            w = self._level(level, f, self._warp(m, flow))
            flow = upsample2_trilinear(2 * (self._warp(flow, w) + w))
        w = self._level(1, f1, self._warp(m1, flow))
        flow = self._warp(flow, w) + w

        y_moved = self._warp(moving, flow)
        return y_moved, flow
