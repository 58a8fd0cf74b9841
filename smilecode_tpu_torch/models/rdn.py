"""RDN family — doubly-recursive registration networks, PyTorch.

Counterpart of `smilecode_tpu/models/rdn.py`: a 4-level stride-2 conv
encoder (c=16, LeakyReLU 0.2); `Estimator` = 3 convs + LeakyReLU(0.1) + an
N(0, 1e-5) flow conv; the outer stage recursion re-warps the moving
features by the accumulated flow (downscaled per level by
``interpolate(flow, scale) * scale``); the inner level recursion repeats
estimate -> compose at each pyramid level (1/16 up to 1/2); all flows at
half resolution, a final 2x trilinear upsample.

The four deterministic variants map to flags: ``share_weights`` (one
Estimator set for all stages, ``est{level}``, vs one per stage,
``est{level}_{stage}``) and ``diff`` (each increment is integrated by
`vecint` before composing, and the stationary-velocity composition ``sv``
of each stage is returned in place of its flow). ``return_aux`` emits the
per-stage fields (training) or just (moved, flow). ``dropout_rate > 0``
adds the JAX package's MC-dropout head to every Estimator, live only in a
forward that is given a ``generator`` (the MC-uncertainty protocol,
`infer.run_mc_uncertainty`).

Kernels: every bilinear warp, `vecint`'s included, reaches K2 through
``ops.warp(impl="guarded")``, the counterpart of kernel F's entry. Per
forward: per stage, a feature warp before and a composition after every
estimate but the first; per stage after the first, 4 feature
re-warps and 1 composition; with ``diff``, per estimate also 7 `vecint`
steps and (but for the first) an ``sv`` composition; and the final warp of
the moving image. With stages 4 and levels (4, 4, 4, 4): 136 K2 launches
per pair, 644 with ``diff``.

Module names follow the JAX package's (``encoder.conv0.main.weight``,
``est3.conv.0.weight`` … ``est3.conv.4.weight``; ``conv.3`` is the
LeakyReLU). Layout: NDHWC.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from smilecode_tpu_torch.ops.blocks import (
    ConvBlock,
    channels_last_convs_,
    conv3d_ndhwc,
    normal_,
    reset_torch_default_,
)
from smilecode_tpu_torch.ops.integrate import vecint
from smilecode_tpu_torch.ops.resize import interp_trilinear, upsample2_trilinear
from smilecode_tpu_torch.ops.warp import baseline_warp_impl, warp

VECINT_STEPS = 7


class RDNEncoder(nn.Module):
    """4 stride-2 levels, channels c, 2c, 4c, 8c. RDN's ConvBlock uses
    LeakyReLU 0.2, unlike the 0.1 everywhere else in the reference."""

    def __init__(self, in_channels: int = 1, first_out_channel: int = 16):
        super().__init__()
        c = first_out_channel
        self.conv0 = ConvBlock(in_channels, c, 3, 2, 1, alpha=0.2)
        self.conv1 = ConvBlock(c, 2 * c, 3, 2, 1, alpha=0.2)
        self.conv2 = ConvBlock(2 * c, 4 * c, 3, 2, 1, alpha=0.2)
        self.conv3 = ConvBlock(4 * c, 8 * c, 3, 2, 1, alpha=0.2)

    def forward(self, x):
        out0 = self.conv0(x)
        out1 = self.conv1(out0)
        out2 = self.conv2(out1)
        out3 = self.conv3(out2)
        return out0, out1, out2, out3


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: keep each value with
    probability 1 - rate and divide it by 1 - rate, else 0; the keep mask
    is drawn from ``generator`` (on ``x``'s device)."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class Estimator(nn.Module):
    """concat(fixed, moving features) -> 3 convs -> LeakyReLU(0.1) ->
    [dropout] -> flow conv.

    With ``dropout_rate > 0`` the MC-dropout head of
    `smilecode_tpu/models/rdn.py:Estimator` sits after the activation and
    before the flow conv. It drops only in a forward given a ``generator``,
    as the JAX head drops only when a "dropout" rng is passed; it is not
    tied to ``.train()``, so `train.main` (which passes none, as the JAX
    driver passes no dropout rng) trains deterministically whatever the
    rate.
    """

    def __init__(self, channels: int, dropout_rate: float = 0.0):
        super().__init__()
        c = channels
        self.dropout_rate = dropout_rate
        self.conv = nn.Sequential(nn.Conv3d(c, c, 3, 1, 1), nn.Conv3d(c, c, 3, 1, 1),
                                  nn.Conv3d(c, c, 3, 1, 1), nn.LeakyReLU(0.1),
                                  nn.Conv3d(c, 3, 3, 1, 1))

    def forward(self, fixed_fm, float_fm, generator: torch.Generator | None = None):
        x = torch.cat([fixed_fm, float_fm], -1)
        if generator is None or self.dropout_rate <= 0:
            return conv3d_ndhwc(self.conv, x)
        h = dropout(conv3d_ndhwc(self.conv[:4], x), self.dropout_rate, generator)
        return conv3d_ndhwc(self.conv[4], h)


def _scaled_downsample(flow, factor: float):
    """The reference's ``interpolate(flow, scale_factor=f) * f`` (align_corners)."""
    _, d, h, w, _ = flow.shape
    out = interp_trilinear(flow, (int(d * factor), int(h * factor), int(w * factor)))
    return out * factor


class RDN(nn.Module):
    """forward(moving, fixed) -> (y_moved, flow, *per-stage fields), or
    (y_moved, flow) with ``return_aux=False``; volumes (B, D, H, W, 1).

    attn_impl: "auto" sends every bilinear warp through the Hopper kernel
    wrapper (K2 for CUDA tensors, the plain version for CPU tensors);
    "plain" forces the plain version. Weights are drawn on the CPU from
    ``generator`` (`ops/blocks.py`). ``dropout_rate``: the Estimators'
    MC-dropout rate, live only in ``forward(moving, fixed, generator=g)``.
    """

    def __init__(self, channels: int = 16, stages: int = 1,
                 levels: Sequence[int] = (1, 1, 1, 1), share_weights: bool = True,
                 diff: bool = False, return_aux: bool = True, dropout_rate: float = 0.0,
                 attn_impl: str = "auto", device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.warp_impl = baseline_warp_impl(attn_impl)
        self.stages, self.levels = stages, tuple(levels)
        self.share_weights, self.diff, self.return_aux = share_weights, diff, return_aux
        c = channels
        with torch.device("meta"):
            self.encoder = RDNEncoder(1, c)
            for level in range(4):
                est_ch = 2 * c * 2 ** level  # concat of fixed and moving features
                for stage in range(1 if share_weights else stages):
                    setattr(self, self._est_name(level, stage), Estimator(est_ch, dropout_rate))
        self.to_empty(device=device or "cpu")
        self.reset_parameters(generator)
        channels_last_convs_(self)

    def _est_name(self, level: int, stage: int) -> str:
        return f"est{level}" if self.share_weights else f"est{level}_{stage}"

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Torch-default conv init; N(0, 1e-5) weights and zero bias for each
        Estimator's flow conv."""
        reset_torch_default_(self, generator)
        for m in self.modules():
            if isinstance(m, Estimator):
                normal_(m.conv[4].weight, 1e-5, generator)
                nn.init.zeros_(m.conv[4].bias)

    def _warp(self, src, flow):
        return warp(src, flow, impl=self.warp_impl)

    def _vecint(self, vec):
        return vecint(vec, VECINT_STEPS, impl=self.warp_impl)

    def forward(self, moving, fixed, generator: torch.Generator | None = None):
        """``generator``: draws the Estimators' dropout masks, in the order
        of their calls (MC dropout); None, or ``dropout_rate`` 0, runs the
        deterministic forward."""
        f0m, f1m, f2m, f3m = self.encoder(moving)
        f0f, f1f, f2f, f3f = self.encoder(fixed)

        flow = None
        aux = []
        for i in range(self.stages):
            if i == 0:
                fm0, fm1, fm2, fm3 = f0m, f1m, f2m, f3m
            else:
                fm3 = self._warp(f3m, _scaled_downsample(flow, 0.125))
                fm2 = self._warp(f2m, _scaled_downsample(flow, 0.25))
                fm1 = self._warp(f1m, _scaled_downsample(flow, 0.5))
                fm0 = self._warp(f0m, flow)

            est = [getattr(self, self._est_name(level, i)) for level in range(4)]
            sflow = sv = None
            # level 4 (1/16)
            for j in range(self.levels[3]):
                if j == 0:
                    w = est[3](f3f, fm3, generator)
                    sv = w if self.diff else None
                    sflow = self._vecint(w) if self.diff else w
                else:
                    w = est[3](f3f, self._warp(fm3, sflow), generator)
                    if self.diff:
                        sv = self._warp(sv, w) + w
                        w = self._vecint(w)
                    sflow = self._warp(sflow, w) + w

            # levels 3..1 (1/8, 1/4, 1/2)
            for lvl, (ff, fm) in zip((2, 1, 0), ((f2f, fm2), (f1f, fm1), (f0f, fm0))):
                sflow = upsample2_trilinear(2 * sflow)
                if self.diff:
                    sv = upsample2_trilinear(2 * sv)
                for _ in range(self.levels[lvl]):
                    w = est[lvl](ff, self._warp(fm, sflow), generator)
                    if self.diff:
                        sv = self._warp(sv, w) + w
                        w = self._vecint(w)
                    sflow = self._warp(sflow, w) + w

            flow = sflow if i == 0 else self._warp(flow, sflow) + sflow
            aux.append(sv if self.diff else sflow)

        flow_out = upsample2_trilinear(2 * flow)
        y_moved = self._warp(moving, flow_out)
        if self.return_aux:
            return (y_moved, flow_out, *aux)
        return y_moved, flow_out
