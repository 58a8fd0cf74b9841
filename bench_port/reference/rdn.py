"""Plain reference of RDN, the doubly-recursive registration network
(SmileCode's `Baseline methods/RDN`), deterministic (no dropout), functional
over a ``params`` dict of the published `state_dict` keys.

A 4-level stride-2 conv encoder (c, 2c, 4c, 8c; LeakyReLU 0.2) on both
volumes. Per stage, one estimator per level (`est{level}_{stage}`: three
3x3x3 convs, LeakyReLU 0.1, a flow conv) on the concatenated fixed and
moving features; every stage after the first re-warps the moving features
by the accumulated flow, scaled down to each level (``interpolate(flow,
f) * f``); at each level the estimate repeats ``levels`` times, warping the
features by the level's flow before and composing the flow after every
estimate (but the first, at the coarsest level); the level's flow doubles
and upsamples to the next. Flows live at half resolution and are upsampled
2x at the end. NCDHW.
"""

from __future__ import annotations

import torch

from bench_port.reference.common import leaky, resize, upsample2


def param_shapes(knobs: dict) -> dict:
    c, stages = knobs["channels"], knobs["stages"]
    shapes = {}
    for i, (cin, cout) in enumerate(((1, c), (c, 2 * c), (2 * c, 4 * c), (4 * c, 8 * c))):
        shapes[f"encoder.conv{i}.main.weight"] = (cout, cin, 3, 3, 3)
        shapes[f"encoder.conv{i}.main.bias"] = (cout,)
    for level in range(4):
        e = 2 * c * 2 ** level
        for stage in range(stages):
            for j, cout in ((0, e), (1, e), (2, e), (4, 3)):
                shapes[f"est{level}_{stage}.conv.{j}.weight"] = (cout, e, 3, 3, 3)
                shapes[f"est{level}_{stage}.conv.{j}.bias"] = (cout,)
    return shapes


def encode(p, ops, x):
    outs = []
    for i in range(4):
        x = leaky(ops.conv(x, p[f"encoder.conv{i}.main.weight"], p[f"encoder.conv{i}.main.bias"],
                           stride=2), 0.2)
        outs.append(x)
    return outs


def estimate(p, ops, level, stage, fixed_fm, moving_fm):
    x = torch.cat([fixed_fm, moving_fm], dim=1)
    name = f"est{level}_{stage}.conv"
    for j in (0, 1, 2):
        x = ops.conv(x, p[f"{name}.{j}.weight"], p[f"{name}.{j}.bias"])
    return ops.conv(leaky(x, 0.1), p[f"{name}.4.weight"], p[f"{name}.4.bias"])


def _down(flow, factor):
    size = [int(n * factor) for n in flow.shape[2:]]
    return resize(flow, size) * factor


def forward(p, ops, knobs, moving, fixed):
    """(moved, flow, *per-stage flows) for NCDHW volumes (B, 1, D, H, W)."""
    levels = knobs["levels"]
    fm = encode(p, ops, moving)
    ff = encode(p, ops, fixed)
    flow, aux = None, []
    for i in range(knobs["stages"]):
        if i == 0:
            cur = list(fm)
        else:
            cur = [ops.warp(fm[3], _down(flow, 0.125)), ops.warp(fm[2], _down(flow, 0.25)),
                   ops.warp(fm[1], _down(flow, 0.5)), ops.warp(fm[0], flow)][::-1]
        sflow = None
        for j in range(levels[3]):
            if j == 0:
                sflow = estimate(p, ops, 3, i, ff[3], cur[3])
            else:
                w = estimate(p, ops, 3, i, ff[3], ops.warp(cur[3], sflow))
                sflow = ops.warp(sflow, w) + w
        for lvl in (2, 1, 0):
            sflow = upsample2(2 * sflow)
            for _ in range(levels[lvl]):
                w = estimate(p, ops, lvl, i, ff[lvl], ops.warp(cur[lvl], sflow))
                sflow = ops.warp(sflow, w) + w
        flow = sflow if i == 0 else ops.warp(flow, sflow) + sflow
        aux.append(sflow)
    flow_out = upsample2(2 * flow)
    return (ops.warp(moving, flow_out), flow_out, *aux)


def train_outputs(outs):
    """NCC on the moved image, the L2 diffusion regulariser on each stage's
    flow; the composed flow is left out."""
    return [outs[0], *outs[2:]]
