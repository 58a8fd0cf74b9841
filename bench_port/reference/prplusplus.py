"""Plain reference of Dual-PRNet++ (Kang, Hu, Huang, Scott and Reyes,
"Dual-stream pyramid registration network", Medical Image Analysis 2022),
as SmileCode's `Baseline methods/PR++/models.py` builds it (`BackBone`,
`Correlation3D`, `PRplusplusBlock`, `PRNetplusplus`), functional over a
``params`` dict whose names are the published `state_dict` keys.

A shared backbone on both volumes: a 5-level ReLU conv encoder (c, then
stride 2 to 2c, 2c, 4c, 4c) and a U-Net decoder (nearest 2x upsampling,
skip concatenation, conv + ReLU) giving features coarse to fine,
[4c at 1/8, 4c at 1/4, 2c at 1/2, 2c at full, c at full]. Per level a PR++
block: the moving features warped by the incoming flow (doubled and
upsampled, but for blocks 1 and 5), their windowed correlation with the
fixed ones, conv1 (two convs, ReLU) on [moving, correlation, fixed], conv2
(two convs, ReLU) and a residual add, and a flow conv. The flow composes as
it comes, ``flow = T(flow, w) + w``. NCDHW; flows (B, 3, D, H, W) in voxels
along D, H, W.

The correlation is SmileCode's: each map's 3^3 box sum is a grouped
convolution by a ones kernel, the fixed map padded by 2 first, then the 27
crops of the padded map at offsets 0, 2, 4 per axis multiplied with the
moving map's box sum, summed over the channels, divided by 27.

Departures, each as the code and not its docstring has it:

* the correlation's displacements are {-2, 0, 2} per axis (SmileCode's
  crops; its docstring's {-3, -1, 1} is not what the code computes);
* ``T(flow, w)`` warps the coarser flow by the finer field through a
  sampling grid at the field's size, so the coordinates are rescaled by
  (S - 1) / (F - 1) and the flow's magnitude is not doubled.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_port.reference.common import upsample2

ENCODER = (("block1", 0, 1, 1), ("block2", 1, 2, 2), ("block3", 2, 2, 2), ("block4", 2, 4, 2),
           ("block5", 4, 4, 2))
DECODER = (("decoder1", 8, 4), ("decoder2", 6, 4), ("decoder3", 6, 2), ("decoder4", 3, 2),
           ("decoder5", 2, 1))
BLOCK_CHANNELS = (4, 4, 2, 2, 1)  # per block 1..5, times c


def param_shapes(knobs: dict) -> dict:
    """name -> shape of every parameter at ``knobs`` (first_channel)."""
    c = knobs["first_channel"]
    shapes = {}
    for name, cin, cout, _ in ENCODER:
        shapes[f"net.encoder.{name}.main.weight"] = (cout * c, max(cin * c, 1), 3, 3, 3)
        shapes[f"net.encoder.{name}.main.bias"] = (cout * c,)
    for name, cin, cout in DECODER:
        key = f"net.{name}.main" if name == "decoder5" else f"net.{name}.Conv.main"
        shapes[f"{key}.weight"] = (cout * c, cin * c, 3, 3, 3)
        shapes[f"{key}.bias"] = (cout * c,)
    for i, mult in enumerate(BLOCK_CHANNELS, 1):
        ch = mult * c
        c_in = 2 * ch + 27
        for stack, cin, cout in (("conv1.0", c_in, c_in), ("conv1.1", c_in, ch),
                                 ("conv2.0", ch, ch), ("conv2.1", ch, ch), ("flow", ch, 3)):
            shapes[f"prblock{i}.{stack}.weight"] = (cout, cin, 3, 3, 3)
            shapes[f"prblock{i}.{stack}.bias"] = (cout,)
    return shapes


def _conv(p, ops, name, x, stride=1):
    return ops.conv(x, p[f"{name}.weight"], p[f"{name}.bias"], stride=stride)


def _backbone(p, ops, v):
    outs = []
    for name, _, _, stride in ENCODER:
        v = torch.relu(_conv(p, ops, f"net.encoder.{name}.main", v, stride))
        outs.append(v)
    out1, out2, out3, out4, out5 = outs  # full .. 1/16
    feats, x = [], out5
    for (name, _, _), skip in zip(DECODER[:4], (out4, out3, out2, out1)):
        x = torch.cat([F.interpolate(x, scale_factor=2, mode="nearest"), skip], dim=1)
        x = torch.relu(_conv(p, ops, f"net.{name}.Conv.main", x))
        feats.append(x)
    feats.append(torch.relu(_conv(p, ops, "net.decoder5.main", x)))
    return feats  # 1/8, 1/4, 1/2, full (2c), full (c)


def correlation(mov, fix, kernel_size=3, d=3, sf=2):
    """SmileCode's `Correlation3D`: (B, C, D, H, W) x2 -> (B, d^3, D, H, W)."""
    c = mov.shape[1]
    ones = torch.ones((c, 1, kernel_size, kernel_size, kernel_size), dtype=mov.dtype,
                      device=mov.device)
    pad = kernel_size // 2
    pm = F.conv3d(mov, ones, padding=pad, groups=c)
    pf = F.conv3d(F.pad(fix, [sf] * 6), ones, padding=pad, groups=c)
    dd, hh, ww = mov.shape[2:]
    out = [(pm * pf[:, :, i * sf:i * sf + dd, j * sf:j * sf + hh, k * sf:k * sf + ww]).sum(1)
           for i in range(d) for j in range(d) for k in range(d)]
    return torch.stack(out, dim=1) / kernel_size ** 3


def _block(p, ops, i, x, y, flow=None, scale=True):
    name = f"prblock{i}"
    if flow is not None:
        x = ops.warp(x, upsample2(2 * flow) if scale else flow)
    h = torch.cat([x, correlation(x, y), y], dim=1)
    h = torch.relu(_conv(p, ops, f"{name}.conv1.1", _conv(p, ops, f"{name}.conv1.0", h)))
    res = torch.relu(_conv(p, ops, f"{name}.conv2.1", _conv(p, ops, f"{name}.conv2.0", h)))
    return _conv(p, ops, f"{name}.flow", h + res)


def forward(p, ops, knobs, moving, fixed):
    """(moved, flow) for NCDHW volumes (B, 1, D, H, W)."""
    fx, fy = _backbone(p, ops, moving), _backbone(p, ops, fixed)
    flow = _block(p, ops, 1, fx[0], fy[0])
    for i in range(2, 6):
        w = _block(p, ops, i, fx[i - 1], fy[i - 1], flow, scale=i < 5)
        flow = ops.warp(flow, w) + w
    return ops.warp(moving, flow), flow


def train_outputs(outs):
    """The outputs the training criteria (NCC, then the L2 diffusion
    regulariser) apply to: the moved image and the flow."""
    return list(outs)
