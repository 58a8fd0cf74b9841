"""Plain reference of ModeT (Wang et al., "ModeT: Learning Deformable Image
Registration via Motion Decomposition Transformer", MICCAI 2023), as
SmileCode's `ModeT/models` build it, functional over a ``params`` dict whose
names are the published `state_dict` keys.

Five-scale conv encoder (channels 2c..32c, AvgPool3d(2), LeakyReLU 0.1,
InstanceNorm but at the first block) on both volumes; per level 5..1 a
linear projection and LayerNorm of fixed (query) and warped-moving (key)
features, neighbourhood attention turned into per-head displacement
subfields, a competitive weighting module (upsample, two conv+IN blocks, a
softmax over the heads, times 2) at levels 5..3; flows compose coarse to
fine; level 2 composes then upsamples. NCDHW; flows (B, 3, D, H, W) in
voxels along D, H, W.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_port.reference.common import avg_pool2, instance_norm, leaky, upsample2

LEVELS = (5, 4, 3, 2, 1)
ENCODER = (("conv0_0", 0, 1), ("conv0_1", 1, 2), ("conv0_2", 2, 2), ("conv1_1", 2, 4),
           ("conv1_2", 4, 4), ("conv2_1", 4, 8), ("conv2_2", 8, 8), ("conv3_1", 8, 16),
           ("conv3_2", 16, 16), ("conv4_1", 16, 32), ("conv4_2", 32, 32))


def param_shapes(knobs: dict) -> dict:
    """name -> shape of every parameter at ``knobs`` (channels, head_dim,
    num_heads)."""
    c, hd, heads = knobs["channels"], knobs["head_dim"], knobs["num_heads"]
    shapes = {}
    for name, cin, cout in ENCODER:
        cin = 1 if cin == 0 else cin * c
        shapes[f"encoder.{name}.main.weight"] = (cout * c, cin, 3, 3, 3)
        shapes[f"encoder.{name}.main.bias"] = (cout * c,)
    enc_ch = (2 * c, 4 * c, 8 * c, 16 * c, 32 * c)
    for level, nh in zip(LEVELS, heads):
        dim = hd * nh
        shapes[f"projblock{level}.proj.weight"] = (dim, enc_ch[level - 1])
        shapes[f"projblock{level}.proj.bias"] = (dim,)
        shapes[f"projblock{level}.norm.weight"] = (dim,)
        shapes[f"projblock{level}.norm.bias"] = (dim,)
        shapes[f"mdt{level}.rpb"] = (nh, 3, 3, 3)
        if level >= 3:
            shapes[f"cwm{level}.conv.0.main.weight"] = (6 * nh, 3 * nh, 3, 3, 3)
            shapes[f"cwm{level}.conv.0.main.bias"] = (6 * nh,)
            shapes[f"cwm{level}.conv.1.main.weight"] = (6 * nh, 6 * nh, 3, 3, 3)
            shapes[f"cwm{level}.conv.1.main.bias"] = (6 * nh,)
            shapes[f"cwm{level}.conv.2.weight"] = (nh, 6 * nh, 3, 3, 3)
            shapes[f"cwm{level}.conv.2.bias"] = (nh,)
    return shapes


def _block(p, ops, name, x, norm=True):
    y = ops.conv(x, p[f"{name}.weight"], p[f"{name}.bias"])
    return leaky(instance_norm(y) if norm else y, 0.1)


def encode(p, ops, x):
    outs = []
    for i, (name, _, _) in enumerate(ENCODER):
        if name.endswith("_1") and name != "conv0_1":
            x = avg_pool2(x)
        x = _block(p, ops, f"encoder.{name}.main", x, norm=(i > 0))
        if name.endswith("_2"):
            outs.append(x)
    return outs  # levels 1..5: full, 1/2, 1/4, 1/8, 1/16


def _project(p, ops, level, feat, dim):
    y = ops.linear(feat, p[f"projblock{level}.proj.weight"], p[f"projblock{level}.proj.bias"])
    y = F.layer_norm(y.movedim(1, -1), (dim,), p[f"projblock{level}.norm.weight"],
                     p[f"projblock{level}.norm.bias"], eps=1e-5)
    return y.movedim(-1, 1)


def _attend(p, ops, knobs, level, heads, f, m):
    dim = knobs["head_dim"] * heads
    q, k = _project(p, ops, level, f, dim), _project(p, ops, level, m, dim)
    scale = knobs["qk_scale"] or knobs["head_dim"] ** -0.5
    return ops.attention(q, k, p[f"mdt{level}.rpb"], heads, scale)


def _fuse(p, ops, level, heads, x):
    x = upsample2(x)
    w = _block(p, ops, f"cwm{level}.conv.0.main", x)
    w = _block(p, ops, f"cwm{level}.conv.1.main", w)
    w = torch.softmax(ops.conv(w, p[f"cwm{level}.conv.2.weight"], p[f"cwm{level}.conv.2.bias"]),
                      dim=1)
    b, _, d, h, ww = x.shape
    fields = x.reshape(b, heads, 3, d, h, ww)
    return 2.0 * (fields * w[:, :, None]).sum(dim=1)


def forward(p, ops, knobs, moving, fixed):
    """(moved, flow) for NCDHW volumes (B, 1, D, H, W)."""
    heads = dict(zip(LEVELS, knobs["num_heads"]))
    m1, m2, m3, m4, m5 = encode(p, ops, moving)
    f1, f2, f3, f4, f5 = encode(p, ops, fixed)
    flow = _fuse(p, ops, 5, heads[5], _attend(p, ops, knobs, 5, heads[5], f5, m5))
    for level, f, m in ((4, f4, m4), (3, f3, m3)):
        w = _fuse(p, ops, level, heads[level],
                  _attend(p, ops, knobs, level, heads[level], f, ops.warp(m, flow)))
        flow = ops.warp(upsample2(2 * flow), w) + w
    w = _attend(p, ops, knobs, 2, heads[2], f2, ops.warp(m2, flow))
    flow = upsample2(2 * (ops.warp(flow, w) + w))
    w = _attend(p, ops, knobs, 1, heads[1], f1, ops.warp(m1, flow))
    flow = ops.warp(flow, w) + w
    return ops.warp(moving, flow), flow


def train_outputs(outs):
    """The outputs the training criteria (NCC, then the L2 diffusion
    regulariser) apply to: the moved image and the flow."""
    return list(outs)
