"""Plain PyTorch operations of the benchmark's references, channels-first
(NCDHW), float32.

Written for the benchmark from the published models' PyTorch code, not from
the program under test: this file imports torch alone. Convolutions and
linear layers are `F.conv3d` and `F.linear`; the spatial transformer is
`F.grid_sample` (align_corners=True, zeros outside), as SmileCode's
`SpatialTransformer`; upsampling is `F.interpolate` (trilinear,
align_corners=True).

`Ops` carries two things the benchmark needs besides the values:

* ``tf32``: the control. Every operand of a convolution and of a linear
  layer is rounded to TF32 (10 mantissa bits, to nearest) before a float32
  product, which is what TF32 tensor cores do to float32 inputs.
* ``calls``: a list that, when given, records each call that the program
  runs as a hand-written kernel (K1 attention, K2 trilinear warp; under
  autograd K3/K4 and K5), with the shapes that `bench_port.work` counts.
  The benchmark fills it on the meta device, so the count follows from the
  configuration's shapes alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 mantissa bits, nearest-even."""
    if x.device.type == "meta":
        return x
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


class Ops:
    """The operations above, in float32 or (``tf32``) the control's
    precision; ``calls`` records the kernel calls when it is a list."""

    def __init__(self, tf32: bool = False, calls: list | None = None):
        self.tf32 = tf32
        self.calls = calls

    def _r(self, t):
        """``t``, or in the control ``t`` rounded to TF32 (the gradient
        passes through the rounding unchanged)."""
        if not self.tf32 or t is None:
            return t
        r = round_tf32(t.detach())
        return t + (r - t.detach()) if t.requires_grad else r

    def conv(self, x, w, b, stride=1, padding=1):
        return F.conv3d(self._r(x), self._r(w), b, stride=stride, padding=padding)

    def linear(self, x, w, b):
        """``w`` (out, in) over the channel axis of NCDHW ``x``."""
        y = F.linear(self._r(x.movedim(1, -1)), self._r(w), b)
        return y.movedim(-1, 1)

    # -- warps -----------------------------------------------------------------
    def _record_warp(self, src, flow):
        if self.calls is None:
            return
        voxels = flow.shape[0] * flow.shape[2] * flow.shape[3] * flow.shape[4]
        src_voxels = src.shape[0] * src.shape[2] * src.shape[3] * src.shape[4]
        common = dict(src_voxels=src_voxels, voxels=voxels, c=src.shape[1], isz=4)
        self.calls.append(dict(kernel="K2", **common))
        if torch.is_grad_enabled() and (src.requires_grad or flow.requires_grad):
            self.calls.append(dict(kernel="K5", scatter=bool(src.requires_grad), **common))

    def warp(self, src, flow, mode="bilinear"):
        """Sample ``src`` (B, C, S...) at grid + ``flow`` (B, 3, F..., voxel
        displacements along D, H, W); a flow of another size than the source
        samples at (grid + flow) * (S - 1) / (F - 1)."""
        if mode == "bilinear":
            self._record_warp(src, flow)
        sizes = flow.shape[2:]
        grid = torch.stack(torch.meshgrid(
            *[torch.arange(n, dtype=flow.dtype, device=flow.device) for n in sizes],
            indexing="ij"))
        loc = grid + flow
        norm = torch.stack([2 * loc[:, i] / (sizes[i] - 1) - 1 for i in range(3)], dim=-1)
        return F.grid_sample(src, norm.flip(-1), mode=mode, padding_mode="zeros",
                             align_corners=True)

    # -- attention ---------------------------------------------------------------
    def attention(self, q, k, rpb, heads: int, scale: float):
        """ModeT's motion-decomposition attention. q, k: (B, heads*hd, D, H,
        W); rpb (heads, 3, 3, 3). Per voxel and head: softmax over the 27
        neighbours of q . k * scale + rpb (zero-padded k: an outside
        neighbour keeps the logit rpb), contracted with the neighbours'
        offsets. Returns (B, heads*3, D, H, W), head-major."""
        b, ch, d, h, w = q.shape
        hd = ch // heads
        if self.calls is not None:
            shape = (b, d, h, w, heads, hd)
            self.calls.append(dict(kernel="K1", shape=shape, isz=4))
            if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
                self.calls.append(dict(kernel="K3", shape=shape, isz=4))
                self.calls.append(dict(kernel="K4", shape=shape, isz=4))
        q = q.reshape(b, heads, hd, d, h, w)
        kp = F.pad(k, (1, 1, 1, 1, 1, 1)).reshape(b, heads, hd, d + 2, h + 2, w + 2)
        logits, offsets = [], []
        for od in range(3):
            for oh in range(3):
                for ow in range(3):
                    kk = kp[:, :, :, od:od + d, oh:oh + h, ow:ow + w]
                    logits.append((q * kk).sum(dim=2) * scale
                                  + rpb[:, od, oh, ow].reshape(1, heads, 1, 1, 1))
                    offsets.append((od - 1, oh - 1, ow - 1))
        attn = torch.softmax(torch.stack(logits, dim=2), dim=2)  # (B, heads, 27, D, H, W)
        off = torch.tensor(offsets, dtype=attn.dtype, device=attn.device)  # (27, 3)
        out = torch.stack([(attn * off[:, i].reshape(1, 1, 27, 1, 1, 1)).sum(dim=2)
                           for i in range(3)], dim=2)  # (B, heads, 3, D, H, W)
        return out.reshape(b, heads * 3, d, h, w)


def leaky(x, slope):
    return F.leaky_relu(x, slope)


def instance_norm(x, eps=1e-5):
    """InstanceNorm3d without affine: per sample and channel, biased
    variance."""
    var, mean = torch.var_mean(x, dim=(2, 3, 4), correction=0, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="trilinear", align_corners=True)


def resize(x, size):
    return F.interpolate(x, size=tuple(size), mode="trilinear", align_corners=True)


def avg_pool2(x):
    return F.avg_pool3d(x, 2)
