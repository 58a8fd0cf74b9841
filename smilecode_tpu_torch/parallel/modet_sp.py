"""The ModeT forward with its D axis sharded over the "spatial" ranks.

Counterpart of `smilecode_tpu/parallel/modet_sp.py:44-237`, the D-sharded
reference graph (not the planes plumbing of `modet_planes_sp.py`): the
port's `models.modet.ModeT.forward` itself, on its own parameters, with the
D-sharded ops of `SpatialOps`. Each rank holds the D slab of its spatial
index of the moving and the fixed volume; per op:

* 3^3 convolutions: a 1-voxel D halo per layer (`spatial.halo_conv`);
* InstanceNorm: the per-(B, C) statistics summed over "spatial" (two
  passes, mean then the centred squares, as `torch.var_mean` computes the
  unsharded norm; JAX's one-pass E[x^2] - E[x]^2 is the same function);
* projection, LayerNorm, softmax, the flow arithmetic, avg-pool: local;
* attention: a 1-voxel D halo on k, then K1 in its halo-k mode
  (`kernels.modet_attn.modet_attention(..., k_halo=True)`), whose backward
  (K3, K4) returns dk for the D+2 slices;
* 2x trilinear upsampling: a 1-voxel D halo, the D axis interpolated at
  global positions (the unsharded `ops.resize._interp_axis`'s, so both give
  the same values), H and W local;
* warps: the source all-gathered over "spatial", then K2 in its D-origin
  mode at global depth (``d0`` = this rank's first slice); the backward is
  K5 with the same origin, whose d_src over the gathered depth the
  all-gather's transpose reduce-scatters home (JAX `_warp_sp_hw_bwd`,
  `modet_planes_sp.py:259-270`).

float32 only: JAX's spatial graph has no dtype argument
(`modet_planes_sp.py:523-531`).
"""

from __future__ import annotations

import numpy as np
import torch

from smilecode_tpu_torch.kernels.modet_attn import modet_attention, modet_attention_plain
from smilecode_tpu_torch.kernels.warp3d import warp3d_trilinear, warp3d_trilinear_plain
from smilecode_tpu_torch.ops.blocks import leaky_relu
from smilecode_tpu_torch.ops.resize import _interp_axis, avg_pool2
from smilecode_tpu_torch.parallel.mesh import Mesh, all_gather_d, psum
from smilecode_tpu_torch.parallel.spatial import halo_conv, halo_exchange


def instance_norm_sp(x: torch.Tensor, mesh: Mesh, eps: float = 1e-5) -> torch.Tensor:
    """torch InstanceNorm3d (affine=False, biased variance) of the global
    volume, from D slabs: the statistics are summed over "spatial"."""
    b, dl, h, w, c = x.shape
    count = float(dl * h * w * mesh.spatial)
    mean = psum(x.sum(dim=(1, 2, 3), keepdim=True), mesh) / count
    centred = x - mean
    var = psum((centred * centred).sum(dim=(1, 2, 3), keepdim=True), mesh) / count
    return centred * torch.rsqrt(var + eps)


def _conv(conv, x, mesh):
    return halo_conv(x, conv.weight, conv.bias, mesh)


def _conv_block(block, x, mesh):
    return leaky_relu(_conv(block.main, x, mesh), block.alpha)


def _conv_ins_block(block, x, mesh):
    return leaky_relu(instance_norm_sp(_conv(block.main, x, mesh), mesh), block.alpha)


def encoder_sp(enc, x, mesh: Mesh):
    """`models.modet.Encoder` on a D slab."""
    out0 = _conv_block(enc.conv0_0, x, mesh)
    out0 = _conv_ins_block(enc.conv0_2, _conv_ins_block(enc.conv0_1, out0, mesh), mesh)
    outs = [out0]
    for level in (1, 2, 3, 4):
        y = _conv_ins_block(getattr(enc, f"conv{level}_1"), avg_pool2(outs[-1]), mesh)
        outs.append(_conv_ins_block(getattr(enc, f"conv{level}_2"), y, mesh))
    return outs


def attention_sp(mdt, q, k, mesh: Mesh, kernels: bool = True):
    """`models.modet.ModeTransformer` on D slabs: k gets a 1-voxel D halo
    from the neighbours (zeros at the volume's ends, the unsharded zero
    border), then the attention in halo-k mode (``kernels`` False: its
    plain version)."""
    b, dl, h, w, _ = q.shape
    kh = halo_exchange(k, 1, mesh)
    q6 = q.reshape(b, dl, h, w, mdt.num_heads, mdt.head_dim)
    k6 = kh.reshape(b, dl + 2, h, w, mdt.num_heads, mdt.head_dim)
    if not kernels:
        return modet_attention_plain(q6, k6, mdt.rpb, mdt.scale, k_halo=True)
    return modet_attention(q6.contiguous(), k6.contiguous(), mdt.rpb, mdt.scale, k_halo=True)


def upsample2_sp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """2x trilinear upsampling (align_corners) of D slabs: the D axis at the
    global positions of `ops.resize._interp_axis` from a 1-voxel D halo, H
    and W local."""
    n, i = mesh.spatial, mesh.spatial_index
    b, dl, h, w, _ = x.shape
    dg = dl * n
    xh = halo_exchange(x, 1, mesh)
    pos = (np.arange(2 * dg, dtype=np.float64) * (dg - 1) / max(2 * dg - 1, 1))[
        i * 2 * dl:(i + 1) * 2 * dl]
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, dg - 1)
    i1 = np.clip(i0 + 1, 0, dg - 1)
    frac = torch.as_tensor((pos - i0).astype(np.float32), device=x.device).to(x.dtype)
    fr = frac.reshape(1, 2 * dl, 1, 1, 1)
    x0 = torch.index_select(xh, 1, torch.as_tensor(i0 - i * dl + 1, device=x.device))
    x1 = torch.index_select(xh, 1, torch.as_tensor(i1 - i * dl + 1, device=x.device))
    up = x0 * (1 - fr) + x1 * fr
    return _interp_axis(_interp_axis(up, 2 * h, 2), 2 * w, 3)


def warp_sp(src: torch.Tensor, flow: torch.Tensor, mesh: Mesh, kernels: bool = True):
    """Warp the D slab ``src`` by the local ``flow`` (same slab): the source
    all-gathered over "spatial", sampled at global depth. Exact for any
    displacement. ``kernels`` False: the plain version."""
    src_g = all_gather_d(src, mesh)
    d0 = mesh.spatial_index * flow.shape[1]
    if not kernels:
        return warp3d_trilinear_plain(src_g, flow, d0)
    return warp3d_trilinear(src_g.contiguous(), flow.contiguous(), d0)


def cwm_sp(cwm, x, mesh: Mesh):
    """`models.modet.CWM` on D slabs."""
    x = upsample2_sp(x, mesh)
    w = _conv_ins_block(cwm.conv[1], _conv_ins_block(cwm.conv[0], x, mesh), mesh)
    w = torch.softmax(_conv(cwm.conv[2], w, mesh), dim=-1)
    b, d, h, ww, _ = x.shape
    fields = x.reshape(b, d, h, ww, cwm.num_fields, 3)
    return 2.0 * torch.sum(fields * w[..., None], dim=-2)


class SpatialOps:
    """`ModeT.forward`'s ops on the D slabs of ``mesh``'s "spatial" ranks,
    with ``model``'s parameters."""

    def __init__(self, model, mesh: Mesh):
        self.model, self.mesh, self.kernels = model, mesh, model.kernels

    def encode(self, x):
        return encoder_sp(self.model.encoder, x, self.mesh)

    def attend(self, level, f, m):
        proj = getattr(self.model, f"projblock{level}")
        return attention_sp(getattr(self.model, f"mdt{level}"), proj(f), proj(m), self.mesh,
                            self.kernels)

    def fuse(self, level, x):
        return cwm_sp(getattr(self.model, f"cwm{level}"), x, self.mesh)

    def warp(self, src, flow):
        return warp_sp(src, flow, self.mesh, self.kernels)

    def upsample(self, x):
        return upsample2_sp(x, self.mesh)


def modet_forward_spatial(model, moving: torch.Tensor, fixed: torch.Tensor, mesh: Mesh):
    """`ModeT.forward` with D sharded over "spatial" (the same graph, on
    `SpatialOps`): ``moving`` and ``fixed`` are this rank's D slabs (B,
    D/spatial, H, W, 1) of volumes whose D is a multiple of 16 * spatial;
    returns this rank's slabs of (y_moved, flow). With ``model.kernels``,
    the model's kernel switch, on: the kernels' halo-k and D-origin modes
    on CUDA tensors (their plain versions on CPU tensors); off: the plain
    versions."""
    dl, n = moving.shape[1], mesh.spatial
    if dl % 16:
        raise ValueError(f"D={dl * n} must be divisible by 16*{n}")
    if model.compute_dtype is not None:
        raise ValueError("the D-sharded ModeT graph runs float32 only (JAX's has no dtype "
                         f"argument), got compute_dtype {model.compute_dtype}")
    return model(moving, fixed, ops=SpatialOps(model, mesh))
