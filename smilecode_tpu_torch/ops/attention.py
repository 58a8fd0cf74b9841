"""Motion-decomposition neighborhood attention (ModeT core op), PyTorch.

Counterpart of `smilecode_tpu/ops/attention.py`: for every voxel and head,
softmax over the k^3 logits ``q · k[neighbor] * scale + rpb[offset]``
(zero-padded borders: an out-of-volume neighbour stays in the softmax with
logit ``rpb``) contracted with the constant offset grid, giving a per-head
3-vector deformation subfield.

Token ordering matches the reference: t = (od*3 + oh)*3 + ow over window
positions, offset[t] = (od-1, oh-1, ow-1).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def offset_grid(kernel_size: int = 3) -> np.ndarray:
    """(k^3, 3) constant V matrix of integer offsets, reference ordering."""
    r = np.arange(-(kernel_size // 2), kernel_size // 2 + 1)
    dd, hh, ww = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([dd, hh, ww], axis=-1).reshape(-1, 3).astype(np.float32)


# the reference whitelists these neighborhood sizes; its launcher, and the
# fused kernels of both packages, implement 3 only
KERNEL_SIZES = (3, 5, 7, 9, 11, 13)


def neighborhood_attention_3d(q, k, rpb, scale: float = 1.0, kernels: bool = True,
                              kernel_size: int = 3) -> torch.Tensor:
    """Fused neighborhood attention -> deformation subfields.

    Args:
      q, k: (B, D, H, W, heads, head_dim) query (fixed) and key (moving).
      rpb: (heads, k, k, k) relative position bias, or None.
      scale: query scaling (the reference trains with scale=1).
      kernels: the model's kernel switch. True sends kernel_size 3 through
        the Hopper kernel wrapper (`kernels/modet_attn.py`: the forward
        kernel, and the backward kernels under autograd, for CUDA tensors;
        this module's plain version for CPU tensors); False forces the plain
        version. Other kernel sizes always take the plain version.

    Returns:
      (B, D, H, W, heads*3) subfields, channel order head-major then (d,h,w).
    """
    if kernel_size not in KERNEL_SIZES:
        raise ValueError(f"kernel_size {kernel_size} not in whitelist {KERNEL_SIZES}")
    if kernels and kernel_size == 3:
        from smilecode_tpu_torch.kernels.modet_attn import modet_attention

        return modet_attention(q.contiguous(), k.contiguous(), rpb, scale)
    return _neighborhood_attention_plain(q, k, rpb, scale, kernel_size)


def _neighborhood_attention_plain(q, k, rpb, scale, kernel_size: int = 3,
                                  k_halo: bool = False) -> torch.Tensor:
    """Plain version, mirroring `_neighborhood_attention_xla`: k^3 shifted
    slices of the zero-padded key volume, softmax, offset contraction.

    ``k_halo``: k already carries its kernel_size//2 D border (D + 2*pad
    slices, the D-sharded path's halo: `_neighborhood_attention_xla(...,
    k_prepadded_d=True)`), so only H and W are zero-padded.

    bf16 q and k are computed on as kernel A does
    (`smilecode_tpu/kernels/modet_attn.py:72-77`): q is scaled in its own
    dtype, then logits, softmax and the contraction run in float32, and the
    result is cast to q's dtype (`_forward`, `:180`). The XLA oracle of the
    JAX package would compute bf16 logits, which no kernel does."""
    b, d, h, w, heads, hd = q.shape
    ks = kernel_size
    pad = ks // 2
    cdt = torch.promote_types(q.dtype, torch.float32)
    qs = (q * torch.as_tensor(scale, dtype=q.dtype)).to(cdt)
    dpad = 0 if k_halo else pad
    kp = F.pad(k.to(cdt), (0, 0, 0, 0, pad, pad, pad, pad, dpad, dpad))
    logits = []
    for od in range(ks):
        for oh in range(ks):
            for ow in range(ks):
                kslice = kp[:, od:od + d, oh:oh + h, ow:ow + w]
                logit = torch.sum(qs * kslice, dim=-1)  # (B, D, H, W, heads)
                if rpb is not None:
                    logit = logit + rpb[:, od, oh, ow].to(logit.dtype)
                logits.append(logit)
    attn = torch.softmax(torch.stack(logits, dim=-1), dim=-1)  # (..., heads, k^3)
    offs = torch.as_tensor(offset_grid(ks), device=q.device).to(attn.dtype)
    # offsets are small integers: the sum of products is exact per term, so
    # write it out rather than trust a matmul's precision mode (TF32)
    out = torch.stack([(attn * offs[:, i]).sum(dim=-1) for i in range(3)], dim=-1)
    return out.reshape(b, d, h, w, heads * 3).to(q.dtype)
