"""3D spatial warping (the registration `SpatialTransformer`), PyTorch.

Counterpart of `smilecode_tpu/ops/warp.py`: sample ``src`` at ``grid + flow``
(voxel coordinates), trilinear ("bilinear") or nearest, zeros outside the
volume, ``align_corners=True`` semantics. When the flow's spatial shape
differs from the source's, grid_sample's normalised coordinates imply
``src_coord = (grid + flow) * (src_size-1)/(flow_size-1)`` and the output
takes the flow's shape.

Layout: channels-last. ``src``: (B, D, H, W, C); ``flow``: (B, D', H', W', 3)
with last axis = (dd, dh, dw) voxel displacements. No ``grid_sample``: its
reversed (x, y, z) axis order is a trap this layout avoids.
"""

from __future__ import annotations

import torch


def base_grid(d: int, h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity sampling grid of shape (D, H, W, 3); grid[d,h,w] = (d,h,w)."""
    axes = [torch.arange(n, dtype=dtype, device=device) for n in (d, h, w)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def check_warp_args(src: torch.Tensor, flow: torch.Tensor) -> None:
    if src.ndim != 5 or flow.ndim != 5 or flow.shape[-1] != 3:
        raise ValueError(
            f"warp expects NDHWC src and (...,3) flow, got {tuple(src.shape)}, {tuple(flow.shape)}"
        )
    if src.shape[0] != flow.shape[0]:
        raise ValueError(f"warp: batch mismatch {src.shape[0]} vs {flow.shape[0]}")


def rescale_factors(src_spatial, flow_spatial):
    """Per-axis (S-1)/(F-1) factors, or None when the shapes agree."""
    if tuple(src_spatial) == tuple(flow_spatial):
        return None
    return tuple((s - 1) / max(f - 1, 1) for s, f in zip(src_spatial, flow_spatial))


def warp(src: torch.Tensor, flow: torch.Tensor, mode: str = "bilinear",
         kernels: bool = True) -> torch.Tensor:
    """Warp ``src`` by dense displacement ``flow`` (voxel units, channels-last).

    ``kernels`` (the model's kernel switch) True sends the bilinear warp
    through the Hopper kernel wrapper (`kernels/warp3d.py`: K2, and its
    adjoint K5 under autograd, for CUDA tensors; the plain version for CPU
    tensors), the port's counterpart of JAX's kernel F entries
    ("pallas", "guarded"): K2 has no window and is exact for every flow, so
    it equals JAX "guarded" everywhere. False runs `_warp_simple`. At a NaN
    or infinite flow both give zeros, a zero flow gradient and no source
    gradient (`guard_non_finite`), as JAX "packed" (its default) does.
    Nearest mode (segmentations) always runs `_warp_simple`: the JAX
    package has no kernel for it either.
    """
    check_warp_args(src, flow)
    if mode == "bilinear" and kernels:
        from smilecode_tpu_torch.kernels.warp3d import warp3d_trilinear

        return warp3d_trilinear(src.contiguous(), flow.contiguous())
    return _warp_simple(src, flow, mode)


def guard_non_finite(coords: torch.Tensor) -> torch.Tensor:
    """``coords`` (..., 3) with each row that has a NaN or infinite axis
    moved to (-2, -2, -2), where every trilinear corner is outside the
    volume. Such a voxel samples zeros, as before, and now also gets a zero
    flow gradient and adds nothing to the source's: the gradients of JAX's
    default `ops.warp` (the packed warp, `smilecode_tpu/ops/warp.py:67`) and
    of K5. Without the guard, autograd multiplies the masked corners' zero
    gradient by NaN weights (JAX `_warp_simple`'s pattern). Finite rows are
    returned unchanged."""
    bad = ~torch.isfinite(coords).all(dim=-1, keepdim=True)
    return torch.where(bad, torch.full((), -2.0, dtype=coords.dtype, device=coords.device), coords)


def _warp_simple(src: torch.Tensor, flow: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """Plain per-corner gather (the kernel's oracle; nearest mode)."""
    check_warp_args(src, flow)
    b = src.shape[0]
    fd, fh, fw = flow.shape[1:4]
    compute_dtype = torch.promote_types(flow.dtype, torch.float32)
    coords = base_grid(fd, fh, fw, compute_dtype, flow.device) + flow.to(compute_dtype)
    scale = rescale_factors(src.shape[1:4], (fd, fh, fw))
    if scale is not None:
        coords = coords * torch.tensor(scale, dtype=compute_dtype, device=flow.device)
    return warp_coords(src, coords.reshape(b, fd * fh * fw, 3), (fd, fh, fw), mode)


def warp_coords(src: torch.Tensor, coords: torch.Tensor, out_spatial,
                mode: str = "bilinear") -> torch.Tensor:
    """Sample ``src`` at ABSOLUTE voxel coordinates (B, N, 3) -> out_spatial.

    Corner order, weights and their summation order follow
    `smilecode_tpu/ops/warp.py:warp_coords`. A bilinear warp of a bf16
    source weights and sums in float32 and returns bf16; under autograd its
    source gradient is then summed in float32 and cast once, as K5 sums it."""
    b, sd, sh, sw, c = src.shape
    fd, fh, fw = out_spatial
    n = fd * fh * fw
    compute_dtype = torch.promote_types(coords.dtype, torch.float32)
    coords = coords.to(compute_dtype)
    src_flat = src.reshape(b, sd * sh * sw, c)
    sizes = torch.tensor([sd, sh, sw], dtype=compute_dtype, device=src.device)
    bidx = torch.arange(b, device=src.device)[:, None]

    def gather(table, idx):
        """Rows of ``table`` (B, DHW, C) at integer (B, N, 3) ``idx``;
        out-of-volume rows read voxel 0 and are masked by the caller (NaN
        coordinates included)."""
        inb = ((idx >= 0) & (idx <= sizes - 1)).all(dim=-1)
        idxi = torch.where(inb[..., None], idx, torch.zeros((), dtype=idx.dtype,
                                                            device=idx.device)).long()
        lin = (idxi[..., 0] * sh + idxi[..., 1]) * sw + idxi[..., 2]
        return table[bidx, lin], inb

    if mode == "nearest":
        # torch.round rounds half to even, as jnp.rint and grid_sample do
        vals, inb = gather(src_flat, torch.round(coords))
        out = torch.where(inb[..., None], vals, torch.zeros((), dtype=src.dtype,
                                                            device=src.device))
        return out.reshape(b, fd, fh, fw, c)

    if mode != "bilinear":
        raise ValueError(f"unsupported mode {mode!r}")

    coords = guard_non_finite(coords)
    c0 = torch.floor(coords)
    t = coords - c0
    table = src_flat.to(compute_dtype)
    out = torch.zeros((b, n, c), dtype=compute_dtype, device=src.device)
    for od in (0, 1):
        for oh in (0, 1):
            for ow in (0, 1):
                off = torch.tensor([od, oh, ow], dtype=compute_dtype, device=src.device)
                vals, inb = gather(table, c0 + off)
                wgt = (
                    (t[..., 0] if od else 1.0 - t[..., 0])
                    * (t[..., 1] if oh else 1.0 - t[..., 1])
                    * (t[..., 2] if ow else 1.0 - t[..., 2])
                )
                wgt = torch.where(inb, wgt, torch.zeros((), dtype=compute_dtype,
                                                        device=src.device))
                out = out + wgt[..., None] * vals
    return out.reshape(b, fd, fh, fw, c).to(src.dtype)
