"""Extended losses of the RCN/RDN baselines, PyTorch, channels-last.

Counterpart of `smilecode_tpu/losses/extended.py`, with its names, its
layout ((B, D, H, W, C) volumes, (B, H, W, C) images) and its arithmetic:
SSIM 2D/3D (Gaussian window, sigma 1.5, width 11), `grad2d`, the isotropic
TV `grad3d_itv`, `displacement_regularizer` (central-difference gradient
l1/l2 and bending energy), the MIND-SSC descriptor and its MSE, and the
Parzen-window mutual information, global and per patch. The JAX package
has no Pallas kernel for any of them, so plain PyTorch is the port.

Where the JAX function has a tie, the port takes JAX's derivative there:
`abs_` is +1 at 0 (``jnp.abs``), `_clip` splits the gradient at a bound
between the value and the bound (``jnp.clip`` is a ``maximum`` then a
``minimum``; ``torch.clamp`` gives the value all of it) and MIND's channel
minimum is ``torch.amin``, which splits it among tied channels as
``jnp.min`` does (``torch.min(dim)`` gives it to one).

The SSIM window and MIND's box mean are weighted sums of shifted slices,
not cuDNN convolutions, so no TF32 setting can change their float32
result. The Parzen histograms are batched matrix products (``torch.bmm``),
float32 unless ``torch.backends.cuda.matmul.allow_tf32`` is set.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from smilecode_tpu_torch.losses.core import abs_


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, whose gradient at a
    bound is split between ``x`` and the bound."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


# ---------------------------------------------------------------- SSIM

def gaussian_window(window_size: int, sigma: float = 1.5) -> np.ndarray:
    g = np.array(
        [math.exp(-((x - window_size // 2) ** 2) / (2 * sigma ** 2)) for x in range(window_size)],
        np.float32,
    )
    return g / g.sum()


def _sep_conv(x: torch.Tensor, kernel1d: np.ndarray, axes) -> torch.Tensor:
    """Depthwise separable convolution with zero padding win//2 along each
    of ``axes``: the taps' weighted sum of shifted slices, tap by tap (the
    JAX package's ``conv_general_dilated`` with ``feature_group_count=C``)."""
    win = len(kernel1d)
    pad = win // 2
    taps = [float(t) for t in np.asarray(kernel1d, np.float32)]
    for axis in axes:
        pads = [0, 0] * (x.ndim - 1 - axis) + [pad, pad]  # F.pad lists the last axis first
        xp = F.pad(x, pads)
        size = x.shape[axis]
        out = xp.narrow(axis, 0, size) * taps[0]
        for o in range(1, win):
            out = out + xp.narrow(axis, o, size) * taps[o]
        x = out
    return x


def _ssim_map(img1, img2, window_size):
    g = gaussian_window(window_size)
    axes = tuple(range(1, img1.ndim - 1))
    conv = lambda x: _sep_conv(x, g, axes)  # noqa: E731
    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )


def ssim2d(img1, img2, window_size: int = 11):
    """Mean SSIM over (B, H, W, C) images (reference `ssim`)."""
    return torch.mean(_ssim_map(img1, img2, window_size))


def ssim3d(img1, img2, window_size: int = 11):
    """Mean SSIM over (B, D, H, W, C) volumes (reference `ssim3D`)."""
    return torch.mean(_ssim_map(img1, img2, window_size))


def ssim3d_loss(img1, img2, window_size: int = 11):
    """1 - SSIM (the reference SSIM3D module's return)."""
    return 1.0 - ssim3d(img1, img2, window_size)


# ---------------------------------------------------------- gradients / TV

def grad2d(flow, penalty: str = "l1", loss_mult=None):
    """2D Grad loss over (B, H, W, C); any penalty but "l2" is l1, as in
    the JAX package."""
    dy = abs_(flow[:, 1:] - flow[:, :-1])
    dx = abs_(flow[:, :, 1:] - flow[:, :, :-1])
    if penalty == "l2":
        dy, dx = dy * dy, dx * dx
    g = (torch.mean(dx) + torch.mean(dy)) / 2.0
    if loss_mult is not None:
        g = g * loss_mult
    return g


def grad3d_itv(flow):
    """Isotropic total variation (`Grad3DiTV`), flow (B, D, H, W, C)."""
    dy = flow[:, 1:, 1:, 1:] - flow[:, :-1, 1:, 1:]
    dx = flow[:, 1:, 1:, 1:] - flow[:, 1:, :-1, 1:]
    dz = flow[:, 1:, 1:, 1:] - flow[:, 1:, 1:, :-1]
    return torch.mean(torch.sqrt(dx * dx + dy * dy + dz * dz + 1e-6)) / 3.0


def _grad_c(fv, axis):
    """Central difference on the interior of (B, D, H, W), along ``axis``
    (0..2), every axis cropped by one (DisplacementRegularizer)."""
    up = [slice(1, -1)] * 3
    dn = [slice(1, -1)] * 3
    up[axis] = slice(2, None)
    dn[axis] = slice(0, -2)
    return (fv[(slice(None), *up)] - fv[(slice(None), *dn)]) / 2


def displacement_regularizer(disp, energy_type: str = "bending"):
    """`DisplacementRegularizer` parity; disp (B, D, H, W, 3) channels-last:
    the mean over the stacked per-component central-difference energies
    (`smilecode_tpu/losses/extended.py:displacement_regularizer`)."""
    comps = [disp[..., i] for i in range(disp.shape[-1])]  # (B, D, H, W) each
    dtdx = [_grad_c(f, 0) for f in comps]
    dtdy = [_grad_c(f, 1) for f in comps]
    dtdz = [_grad_c(f, 2) for f in comps]

    def stack_mean(fn):
        return torch.mean(torch.stack([fn(a, b, c) for a, b, c in zip(dtdx, dtdy, dtdz)]))

    if energy_type == "gradient-l2":
        return stack_mean(lambda x, y, z: x ** 2 + y ** 2 + z ** 2) / 3.0
    if energy_type == "gradient-l1":
        return stack_mean(lambda x, y, z: abs_(x) + abs_(y) + abs_(z)) / 3.0
    if energy_type == "bending":
        dxx = [_grad_c(f, 0) for f in dtdx]
        dyy = [_grad_c(f, 1) for f in dtdy]
        dzz = [_grad_c(f, 2) for f in dtdz]
        dxy = [_grad_c(f, 1) for f in dtdx]
        dyz = [_grad_c(f, 2) for f in dtdy]
        dxz = [_grad_c(f, 2) for f in dtdx]
        return torch.mean(torch.stack([
            a ** 2 + b ** 2 + c ** 2 + 2 * d ** 2 + 2 * e ** 2 + 2 * f ** 2
            for a, b, c, d, e, f in zip(dxx, dyy, dzz, dxy, dxz, dyz)
        ]))
    raise ValueError(f"Not recognised local regulariser: {energy_type}")


# ---------------------------------------------------------------- MIND-SSC

_SIX_NEIGH = np.array(
    [[0, 1, 1], [1, 1, 0], [1, 0, 1], [1, 1, 2], [2, 1, 1], [1, 2, 1]], np.int64
)
# the descriptor's channel order (`smilecode_tpu/losses/extended.py:mind_ssc`)
_MIND_PERM = (6, 8, 1, 11, 2, 10, 0, 7, 9, 4, 5, 3)


def _mind_shift_pairs():
    """The 12 pairs of the six-neighbourhood at squared distance 2."""
    sn = _SIX_NEIGH
    d2 = ((sn[:, None, :] - sn[None, :, :]) ** 2).sum(-1)
    x, y = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")
    mask = (x > y).reshape(-1) & (d2 == 2).reshape(-1)
    idx1 = np.repeat(sn[:, None, :], 6, 1).reshape(-1, 3)[mask]
    idx2 = np.repeat(sn[None, :, :], 6, 0).reshape(-1, 3)[mask]
    return idx1, idx2


def _rep_pad(x, p):
    """Edge padding of ``p`` on D, H and W of (B, D, H, W, C)."""
    xp = F.pad(x.permute(0, 4, 1, 2, 3), (p,) * 6, mode="replicate")
    return xp.permute(0, 2, 3, 4, 1)


def _shift3d(xp, offs, size):
    (od, oh, ow), (d, h, w) = offs, size
    return xp[:, od:od + d, oh:oh + h, ow:ow + w, :]


def mind_ssc(img, radius: int = 2, dilation: int = 2):
    """MIND-SSC descriptor, (B, D, H, W, 1) -> (B, D, H, W, 12).

    The (2·radius+1)³ box mean over the edge-padded squared differences is
    summed one axis at a time (edge padding clamps each axis on its own, so
    the terms are the JAX package's 125 shifted slices, added in another
    order: the two agree to float32 rounding)."""
    _, d, h, w, _ = img.shape
    kernel_size = radius * 2 + 1
    idx1, idx2 = _mind_shift_pairs()
    xp = _rep_pad(img, dilation)
    diffs = []
    for i in range(12):
        s1 = _shift3d(xp, tuple(int(o) * dilation for o in idx1[i]), (d, h, w))
        s2 = _shift3d(xp, tuple(int(o) * dilation for o in idx2[i]), (d, h, w))
        diffs.append((s1 - s2) ** 2)
    ssd = _rep_pad(torch.cat(diffs, dim=-1), radius)  # (B, D+2r, H+2r, W+2r, 12)
    for axis, size in zip((1, 2, 3), (d, h, w)):
        out = ssd.narrow(axis, 0, size)
        for o in range(1, kernel_size):
            out = out + ssd.narrow(axis, o, size)
        ssd = out
    ssd = ssd / (kernel_size ** 3)
    mind = ssd - torch.amin(ssd, dim=-1, keepdim=True)
    mind_var = torch.mean(mind, dim=-1, keepdim=True)
    mv_mean = torch.mean(mind_var)
    mind_var = _clip(mind_var, mv_mean * 0.001, mv_mean * 1000)
    mind = torch.exp(-mind / mind_var)
    return mind[..., list(_MIND_PERM)]


def mind_loss(y_pred, y_true):
    """MSE between MIND-SSC descriptors (`MIND_loss`)."""
    return torch.mean((mind_ssc(y_pred) - mind_ssc(y_true)) ** 2)


# ---------------------------------------------------- mutual information

def _parzen(x, vbc, preterm):
    """Normalised Parzen weights of (N', n, 1) values on the bin centres."""
    w = torch.exp(-preterm * (x - vbc) ** 2)
    return w / torch.sum(w, dim=-1, keepdim=True)


def _mi(i_a, i_b, n):
    """-mean MI of the joint histograms of Parzen weights (N', n, bins)."""
    pab = torch.bmm(i_a.transpose(1, 2), i_b) / n
    pa = torch.mean(i_a, dim=1, keepdim=True)
    pb = torch.mean(i_b, dim=1, keepdim=True)
    papb = torch.bmm(pa.transpose(1, 2), pb) + 1e-6
    mi = torch.sum(pab * torch.log(pab / papb + 1e-6), dim=(1, 2))
    return -torch.mean(mi)


def _bins(minval, maxval, num_bin, sigma_ratio, like):
    """Bin centres (rounded to float32 as in JAX, then ``like``'s dtype)
    and the Parzen exponent's factor."""
    bin_centers = np.linspace(minval, maxval, num_bin)
    sigma = np.mean(np.diff(bin_centers)) * sigma_ratio
    preterm = float(1.0 / (2 * sigma ** 2))
    vbc = torch.as_tensor(bin_centers.astype(np.float32), device=like.device)
    return vbc.to(like.dtype).reshape(1, 1, num_bin), preterm


def mutual_information(
    y_true, y_pred, sigma_ratio: float = 1.0, minval: float = 0.0,
    maxval: float = 1.0, num_bin: int = 32,
):
    """Global Parzen-window MI loss (returns -MI, `MutualInformation`)."""
    vbc, preterm = _bins(minval, maxval, num_bin, sigma_ratio, y_pred)
    yt = _clip(y_true, minval, maxval).reshape(y_true.shape[0], -1, 1)
    yp = _clip(y_pred, minval, maxval).reshape(y_pred.shape[0], -1, 1)
    return _mi(_parzen(yt, vbc, preterm), _parzen(yp, vbc, preterm), yp.shape[1])


def local_mutual_information(
    y_true, y_pred, sigma_ratio: float = 1.0, minval: float = 0.0,
    maxval: float = 1.0, num_bin: int = 32, patch_size: int = 5,
):
    """Patch-wise (non-overlapping) MI loss (`localMutualInformation`): each
    axis zero-padded to a multiple of ``patch_size``, split as evenly as
    the JAX package splits it."""
    vbc, preterm = _bins(minval, maxval, num_bin, sigma_ratio, y_pred)
    ps = patch_size
    yt = _clip(y_true, minval, maxval)
    yp = _clip(y_pred, minval, maxval)
    b, d, h, w, c = yt.shape
    dr, hr, wr = (-d) % ps, (-h) % ps, (-w) % ps
    pads = (0, 0, wr // 2, wr - wr // 2, hr // 2, hr - hr // 2, dr // 2, dr - dr // 2)
    yt, yp = F.pad(yt, pads), F.pad(yp, pads)

    def to_patches(x):
        dd, hh, ww = d + dr, h + hr, w + wr
        x = x.permute(0, 4, 1, 2, 3)  # channel-first like the reference
        x = x.reshape(b, c, dd // ps, ps, hh // ps, ps, ww // ps, ps)
        x = x.permute(0, 1, 2, 4, 6, 3, 5, 7)
        return x.reshape(-1, ps ** 3, 1)

    i_a = _parzen(to_patches(yt), vbc, preterm)
    i_b = _parzen(to_patches(yp), vbc, preterm)
    return _mi(i_a, i_b, ps ** 3)
