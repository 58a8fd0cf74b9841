"""Hopper kernel K7: PR++'s windowed 3D correlation and its adjoint, float32.

K7 (`csrc/correlation3d.cu`) replaces no TPU kernel: the JAX package
computes the correlation with XLA ops (`smilecode_tpu/models/prnet.py:
correlation3d`). Its plain version here, `correlation3d_plain`, builds the 27
products of the whole feature map and sums each over the channels; K7 reads
each input once and writes each of the 27 sums once, the 3^3 box sums in
shared memory. The source says what bounds it and what its design does
about that.

`correlation3d` is the entry that `models.prnet.PRPlusPlusBlock` calls.
`k7_route` is its rule, on the device and the model's kernel switch alone:
on the card, in a model whose kernel switch is on, every call goes through
`Correlation3dFunction`, whose forward launches K7's forward and whose
backward launches K7's adjoint (d_mov and d_fix, in gather form, no
atomics: two calls give the same bits); a dtype other than float32 or a
width over the kernel's MAX_CHANNELS raises there. Off the card, and in a
plain model, the call takes `correlation3d_plain`, differentiated by torch
autograd; it is also K7's oracle on the card. There is no fallback from the
card. The wrappers count their launches in ``correlation3d.launches`` (one a
forward, one a backward) and open span ``kernel.K7`` from entry to return
while a profiler records.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from smilecode_tpu_torch.kernels import _build
from smilecode_tpu_torch.ops.box import box_sum
from smilecode_tpu_torch.utils.profiling import span

MAX_CHANNELS = 128  # the widest feature map K7 takes (`csrc/correlation3d.cu:valid`)
PAD = 2  # the fixed map's padding: displacements of -2, 0 and 2 voxels per axis

_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def correlation3d_plain(mov, fix, kernel_size: int = 3, d: int = 3, sf: int = 2):
    """Windowed correlation (`smilecode_tpu/models/prnet.py:correlation3d`):
    per-channel 3^3 box sums of both maps (``fix`` zero-padded by 2 first),
    then for each of the d^3 crops of the padded map at offsets ``i * sf``
    the channel sum of its product with the moving map's, divided by
    ``kernel_size**3``: channel 9i + 3j + k pairs the moving map at x with
    the fixed map at x + (2i - 2, 2j - 2, 2k - 2). (B, D, H, W, C) x2 ->
    (B, D, H, W, d^3). Box sums are the NCC loss's shifted-slice adds
    (`ops/box.py:box_sum`), in the JAX package's order."""
    pm = box_sum(mov, kernel_size)
    pf = box_sum(F.pad(fix, (0, 0, PAD, PAD, PAD, PAD, PAD, PAD)), kernel_size)
    _, dd, hh, ww, _ = mov.shape
    chans = []
    for i in range(d):
        for j in range(d):
            for k in range(d):
                crop = pf[:, i * sf:i * sf + dd, j * sf:j * sf + hh, k * sf:k * sf + ww]
                chans.append(torch.sum(pm * crop, dim=-1, keepdim=True))
    return torch.cat(chans, -1) / (kernel_size ** 3)


def k7_route(dtype: torch.dtype, device_type: str, channels: int, kernels: bool = True) -> bool:
    """Whether a correlation of two ``channels``-wide maps of ``dtype`` on
    ``device_type`` goes to K7: on the card in a model whose kernel switch
    (``kernels``) is on. There the maps must be float32 of 1 to
    MAX_CHANNELS channels, else ValueError."""
    if not (kernels and device_type == "cuda"):
        return False
    if dtype != torch.float32 or not 0 < channels <= MAX_CHANNELS:
        raise ValueError(f"correlation3d: K7 takes float32 maps of 1 to {MAX_CHANNELS} channels "
                         f"on the card, got {dtype} with {channels}")
    return True


def _check(mov, fix) -> None:
    if mov.dim() != 5 or mov.shape != fix.shape:
        raise ValueError(f"correlation3d: mov and fix must be (B, D, H, W, C) of one shape, got "
                         f"{tuple(mov.shape)} and {tuple(fix.shape)}")


def _padded(t) -> tuple:
    b, d, h, w, c = t.shape
    return (b, d + 2 * PAD, h + 2 * PAD, w + 2 * PAD, c)


def correlation3d_fwd(mov, fix):
    """K7's forward: (out (B, D, H, W, 27), bm, bfp), bm the box sums of
    ``mov`` (B, D, H, W, C) and bfp those of ``fix`` on its padded volume
    (B, D + 4, H + 4, W + 4, C), which the backward reads. CUDA float32,
    contiguous."""
    with span("kernel.K7"):
        b, d, h, w, c = mov.shape
        out = torch.empty((b, d, h, w, 27), dtype=torch.float32, device=mov.device)
        bm = torch.empty_like(mov)
        bfp = torch.empty(_padded(fix), dtype=torch.float32, device=fix.device)
        if mov.numel():
            _build.launch("smilecode_correlation3d_fwd", _FWD_ARGTYPES, mov, mov.data_ptr(),
                          fix.data_ptr(), bm.data_ptr(), bfp.data_ptr(), out.data_ptr(),
                          b, d, h, w, c, what="correlation3d_fwd launch")
            _build.count(correlation3d, mov)
        return out, bm, bfp


def correlation3d_bwd(g, bm, bfp):
    """K7's adjoint: (d_mov, d_fix) from the output cotangent ``g`` (B, D,
    H, W, 27) and the forward's box sums."""
    with span("kernel.K7"):
        b, d, h, w, c = bm.shape
        g = g.contiguous()
        d_mov, d_fix = torch.empty_like(bm), torch.empty_like(bm)
        dbm, dbfp = torch.empty_like(bm), torch.empty_like(bfp)
        if bm.numel():
            _build.launch("smilecode_correlation3d_bwd", _BWD_ARGTYPES, bm, g.data_ptr(),
                          bm.data_ptr(), bfp.data_ptr(), dbm.data_ptr(), dbfp.data_ptr(),
                          d_mov.data_ptr(), d_fix.data_ptr(), b, d, h, w, c,
                          what="correlation3d_bwd launch")
            _build.count(correlation3d, bm)
        return d_mov, d_fix


class Correlation3dFunction(torch.autograd.Function):
    """`correlation3d` on the card: K7's forward, K7's adjoint backward."""

    @staticmethod
    def forward(ctx, mov, fix):
        out, bm, bfp = correlation3d_fwd(mov, fix)
        ctx.save_for_backward(bm, bfp)
        return out

    @staticmethod
    def backward(ctx, g):
        return correlation3d_bwd(g, *ctx.saved_tensors)


def correlation3d(mov: torch.Tensor, fix: torch.Tensor, kernels: bool = True) -> torch.Tensor:
    """PR++'s windowed correlation of ``mov`` and ``fix`` (B, D, H, W, C) ->
    (B, D, H, W, 27), as `correlation3d_plain`: K7 where `k7_route` sends
    it (``kernels`` is the model's kernel switch), else the plain version."""
    _check(mov, fix)
    if not k7_route(mov.dtype, mov.device.type, mov.shape[-1], kernels):
        with span("kernel.K7"):
            return correlation3d_plain(mov, fix)
    if fix.device != mov.device or fix.dtype != mov.dtype:
        raise ValueError(f"correlation3d: mov {mov.dtype} on {mov.device}, fix {fix.dtype} on "
                         f"{fix.device}; the kernel takes both float32 on one CUDA device")
    mov, fix = mov.contiguous(), fix.contiguous()
    if torch.is_grad_enabled() and (mov.requires_grad or fix.requires_grad):
        return Correlation3dFunction.apply(mov, fix)
    return correlation3d_fwd(mov, fix)[0]


correlation3d.launches = 0
