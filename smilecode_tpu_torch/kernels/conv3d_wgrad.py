"""Hopper kernel K6: the weight and bias gradient of a 3x3x3, stride-1,
padding-1 convolution in float32.

K6 (`csrc/conv3d_wgrad.cu`) replaces no TPU kernel: the JAX package leaves
its convolutions and their gradients to XLA. It takes the weight gradient
from cuDNN, whose kernel for the port's channels-last activations and small
channel counts leaves the card nearly idle; the forward and the input
gradient stay on cuDNN. The source says what bounds it and what its design
does about that.

`conv3d_wgrad` runs the plain version (`conv3d_wgrad_plain`) for CPU tensors
and K6 for CUDA tensors, with no fallback from the card. It counts its
launches in ``conv3d_wgrad.launches``; ``conv3d_wgrad.declined`` counts the
float32 CUDA weight gradients that `wgrad_route` sent to cuDNN because of
their shape, so the two give the share of such gradients that K6 takes
(`chip_smoke.py` holds both to each model's count a training step).

`wgrad_route` is the rule that `ops/blocks.py:conv3d_ndhwc` applies to
every convolution it runs, each Conv3d child of a Sequential included: what
the call can observe (the module's type and geometry, the activation's
dtype, device and voxel count, whether a weight gradient is wanted) and the
model's kernel switch decide; a model on the plain path (attn_impl "plain")
runs no hand-written kernel, K6 included (`ops.blocks.mark_model_` sets
its convs' ``kernels`` False). `Conv3dWgradFunction` is the path K6 takes:
the forward is the module's own ``F.conv3d`` call, the backward takes dx
from cuDNN (``aten.convolution_backward`` with only the input's output
mask) and dW, db from K6.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import nn

from smilecode_tpu_torch.kernels import _build
from smilecode_tpu_torch.utils.profiling import span

MAX_CHANNELS = 128  # the largest input and output channel counts the rule sends to K6
# Where both channel counts exceed WIDE_CHANNELS and the convolution runs over
# WIDE_VOXELS voxels or more, cuDNN's weight gradient is as fast as K6 or
# faster (chip_smoke.py phase 33: PR++'s 91 -> 91 and RDN's 128 -> 128 at
# 20x24x20), so the rule declines it; smaller volumes stay on K6 (ModeT's
# 128 -> 128 at 10x12x10)
WIDE_CHANNELS, WIDE_VOXELS = 64, 4096

_PLAN_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_void_p]
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]

_plans: dict = {}  # (device, B, D, H, W, Cin, Cout) -> (BD, BH, BW, P, workspace floats)


def wgrad_route(conv: nn.Module, dtype: torch.dtype, device_type: str, grad_mode: bool,
                voxels: int = 0):
    """Where the weight gradient of ``conv`` applied to an activation of
    ``dtype`` with ``voxels`` voxels (B D H W) on ``device_type`` under
    ``grad_mode`` goes: "K6"; "declined", a float32 ``nn.Conv3d`` of a
    kernel model on the card whose weight gradient is wanted, but of a
    geometry or channel count K6 does not take, or wider than
    WIDE_CHANNELS on both sides over WIDE_VOXELS voxels or more;
    None, today's path (no weight gradient wanted, the CPU, another dtype,
    not an ``nn.Conv3d`` (`ops.blocks.conv3d_ndhwc` asks for each child of
    a Sequential), or a conv of a model on the plain path: its ``kernels``
    False; a conv never marked counts as on)."""
    if (not grad_mode or type(conv) is not nn.Conv3d or device_type != "cuda"
            or not conv.weight.requires_grad or dtype != torch.float32
            or conv.weight.dtype != torch.float32 or not getattr(conv, "kernels", True)):
        return None
    if (conv.kernel_size == (3, 3, 3) and conv.stride == (1, 1, 1) and conv.padding == (1, 1, 1)
            and conv.dilation == (1, 1, 1) and conv.groups == 1 and conv.padding_mode == "zeros"
            and conv.in_channels <= MAX_CHANNELS and conv.out_channels <= MAX_CHANNELS
            and not (min(conv.in_channels, conv.out_channels) > WIDE_CHANNELS
                     and voxels >= WIDE_VOXELS)):
        return "K6"
    return "declined"


def conv3d_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, want_bias: bool = True):
    """K6's plain PyTorch version: (dW (Cout, Cin, 3, 3, 3), db (Cout) or
    None) of a 3x3x3, stride-1, padding-1 convolution, from x (B, D, H, W,
    Cin) and the output cotangent dy (B, D, H, W, Cout), in their dtype:
    dW[co, ci, kd, kh, kw] = sum over voxels of dy[v, co] x[v + k - 1, ci],
    x zero outside the volume; db = the sum of dy over voxels."""
    _check_shapes(x, dy)
    d, h, w, cin = x.shape[1:]
    cout = dy.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    dy2 = dy.reshape(-1, cout).t()
    taps = [dy2 @ xp[:, kd:kd + d, kh:kh + h, kw:kw + w].reshape(-1, cin)
            for kd in range(3) for kh in range(3) for kw in range(3)]
    dw = torch.stack(taps, dim=-1).reshape(cout, cin, 3, 3, 3)
    return dw, dy2.sum(dim=1) if want_bias else None


def _check_shapes(x, dy) -> None:
    if x.dim() != 5 or dy.dim() != 5 or x.shape[:4] != dy.shape[:4]:
        raise ValueError(f"conv3d_wgrad: x (B, D, H, W, Cin) and dy (B, D, H, W, Cout) must share "
                         f"B, D, H, W, got {tuple(x.shape)} and {tuple(dy.shape)}")


def _plan(x, cout: int) -> tuple:
    b, d, h, w, cin = x.shape
    key = (x.device.index, b, d, h, w, cin, cout)
    plan = _plans.get(key)
    if plan is None:
        out = (ctypes.c_longlong * 5)()
        _build.launch("smilecode_conv3d_wgrad_plan", _PLAN_ARGTYPES, x, b, d, h, w, cin, cout,
                      ctypes.addressof(out), what="conv3d_wgrad plan")
        plan = _plans[key] = tuple(out)
    return plan


def conv3d_wgrad(x: torch.Tensor, dy: torch.Tensor, want_bias: bool = True):
    """(dW (Cout, Cin, 3, 3, 3) in channels_last_3d, the port's weight
    layout (`ops.blocks.mark_model_`), db (Cout) or None) of
    a 3x3x3, stride-1, padding-1 convolution from x (B, D, H, W, Cin) and
    the output cotangent dy (B, D, H, W, Cout): K6 for CUDA tensors (float32,
    contiguous), `conv3d_wgrad_plain` for CPU tensors.

    Adds one to ``conv3d_wgrad.launches`` per K6 launch. Span ``kernel.K6``
    (`utils.profiling.span`) from entry to return, the plain version's too,
    while a profiler records.
    """
    with span("kernel.K6"):
        _check_shapes(x, dy)
        if x.device.type == "cpu" and dy.device.type == "cpu":
            dw, db = conv3d_wgrad_plain(x, dy, want_bias)
            return dw.contiguous(memory_format=torch.channels_last_3d), db
        if x.device != dy.device or x.device.type != "cuda":
            raise ValueError(f"conv3d_wgrad: x on {x.device}, dy on {dy.device}; the kernel "
                             "takes both on one CUDA device")
        if x.dtype != torch.float32 or dy.dtype != torch.float32:
            raise TypeError(f"conv3d_wgrad: the kernel takes float32 x and dy, got {x.dtype}, "
                            f"{dy.dtype}")
        if not (x.is_contiguous() and dy.is_contiguous()):
            raise ValueError("conv3d_wgrad: x and dy must be contiguous (B, D, H, W, C)")
        b, d, h, w, cin = x.shape
        cout = dy.shape[-1]
        dw = torch.empty((cout, cin, 3, 3, 3), dtype=torch.float32, device=x.device,
                         memory_format=torch.channels_last_3d)
        db = torch.empty(cout, dtype=torch.float32, device=x.device) if want_bias else None
        if x.numel() == 0 or cout == 0:
            return dw.zero_(), None if db is None else db.zero_()
        # the kernel copies 16-byte vectors: a view at another offset is copied once
        x, dy = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, dy))
        bd, bh, bw, p, ws_floats = _plan(x, cout)
        ws = torch.empty(ws_floats, dtype=torch.float32, device=x.device)
        _build.launch("smilecode_conv3d_wgrad", _ARGTYPES, x, x.data_ptr(), dy.data_ptr(),
                      ws.data_ptr(), dw.data_ptr(), None if db is None else db.data_ptr(),
                      b, d, h, w, cin, cout, bd, bh, bw, p, what="conv3d_wgrad launch")
        _build.count(conv3d_wgrad, x)
        return dw, db


class Conv3dWgradFunction(torch.autograd.Function):
    """A 3x3x3, stride-1, padding-1 ``nn.Conv3d`` on NCDHW-viewed ``xc``:
    the module's ``F.conv3d`` forward; backward dx from cuDNN, dW and db
    from `conv3d_wgrad` (K6 on the card), dW in channels_last_3d (autograd
    copies it into a weight of another layout)."""

    @staticmethod
    def forward(ctx, xc, weight, bias):
        ctx.save_for_backward(xc, weight)
        ctx.has_bias = bias is not None
        return F.conv3d(xc, weight, bias, 1, 1, 1, 1)

    @staticmethod
    def backward(ctx, g):
        xc, weight = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                g, xc, weight, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1,
                [True, False, False])[0]
        if ctx.needs_input_grad[1] or (ctx.has_bias and ctx.needs_input_grad[2]):
            dw, db = conv3d_wgrad(xc.permute(0, 2, 3, 4, 1).contiguous(),
                                  g.permute(0, 2, 3, 4, 1).contiguous(),
                                  ctx.has_bias and ctx.needs_input_grad[2])
        return dx, dw, db


conv3d_wgrad.launches = 0
conv3d_wgrad.declined = 0
