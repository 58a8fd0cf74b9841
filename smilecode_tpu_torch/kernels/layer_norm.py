"""Hopper kernel K8: LayerNorm over the last axis, float32, forward and backward.

K8 (`csrc/layer_norm.cu`) replaces no TPU kernel: the JAX package leaves
ModeT's `ProjectionLayer` norm to XLA. On the card torch's LayerNorm takes
its per-row path for ModeT's 6-wide rows (six is no multiple of its vector
width), one block a row; K8 stages tiles of consecutive rows through shared
memory with 16-byte loads and gives a thread a row. The source says what
bounds it and what its design does about that.

`layer_norm` is the entry that `ops.blocks.layer_norm` calls for an
activation in its parameters' dtype. `k8_route` is its rule, on the dtype,
the device and the model's kernel switch alone: a float32 activation on the
card, in a model whose kernel switch is on, goes through
`LayerNormFunction`, whose forward launches K8's forward (it saves only the
input) and whose backward launches K8's backward (dz; dgamma and dbeta
summed in a fixed order, no atomics: two calls give the same bits); another
dtype there raises, bfloat16 apart, which `ops.blocks.layer_norm` computes
as the JAX layer's separate ops. Off the card, and in a plain model, the
call takes `layer_norm_plain`, torch's LayerNorm with its own backward; it is
also K8's oracle on the card. There is no fallback from the card. The
wrappers count their launches in ``layer_norm.launches`` (one a forward, one
a backward) and open span ``kernel.K8`` from entry to return while a
profiler records.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from smilecode_tpu_torch.kernels import _build
from smilecode_tpu_torch.utils.profiling import span

MAX_WIDTH = 256  # the widest row K8 takes (`csrc/layer_norm.cu:kMaxN`)
TILE_VALUES, MAX_ROWS = 4096, 512  # a tile's values, about, and its most rows

_FWD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_float, ctypes.c_void_p])


def layer_norm_plain(x, weight, bias, eps: float):
    """``nn.LayerNorm(N, eps)`` over the last axis of ``x`` (N wide) with
    ``weight`` and ``bias``: torch's forward and autograd's backward."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def k8_route(dtype: torch.dtype, device_type: str, kernels: bool = True) -> bool:
    """Whether a LayerNorm of a ``dtype`` activation on ``device_type`` goes to
    K8: float32 on the card in a model whose kernel switch (``kernels``) is
    on. bfloat16 is the separate-op branch of `ops.blocks.layer_norm`; any
    other dtype on the card with the switch on raises ValueError."""
    if not (kernels and device_type == "cuda") or dtype == torch.bfloat16:
        return False
    if dtype != torch.float32:
        raise ValueError(f"layer_norm: K8 takes float32 activations on the card, got {dtype}")
    return True


def tile_rows(n: int) -> int:
    """Rows of a K8 tile for rows ``n`` wide: about TILE_VALUES values, a
    multiple of 32 from 32 to MAX_ROWS (`csrc/layer_norm.cu:valid_rows`)."""
    return min(MAX_ROWS, max(32, TILE_VALUES // n // 32 * 32))


def _check(x, weight, bias) -> None:
    n = x.shape[-1] if x.dim() else 0
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None or t.shape != (n,):
            raise ValueError(f"layer_norm: {name} must be ({n},) for rows {n} wide, got "
                             f"{None if t is None else tuple(t.shape)}")
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"layer_norm: {name} {t.dtype} on {t.device}, x {x.dtype} on "
                             f"{x.device}; K8 takes all three float32 on one CUDA device")
    if not 0 < n <= MAX_WIDTH:
        raise ValueError(f"layer_norm: K8 takes rows 1 to {MAX_WIDTH} wide, got {n}")


def layer_norm_fwd(z, weight, bias, eps: float):
    """K8's forward: y of ``z`` (..., N), contiguous CUDA float32."""
    with span("kernel.K8"):
        n = z.shape[-1]
        y = torch.empty_like(z)
        if z.numel():
            _build.launch("smilecode_layer_norm_fwd", _FWD_ARGTYPES, z, z.data_ptr(),
                          weight.data_ptr(), bias.data_ptr(), y.data_ptr(), z.numel() // n, n,
                          tile_rows(n), eps, what="layer_norm_fwd launch")
            _build.count(layer_norm, z)
        return y


def layer_norm_bwd(dy, z, weight, eps: float):
    """K8's backward: (dz, dweight, dbias) from the output cotangent ``dy``
    and the forward's input ``z`` (..., N)."""
    with span("kernel.K8"):
        n = z.shape[-1]
        dy = dy.contiguous()
        dz = torch.empty_like(z)
        rows = z.numel() // n
        dw, db = ((torch.empty_like if rows else torch.zeros_like)(weight) for _ in range(2))
        if rows:
            t = tile_rows(n)
            part = torch.empty(2 * n * -(-rows // t), dtype=torch.float32, device=z.device)
            _build.launch("smilecode_layer_norm_bwd", _BWD_ARGTYPES, z, dy.data_ptr(),
                          z.data_ptr(), weight.data_ptr(), dz.data_ptr(), part.data_ptr(),
                          dw.data_ptr(), db.data_ptr(), rows, n, t, eps,
                          what="layer_norm_bwd launch")
            _build.count(layer_norm, z)
        return dz, dw, db


class LayerNormFunction(torch.autograd.Function):
    """`layer_norm` on the card: K8's forward, K8's backward."""

    @staticmethod
    def forward(ctx, z, weight, bias, eps):
        ctx.save_for_backward(z, weight)
        ctx.eps = eps
        return layer_norm_fwd(z, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        z, weight = ctx.saved_tensors
        return (*layer_norm_bwd(dy, z, weight, ctx.eps), None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
               kernels: bool = True) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` with ``weight``, ``bias`` and
    ``eps``, as `layer_norm_plain`: K8 where `k8_route` sends it
    (``kernels`` is the model's kernel switch), else the plain version."""
    if not k8_route(x.dtype, x.device.type, kernels):
        return layer_norm_plain(x, weight, bias, eps)
    _check(x, weight, bias)
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return LayerNormFunction.apply(x, weight, bias, eps)
    return layer_norm_fwd(x, weight, bias, eps)


layer_norm.launches = 0
