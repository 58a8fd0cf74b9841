"""Hopper kernels K1, K3, K4: fused 3x3x3 neighborhood attention, forward
and backward.

* K1 (`csrc/modet_attn.cu`) replaces `smilecode_tpu/kernels/modet_attn.py:_attn_kernel`
  (entries `modet_attention_pallas` and `modet_attention_planes`).
* K3 and K4 (`csrc/modet_attn_bwd.cu`) replace `_bwd1_kernel` and `_bwd2_kernel`
  (driven by `_backward_planes`): K3 recomputes the softmax and writes dq, the
  27 d_logits of each (voxel, head) and per-block drpb partials; K4 gathers
  dk over the inverse window.

The sources say what bounds each kernel on the H100 and what its design does
about that.

`modet_attention` runs the plain version (`modet_attention_plain`, the
oracle in `ops/attention.py`, differentiated by torch autograd) for CPU
tensors. For CUDA tensors it goes through `ModetAttentionFunction`, whose
forward launches K1 and whose backward launches K3 and K4. It never falls
back from the card to the plain version: a tensor it does not take, or a
failed build or launch, raises. `modet_attention_bwd_plain` writes the
backward out explicitly; it is the backward kernels' oracle on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from smilecode_tpu_torch.kernels import _build
from smilecode_tpu_torch.ops.attention import _neighborhood_attention_plain, offset_grid

MAX_HEAD_DIM = 32  # largest template instance in csrc/modet_attn*.cu
BLOCK_ROWS = 256  # (voxel, head) rows per K3 block, kThreads in csrc/modet_attn_bwd.cu

_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_void_p]
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_void_p]
_DK_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_void_p]


def modet_attention_plain(q, k, rpb, scale: float) -> torch.Tensor:
    """The kernel's plain PyTorch version (same contract as `modet_attention`)."""
    return _neighborhood_attention_plain(q, k, rpb, scale, 3)


def _check(q, k, rpb, what: str):
    """Shape checks; returns True for all-CPU tensors (the plain version)."""
    if q.ndim != 6 or q.shape != k.shape:
        raise ValueError(f"q, k must be equal (B,D,H,W,heads,hd), got {tuple(q.shape)}, {tuple(k.shape)}")
    heads = q.shape[4]
    if rpb is not None and tuple(rpb.shape) != (heads, 3, 3, 3):
        raise ValueError(f"rpb must be ({heads}, 3, 3, 3), got {tuple(rpb.shape)}")
    tensors = [q, k] + ([rpb] if rpb is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in tensors]}; "
                         "the kernel takes all on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what}: the kernel takes float32 only "
                        f"(got {[t.dtype for t in tensors]}); bf16 I/O is not ported yet")
    if not (q.is_contiguous() and k.is_contiguous()):
        raise ValueError(f"{what}: q and k must be contiguous")
    if q.shape[5] > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head_dim {q.shape[5]} > {MAX_HEAD_DIM}")
    return False


def _rpb_flat(rpb):
    return rpb.contiguous().reshape(rpb.shape[0], 27) if rpb is not None else None


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch_fwd(q, k, rpb, scale: float) -> torch.Tensor:
    """K1: (B, D, H, W, heads*3) float32."""
    b, d, h, w, heads, hd = q.shape
    out = torch.empty((b, d, h, w, heads * 3), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    rpb_flat = _rpb_flat(rpb)
    fn = _build.function("smilecode_modet_attn_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), _ptr(rpb_flat), out.data_ptr(),
                  b, d, h, w, heads, hd, float(scale), stream)
    _build.check(code, "modet_attn_fwd launch")
    modet_attention.launches += 1
    return out


def modet_attention_bwd_dq(q, k, rpb, scale: float, g):
    """K3 on CUDA tensors: (dq, dl, drpb_partials or None).

    dl is (B, D, H, W, heads, 27) float32, K4's input; the partials are
    (blocks, heads, 27), summed by the caller. Adds one to
    ``modet_attention_bwd_dq.launches`` per launch."""
    b, d, h, w, heads, hd = q.shape
    dq = torch.empty_like(q)
    dl = torch.empty((b, d, h, w, heads, 27), dtype=torch.float32, device=q.device)
    rows = b * d * h * w * heads
    blocks = (rows + BLOCK_ROWS - 1) // BLOCK_ROWS
    part = (torch.empty((blocks, heads, 27), dtype=torch.float32, device=q.device)
            if rpb is not None else None)
    if dq.numel() == 0:
        return dq, dl, part
    rpb_flat = _rpb_flat(rpb)
    fn = _build.function("smilecode_modet_attn_bwd_dq", _DQ_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), _ptr(rpb_flat), g.data_ptr(), dq.data_ptr(),
                  dl.data_ptr(), _ptr(part), b, d, h, w, heads, hd, float(scale), stream)
    _build.check(code, "modet_attn_bwd_dq launch")
    modet_attention_bwd_dq.launches += 1
    return dq, dl, part


def modet_attention_bwd_dk(q, dl, scale: float):
    """K4 on CUDA tensors: dk (B, D, H, W, heads, hd) from K3's dl and the
    unscaled q. Adds one to ``modet_attention_bwd_dk.launches`` per launch."""
    b, d, h, w, heads, hd = q.shape
    dk = torch.empty_like(q)
    if dk.numel() == 0:
        return dk
    fn = _build.function("smilecode_modet_attn_bwd_dk", _DK_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), dl.data_ptr(), dk.data_ptr(), b, d, h, w, heads, hd,
                  float(scale), stream)
    _build.check(code, "modet_attn_bwd_dk launch")
    modet_attention_bwd_dk.launches += 1
    return dk


_WINDOWS = [(od, oh, ow) for od in range(3) for oh in range(3) for ow in range(3)]


def modet_attention_bwd_dq_plain(q, k, rpb, scale: float, g):
    """K3's plain version: (dq, dl, drpb or None) for the output cotangent
    ``g`` (B, D, H, W, heads*3), written out (no autograd):

    da_t = o_t . g,  dl_t = p_t (da_t - sum_u p_u da_u),
    dq[x] = scale sum_t dl_t[x] k[x + o_t],  drpb[head, t] = sum_x dl_t[x].

    An out-of-volume neighbour keeps its dl_t in drpb but gives nothing to
    dq (the zero-padded key border)."""
    b, d, h, w, heads, hd = q.shape
    kp = F.pad(k, (0, 0, 0, 0, 1, 1, 1, 1, 1, 1))
    qs = q * torch.as_tensor(scale, dtype=q.dtype)
    logits = torch.stack([(qs * kp[:, od:od + d, oh:oh + h, ow:ow + w]).sum(-1)
                          for od, oh, ow in _WINDOWS], dim=-1)  # (B, D, H, W, heads, 27)
    if rpb is not None:
        logits = logits + rpb.reshape(heads, 27).to(logits.dtype)
    p = torch.softmax(logits, dim=-1)
    offs = torch.as_tensor(offset_grid(3), device=q.device).to(p.dtype)  # (27, 3)
    g = g.reshape(b, d, h, w, heads, 3).to(p.dtype)
    da = g[..., 0:1] * offs[:, 0] + g[..., 1:2] * offs[:, 1] + g[..., 2:3] * offs[:, 2]
    dl = p * (da - (p * da).sum(-1, keepdim=True))
    dq = torch.zeros_like(qs)
    for t, (od, oh, ow) in enumerate(_WINDOWS):
        dq += dl[..., t:t + 1] * kp[:, od:od + d, oh:oh + h, ow:ow + w]
    drpb = dl.sum(dim=(0, 1, 2, 3)).reshape(heads, 3, 3, 3) if rpb is not None else None
    return dq * scale, dl, drpb


def modet_attention_bwd_dk_plain(q, dl, scale: float):
    """K4's plain version: dk[x] = scale sum_t dl_t[x - o_t] q[x - o_t], over
    in-volume sources x - o_t only."""
    b, d, h, w, heads, hd = q.shape
    dkp = torch.zeros((b, d + 2, h + 2, w + 2, heads, hd), dtype=q.dtype, device=q.device)
    for t, (od, oh, ow) in enumerate(_WINDOWS):
        dkp[:, od:od + d, oh:oh + h, ow:ow + w] += dl[..., t:t + 1] * q
    return dkp[:, 1:-1, 1:-1, 1:-1] * scale


def modet_attention_bwd_plain(q, k, rpb, scale: float, g):
    """Backward of the attention for the output cotangent ``g``, written out
    as K3 and K4 compute it. Returns (dq, dk, drpb or None)."""
    dq, dl, drpb = modet_attention_bwd_dq_plain(q, k, rpb, scale, g)
    return dq, modet_attention_bwd_dk_plain(q, dl, scale), drpb


def modet_attention_bwd(q, k, rpb, scale: float, g):
    """(dq, dk, drpb or None) for the output cotangent ``g``: K3 then K4 for
    CUDA tensors, `modet_attention_bwd_plain` for CPU tensors."""
    if _check(q, k, rpb, "modet_attention_bwd"):
        return modet_attention_bwd_plain(q, k, rpb, scale, g)
    b, d, h, w, heads, _ = q.shape
    if tuple(g.shape) != (b, d, h, w, heads * 3) or g.device != q.device:
        raise ValueError(f"modet_attention_bwd: g must be {(b, d, h, w, heads * 3)} on "
                         f"{q.device}, got {tuple(g.shape)} on {g.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"modet_attention_bwd: g must be float32, got {g.dtype}")
    dq, dl, part = modet_attention_bwd_dq(q, k, rpb, scale, g.contiguous())
    dk = modet_attention_bwd_dk(q, dl, scale)
    # the partials are summed outside the kernel, as the JAX package does
    drpb = part.sum(dim=0).reshape(heads, 3, 3, 3) if part is not None else None
    return dq, dk, drpb


class ModetAttentionFunction(torch.autograd.Function):
    """K1 forward, K3 + K4 backward (CUDA tensors)."""

    @staticmethod
    def forward(ctx, q, k, rpb, scale):
        ctx.save_for_backward(q, k, rpb)
        ctx.scale = scale
        return _launch_fwd(q, k, rpb, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, rpb = ctx.saved_tensors
        dq, dk, drpb = modet_attention_bwd(q, k, rpb, ctx.scale, g)
        return dq, dk, drpb, None


def modet_attention(q: torch.Tensor, k: torch.Tensor, rpb: torch.Tensor | None,
                    scale: float = 1.0) -> torch.Tensor:
    """q, k: (B, D, H, W, heads, head_dim); rpb: (heads, 3, 3, 3) or None.

    Returns (B, D, H, W, heads*3) float32, differentiable in q, k and rpb.
    Adds one to ``modet_attention.launches`` per K1 launch.
    """
    if _check(q, k, rpb, "modet_attention"):
        return modet_attention_plain(q, k, rpb, scale)
    return ModetAttentionFunction.apply(q, k, rpb, scale)


modet_attention.launches = 0
modet_attention_bwd_dq.launches = 0
modet_attention_bwd_dk.launches = 0
