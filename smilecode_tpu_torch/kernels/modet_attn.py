"""Hopper kernels K1, K3, K4: fused 3x3x3 neighborhood attention, forward
and backward.

* K1 (`csrc/modet_attn.cu`) replaces `smilecode_tpu/kernels/modet_attn.py:_attn_kernel`
  (entries `modet_attention_pallas` and `modet_attention_planes`).
* K3 and K4 (`csrc/modet_attn_bwd.cu`) replace `_bwd1_kernel` and `_bwd2_kernel`
  (driven by `_backward_planes`): K3 recomputes the softmax and writes dq, the
  27 d_logits of each (voxel, head) and per-block drpb partials; K4 gathers
  dk over the inverse window.

The sources say what bounds each kernel on the H100 and what its design does
about that. All three stand on one shared-memory stage (`csrc/attn_tile.cuh`):
a block stages the zero-filled neighbourhood of a brick of voxels in a ring
of d-slices. For K1 and K3 that is k; `attn_geometry` sizes their brick and
grid, and with it the number of K3's drpb partials. K4 stages the dl and q
halo rows of each slice, copied as 16-byte spans (the interior of a row by
one bulk copy of the tensor memory accelerator), in a two-slot ring, and
keeps the dk of three slices in registers so that each staged q row is read
once per slice; `dk_geometry` sizes its brick and grid, and `_check_dk`
checks q and dl before anything is built.

Each kernel has a float32 and a bf16 instance (the bf16 feature path of
ModeT, `compute_dtype="bfloat16"`): q and k both float32 or both bf16, rpb
always float32. The bf16 instances compute in float32 and round only what
they store, where the JAX package rounds (`csrc/io_types.cuh`): K1's output,
K3's dq and its stored dl, K4's dk; drpb stays float32. Each wrapper's
``launches`` counts its launches of both instances, ``launches_bf16`` those
of the bf16 one.

Halo-k mode (``k_halo=True``; the D-sharded training step,
`parallel/modet_sp.py`): k has D+2 slices, its first and last the
neighbour shards' (zeros at the global ends), as JAX's
`modet_attention_planes(k_prepadded_d=True)` (`:109-134`) and
`_backward_planes(k_prepadded_d=True)` (`:367-372`, `:464-465`) take it. K1
and K3 read those slices as k's D border (H and W keep their zero border),
and K4 returns dk for all D+2 slices, so the border slices' cotangents can
travel back to their shards. Each wrapper's ``launches_halo`` counts its
halo-k launches; the plain versions take the same flag.

`modet_attention` runs the plain version (`modet_attention_plain`, the
oracle in `ops/attention.py`, differentiated by torch autograd) for CPU
tensors. For CUDA tensors it goes through `ModetAttentionFunction`, whose
forward launches K1 and whose backward launches K3 and K4; when no gradient
is wanted it launches K1 directly, without the autograd Function's host
time. It never falls back from the card to the plain version: a tensor it
does not take, or a failed build or launch, raises. `modet_attention_bwd_plain` writes the
backward out explicitly; it is the backward kernels' oracle on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from smilecode_tpu_torch.kernels import _build
from smilecode_tpu_torch.ops.attention import _neighborhood_attention_plain, offset_grid
from smilecode_tpu_torch.utils.profiling import span

MAX_HEAD_DIM = 32  # largest template instance in csrc/modet_attn*.cu
# K1/K3 bricks (csrc/attn_tile.cuh): at most ATTN_MAX_BH x ATTN_MAX_BW voxels
# and ATTN_THREADS (voxel, head) rows per slice (kMaxThreads), a k ring of at
# most ATTN_RING_BYTES where the row allows, and D cut into chunks until the
# grid has about ATTN_TARGET_BLOCKS blocks (several per SM on the H100's 132
# even at level 1's single head). The caps are `attn_ab.py --sweep`'s best
# on the H100 at levels 1 and 2 (PERF.md)
ATTN_THREADS = 256
ATTN_MAX_BH, ATTN_MAX_BW = 8, 32
ATTN_RING_BYTES = 64 * 1024
ATTN_TARGET_BLOCKS = 2048
_RING_SLOTS = 4  # kRing
_SMEM_MAX = 232448  # kSmemMax: shared memory a block can use on the H100
# K4's bricks (csrc/modet_attn_bwd.cu): the same rule under caps of its own,
# a two-slot ring of dl and q halo rows within K4_RING_BYTES, and chunks of
# at least K4_MIN_CHUNK slices (a block copies cd + 2 slices for cd of dk);
# the caps are `attn_ab.py --sweep`'s best on the H100 (PERF.md)
K4_MAX_BH, K4_MAX_BW = 8, 32
K4_RING_BYTES = 96 * 1024
K4_TARGET_BLOCKS = 1024
K4_MIN_CHUNK = 2
_K4_SLOTS = 2  # kDkRing

# (bh, bw, cd, unit, koff) after the scale; K4 (bh, bw, cd, koff)
_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
    ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
    ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DK_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
    ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _brick(shape, ring, max_bh, max_bw, ring_bytes, target_blocks, min_cd=1):
    """(bh, bw, cd, blocks) of a brick launch on ``shape`` (B, D, H, W, heads,
    hd), ``ring(bh, bw)`` its ring's bytes: the rule of `attn_geometry`, with
    chunks of at least ``min_cd`` slices where D has them."""
    b, d, h, w, heads, hd = (int(n) for n in shape)
    if heads > ATTN_THREADS:  # one thread per (voxel, head) of a block
        raise ValueError(f"attention kernels take at most {ATTN_THREADS} heads, got {heads}")
    voxels = max(1, ATTN_THREADS // heads)
    bw = max(1, min(max_bw if w % max_bw == 0 else 16, voxels, w))
    bh = max(1, min(voxels // bw, max_bh, h))
    while ring(bh, bw) > ring_bytes and bh > 1:
        bh -= 1
    while ring(bh, bw) > ring_bytes and bw > 1:
        bw -= 1
    if ring(bh, bw) > _SMEM_MAX // 2:
        raise ValueError(f"attention kernels: a voxel row of {heads}x{hd} values is too wide "
                         "for the shared-memory ring")
    cols = b * _cdiv(h, bh) * _cdiv(w, bw)
    chunks = max(1, min(d, _cdiv(target_blocks, max(cols, 1))))
    cd = max(1, min(min_cd, d), _cdiv(d, chunks))
    return bh, bw, cd, cols * _cdiv(d, cd)


def attn_geometry(shape, itemsize: int):
    """(bh, bw, cd, blocks): the brick and grid of K1's and K3's launch for
    q of ``shape`` (B, D, H, W, heads, hd) with ``itemsize``-byte values.

    A block takes bh x bw voxels of (h, w), one thread per (voxel, head), and
    walks cd slices of d; its k ring holds 4 slices of (bh+2) x (bw+2) voxel
    rows of heads*hd values. bh and bw are at most ATTN_MAX_BH and ATTN_MAX_BW
    voxels and bh*bw*heads at most ATTN_THREADS, bw the full cap only where
    it divides W (else at most 16, so that a row of 80 takes 5 bricks, not
    2.5); bh (then bw) shrinks until the ring fits ATTN_RING_BYTES;
    no side exceeds the volume's. D is cut into the fewest chunks that give
    about ATTN_TARGET_BLOCKS blocks. ``blocks`` = B * ceil(H/bh) * ceil(W/bw)
    * ceil(D/cd) is also the number of K3's drpb partials. Pure Python: the
    wrapper and `chip_smoke.attn_work` both use it."""
    row = int(shape[4]) * int(shape[5]) * itemsize

    def ring(bh, bw):
        return _RING_SLOTS * _cdiv((bh + 2) * (bw + 2) * row, 16) * 16

    return _brick(shape, ring, ATTN_MAX_BH, ATTN_MAX_BW, ATTN_RING_BYTES, ATTN_TARGET_BLOCKS)


def span_pitch(bw: int, row_bytes: int) -> int:
    """Bytes of a K4 slot row: a halo span of bw+2 voxel rows at any
    alignment, in 16-byte units (csrc/attn_tile.cuh:span_pitch)."""
    return _cdiv((bw + 2) * row_bytes + 15, 16) * 16


def dk_ring_bytes(bh: int, bw: int, heads: int, hd: int, itemsize: int) -> int:
    """The ring of a K4 block (its shared memory but for two 8-byte
    barriers): two slots of (bh+2) halo rows of dl (heads*27 values a voxel)
    and of q (heads*hd)."""
    return _K4_SLOTS * (bh + 2) * (span_pitch(bw, heads * 27 * itemsize)
                                   + span_pitch(bw, heads * hd * itemsize))


def dk_geometry(shape, itemsize: int):
    """(bh, bw, cd, blocks): the brick and grid of K4's launch, by
    `attn_geometry`'s rule under K4_MAX_BH, K4_MAX_BW, K4_RING_BYTES (its
    ring: `dk_ring_bytes`), K4_TARGET_BLOCKS and K4_MIN_CHUNK. Pure Python:
    the wrapper and `attn_ab.py` use it."""
    heads, hd = int(shape[4]), int(shape[5])
    return _brick(shape, lambda bh, bw: dk_ring_bytes(bh, bw, heads, hd, itemsize),
                  K4_MAX_BH, K4_MAX_BW, K4_RING_BYTES, K4_TARGET_BLOCKS, K4_MIN_CHUNK)


def _copy_unit(row_bytes: int, ptr: int) -> int:
    """Bytes per copy into the k ring: the widest of 16, 8, 4 and 2 that
    divides a voxel row and k's address (csrc/attn_tile.cuh)."""
    return next(u for u in (16, 8, 4, 2) if row_bytes % u == 0 and ptr % u == 0)


def _launch_args(q, k):
    """(bh, bw, cd, unit) of a K1 or K3 launch on q and k."""
    bh, bw, cd, _ = attn_geometry(q.shape, q.element_size())
    return bh, bw, cd, _copy_unit(q.shape[4] * q.shape[5] * q.element_size(), k.data_ptr())


def modet_attention_plain(q, k, rpb, scale: float, k_halo: bool = False) -> torch.Tensor:
    """The kernel's plain PyTorch version (same contract as `modet_attention`)."""
    return _neighborhood_attention_plain(q, k, rpb, scale, 3, k_halo)


def _k_shape(q, k_halo: bool):
    b, d, h, w, heads, hd = q.shape
    return (b, d + 2 * bool(k_halo), h, w, heads, hd)


def _check(q, k, rpb, what: str, k_halo: bool = False):
    """Shape and type checks; returns True for all-CPU tensors (the plain
    version)."""
    if q.ndim != 6 or tuple(k.shape) != _k_shape(q, k_halo):
        want = "k of D+2 slices (halo-k)" if k_halo else "k must be equal"
        raise ValueError(f"q (B,D,H,W,heads,hd) and {want}, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    heads = q.shape[4]
    if rpb is not None and tuple(rpb.shape) != (heads, 3, 3, 3):
        raise ValueError(f"rpb must be ({heads}, 3, 3, 3), got {tuple(rpb.shape)}")
    tensors = [q, k] + ([rpb] if rpb is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in tensors]}; "
                         "the kernel takes all on one CUDA device")
    if (q.dtype not in _build.IO_DTYPES or k.dtype != q.dtype
            or (rpb is not None and rpb.dtype != torch.float32)):
        raise TypeError(f"{what}: the kernel takes q and k both float32 or both bfloat16 and "
                        f"rpb float32, got {[t.dtype for t in tensors]}")
    if not (q.is_contiguous() and k.is_contiguous()):
        raise ValueError(f"{what}: q and k must be contiguous")
    if q.shape[5] > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head_dim {q.shape[5]} > {MAX_HEAD_DIM}")
    return False


def _rpb_flat(rpb):
    return rpb.contiguous().reshape(rpb.shape[0], 27) if rpb is not None else None


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch_fwd(q, k, rpb, scale: float, k_halo: bool = False) -> torch.Tensor:
    """K1: (B, D, H, W, heads*3) in q's dtype."""
    b, d, h, w, heads, hd = q.shape
    out = torch.empty((b, d, h, w, heads * 3), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    rpb_flat = _rpb_flat(rpb)
    _build.launch(_build.entry("smilecode_modet_attn_fwd", q), _FWD_ARGTYPES, q,
                  q.data_ptr(), k.data_ptr(), _ptr(rpb_flat), out.data_ptr(),
                  b, d, h, w, heads, hd, float(scale), *_launch_args(q, k), int(k_halo),
                  what="modet_attn_fwd launch")
    _build.count(modet_attention, q, mode="halo" if k_halo else None)
    return out


def modet_attention_bwd_dq(q, k, rpb, scale: float, g, k_halo: bool = False):
    """K3 on CUDA tensors: (dq, dl, drpb_partials or None).

    dq and dl are in q's dtype (g has it too); dl is (B, D, H, W, heads, 27),
    K4's input; the partials are (blocks, heads, 27) float32, one per block
    of `attn_geometry`'s grid, summed by the caller. ``k_halo``: k has D+2
    slices (halo-k mode). Adds one to ``modet_attention_bwd_dq.launches``
    (and ``.launches_bf16`` for bf16, ``.launches_halo`` for halo-k) per
    launch. Span ``kernel.K3`` (`utils.profiling.span`) from entry to
    return while a profiler records."""
    with span("kernel.K3"):
        b, d, h, w, heads, hd = q.shape
        dq = torch.empty_like(q)
        dl = torch.empty((b, d, h, w, heads, 27), dtype=q.dtype, device=q.device)
        blocks = attn_geometry(q.shape, q.element_size())[3]
        part = (torch.empty((blocks, heads, 27), dtype=torch.float32, device=q.device)
                if rpb is not None else None)
        if dq.numel() == 0:
            return dq, dl, part
        rpb_flat = _rpb_flat(rpb)
        _build.launch(_build.entry("smilecode_modet_attn_bwd_dq", q), _DQ_ARGTYPES, q,
                      q.data_ptr(), k.data_ptr(), _ptr(rpb_flat), g.data_ptr(), dq.data_ptr(),
                      dl.data_ptr(), _ptr(part), b, d, h, w, heads, hd, float(scale),
                      *_launch_args(q, k), int(k_halo), what="modet_attn_bwd_dq launch")
        _build.count(modet_attention_bwd_dq, q, mode="halo" if k_halo else None)
        return dq, dl, part


def _check_dk(q, dl):
    """K4's checks: q as `_check` takes it, on a CUDA device, and dl K3's
    (B, D, H, W, heads, 27) of q's dtype on q's device, contiguous and
    16-byte aligned (the kernel copies it in 16-byte units)."""
    what = "modet_attention_bwd_dk"
    if q.ndim != 6 or tuple(dl.shape) != (*q.shape[:5], 27):
        raise ValueError(f"{what}: q (B,D,H,W,heads,hd) and dl (B,D,H,W,heads,27), got "
                         f"{tuple(q.shape)}, {tuple(dl.shape)}")
    if _check(q, q, None, what) or dl.device != q.device:
        raise ValueError(f"{what}: q on {q.device}, dl on {dl.device}; the kernel takes both on "
                         "one CUDA device")
    if dl.dtype != q.dtype:
        raise TypeError(f"{what}: dl must have q's dtype {q.dtype}, got {dl.dtype}")
    if not dl.is_contiguous():
        raise ValueError(f"{what}: dl must be contiguous")
    if dl.data_ptr() % 16:
        raise ValueError(f"{what}: dl must be 16-byte aligned")


def modet_attention_bwd_dk(q, dl, scale: float, k_halo: bool = False):
    """K4 on CUDA tensors: dk (B, D, H, W, heads, hd) in q's dtype from K3's
    dl and the unscaled q; with ``k_halo`` (B, D+2, ...), its first and last
    slices the cotangents of the neighbour shards' k slices. Raises on
    tensors it does not take (`_check_dk`), CPU ones included. Adds one to
    ``modet_attention_bwd_dk.launches`` (and ``.launches_bf16`` for bf16,
    ``.launches_halo`` for halo-k) per launch. Span ``kernel.K4``
    (`utils.profiling.span`) from entry to return, a refusal's too, while a
    profiler records."""
    with span("kernel.K4"):
        _check_dk(q, dl)
        b, d, h, w, heads, hd = q.shape
        dk = torch.empty(_k_shape(q, k_halo), dtype=q.dtype, device=q.device)
        if dk.numel() == 0:
            return dk
        bh, bw, cd, _ = dk_geometry(dk.shape, q.element_size())
        _build.launch(_build.entry("smilecode_modet_attn_bwd_dk", q), _DK_ARGTYPES, q,
                      q.data_ptr(), dl.data_ptr(), dk.data_ptr(), b, d, h, w, heads, hd,
                      float(scale), bh, bw, cd, int(k_halo), what="modet_attn_bwd_dk launch")
        _build.count(modet_attention_bwd_dk, q, mode="halo" if k_halo else None)
        return dk


_WINDOWS = [(od, oh, ow) for od in range(3) for oh in range(3) for ow in range(3)]


def modet_attention_bwd_dq_plain(q, k, rpb, scale: float, g, k_halo: bool = False):
    """K3's plain version: (dq, dl, drpb or None) for the output cotangent
    ``g`` (B, D, H, W, heads*3), written out (no autograd):

    da_t = o_t . g,  dl_t = p_t (da_t - sum_u p_u da_u),
    dq[x] = scale sum_t dl_t[x] k[x + o_t],  drpb[head, t] = sum_x dl_t[x].

    An out-of-volume neighbour keeps its dl_t in drpb but gives nothing to
    dq (the zero-padded key border). ``k_halo``: k has D+2 slices, its D
    border (halo-k mode).

    bf16 q and k (and g) are computed on in float32, q scaled in bf16 first;
    dq and dl come back rounded to bf16, drpb float32, as K3 gives them."""
    b, d, h, w, heads, hd = q.shape
    cdt = torch.promote_types(q.dtype, torch.float32)
    dpad = 0 if k_halo else 1
    kp = F.pad(k.to(cdt), (0, 0, 0, 0, 1, 1, 1, 1, dpad, dpad))
    qs = (q * torch.as_tensor(scale, dtype=q.dtype)).to(cdt)
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
    return (dq * scale).to(q.dtype), dl.to(q.dtype), drpb


def modet_attention_bwd_dk_plain(q, dl, scale: float, k_halo: bool = False):
    """K4's plain version: dk[x] = scale sum_t dl_t[x - o_t] q[x - o_t], over
    in-volume sources x - o_t only; summed in float32, returned in q's
    dtype. ``k_halo``: dk for the D+2 slices x_d = -1 .. D."""
    b, d, h, w, heads, hd = q.shape
    cdt = torch.promote_types(q.dtype, torch.float32)
    dl, qc = dl.to(cdt), q.to(cdt)
    dkp = torch.zeros((b, d + 2, h + 2, w + 2, heads, hd), dtype=cdt, device=q.device)
    for t, (od, oh, ow) in enumerate(_WINDOWS):
        dkp[:, od:od + d, oh:oh + h, ow:ow + w] += dl[..., t:t + 1] * qc
    dkp = dkp if k_halo else dkp[:, 1:-1]
    return (dkp[:, :, 1:-1, 1:-1] * scale).to(q.dtype)


def modet_attention_bwd_plain(q, k, rpb, scale: float, g, k_halo: bool = False):
    """Backward of the attention for the output cotangent ``g``, written out
    as K3 and K4 compute it. Returns (dq, dk, drpb or None)."""
    dq, dl, drpb = modet_attention_bwd_dq_plain(q, k, rpb, scale, g, k_halo=k_halo)
    return dq, modet_attention_bwd_dk_plain(q, dl, scale, k_halo=k_halo), drpb


def modet_attention_bwd(q, k, rpb, scale: float, g, k_halo: bool = False):
    """(dq, dk, drpb or None) for the output cotangent ``g``: K3 then K4 for
    CUDA tensors, `modet_attention_bwd_plain` for CPU tensors."""
    if _check(q, k, rpb, "modet_attention_bwd", k_halo):
        return modet_attention_bwd_plain(q, k, rpb, scale, g, k_halo)
    b, d, h, w, heads, _ = q.shape
    if tuple(g.shape) != (b, d, h, w, heads * 3) or g.device != q.device:
        raise ValueError(f"modet_attention_bwd: g must be {(b, d, h, w, heads * 3)} on "
                         f"{q.device}, got {tuple(g.shape)} on {g.device}")
    if g.dtype != q.dtype:
        raise TypeError(f"modet_attention_bwd: g must have q's dtype {q.dtype}, got {g.dtype}")
    dq, dl, part = modet_attention_bwd_dq(q, k, rpb, scale, g.contiguous(), k_halo)
    dk = modet_attention_bwd_dk(q, dl, scale, k_halo)
    # the partials are summed outside the kernel, as the JAX package does
    drpb = part.sum(dim=0).reshape(heads, 3, 3, 3) if part is not None else None
    return dq, dk, drpb


class ModetAttentionFunction(torch.autograd.Function):
    """K1 forward, K3 + K4 backward (CUDA tensors)."""

    @staticmethod
    def forward(ctx, q, k, rpb, scale, k_halo):
        ctx.save_for_backward(q, k, rpb)
        ctx.scale, ctx.k_halo = scale, k_halo
        return _launch_fwd(q, k, rpb, scale, k_halo)

    @staticmethod
    def backward(ctx, g):
        q, k, rpb = ctx.saved_tensors
        dq, dk, drpb = modet_attention_bwd(q, k, rpb, ctx.scale, g, ctx.k_halo)
        return dq, dk, drpb, None, None


def modet_attention(q: torch.Tensor, k: torch.Tensor, rpb: torch.Tensor | None,
                    scale: float = 1.0, k_halo: bool = False) -> torch.Tensor:
    """q: (B, D, H, W, heads, head_dim); k the same, or (B, D+2, ...) with
    ``k_halo`` (halo-k mode); rpb: (heads, 3, 3, 3) or None.

    Returns (B, D, H, W, heads*3) in q's dtype (float32 or bf16), computed
    in float32; differentiable in q, k and rpb. Adds one to
    ``modet_attention.launches`` per K1 launch, and to
    ``modet_attention.launches_bf16`` when it was the bf16 instance,
    ``modet_attention.launches_halo`` when it was halo-k.

    Span ``kernel.K1`` (`utils.profiling.span`) from entry to return,
    the plain version's too, while a profiler records.
    """
    with span("kernel.K1"):
        if _check(q, k, rpb, "modet_attention", k_halo):
            return modet_attention_plain(q, k, rpb, scale, k_halo)
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, rpb)):
            return ModetAttentionFunction.apply(q, k, rpb, scale, k_halo)
        return _launch_fwd(q, k, rpb, scale, k_halo)


for _fn in (modet_attention, modet_attention_bwd_dq, modet_attention_bwd_dk):
    _fn.launches = _fn.launches_bf16 = _fn.launches_halo = 0
