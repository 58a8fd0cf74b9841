"""Hopper kernels K2, K5: trilinear warp forward and its adjoint.

* K2 (`csrc/warp3d.cu`) replaces `smilecode_tpu/kernels/warp3d_v4.py:_warp_v4_kernel`
  (D) and `smilecode_tpu/kernels/warp3d_v3.py:_warp_v3_kernel` (E), the
  planes-layout warps of ModeT, and `smilecode_tpu/kernels/warp3d.py:
  _warp_kernel` (F), the channels-last warp behind `ops.warp(impl="pallas" |
  "guarded")` that the baseline models run. `warp3d_pallas` and
  `warp3d_guarded` name F's two entries; both are `warp3d_trilinear`, since
  K2 needs neither F's window budget nor its guard.
* K5 (`csrc/warp3d_bwd.cu`) replaces `warp3d_v4.py:_warp_v4_dflow_kernel` and
  `warp3d_v3.py:_warp_v3_dflow_kernel` (d_flow), fused with the d_src scatter
  that the TPU path leaves to XLA (`smilecode_tpu/models/modet_planes.py:_warp_hw_bwd`).

The sources say what bounds each kernel on the H100 and what its design does
about that. Both are exact for every flow.

Each kernel has a float32 and a bf16 instance: the source float32 or bf16
(ModeT's feature warps on the bf16 path), the flow always float32. The bf16
instances compute in float32; K2's output has the source's dtype, K5's
d_flow is float32 and its d_src scatter adds in float32 before one cast to
bf16 (`csrc/warp3d_bwd.cu`). Each wrapper's ``launches`` (and
``scatters``) counts both instances, ``launches_bf16`` (``scatters_bf16``)
the bf16 one.

Each kernel has a vector path, a group of lanes per output voxel with
16-byte loads and stores (and vector atomics in K5's scatter), and a scalar
path, one thread per voxel; `_lanes_per_voxel` picks one per call from C,
the element size and the pointers' alignment, and ``launches_vector``
counts the calls that took the vector path. Either is the hand-written
kernel, with one launch per call.

D-origin mode (``d0=``; the D-sharded step, `parallel/modet_sp.py`, whose
warps sample an all-gathered source at global depth, as JAX's `_warp_sp_hw`,
`smilecode_tpu/parallel/modet_planes_sp.py:202-253`, runs D/E and G/H): the
output slice fd samples the source at depth fd + d0 + flow_d, the source's
depth may differ from the flow's while H and W agree, and no axis is
rescaled. K5's d_src then covers the whole source; the caller
reduce-scatters it home. ``launches_origin`` (and K5's ``scatters_origin``)
count these launches.

`warp3d_trilinear` runs the plain version (`warp3d_trilinear_plain`,
`ops/warp.py:_warp_simple`, differentiated by torch autograd) for CPU
tensors. For CUDA tensors it goes through `Warp3dTrilinearFunction`, whose
forward launches K2 and whose backward launches K5, with the scatter half
only when the source needs a gradient; when no gradient is wanted it
launches K2 directly, without the autograd Function's host time. It never
falls back from the card to the plain version. `warp3d_trilinear_bwd_plain`
writes the adjoint out explicitly; it is K5's oracle on the card.
"""

from __future__ import annotations

import ctypes

import torch

from smilecode_tpu_torch.kernels import _build
from smilecode_tpu_torch.ops.warp import (
    _warp_simple,
    base_grid,
    check_warp_args,
    guard_non_finite,
    rescale_factors,
    warp_coords,
)
from smilecode_tpu_torch.utils.profiling import span

# (SD, SH, SW, C, lanes, FD, FH, FW, d0), then the three scales
_FWD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 9 + [
    ctypes.c_float] * 3 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 9 + [
    ctypes.c_float] * 3 + [ctypes.c_void_p]


def _origin_coords(flow: torch.Tensor, d0: int) -> torch.Tensor:
    """(B, FD*FH*FW, 3) absolute coordinates (grid + flow) + (d0, 0, 0), in
    float32 (float64 for a float64 flow), added in that order as JAX's
    `parallel/modet_sp.py:_warp_sp` adds them."""
    b, fd, fh, fw, _ = flow.shape
    dt = torch.promote_types(flow.dtype, torch.float32)
    coords = base_grid(fd, fh, fw, dt, flow.device) + flow.to(dt)
    coords = coords + torch.tensor([float(d0), 0.0, 0.0], dtype=dt, device=flow.device)
    return coords.reshape(b, fd * fh * fw, 3)


def warp3d_trilinear_plain(src: torch.Tensor, flow: torch.Tensor,
                           d0: int | None = None) -> torch.Tensor:
    """The kernel's plain PyTorch version (same contract as `warp3d_trilinear`)."""
    if d0 is None:
        return _warp_simple(src, flow, "bilinear")
    _check_origin(src, flow)
    return warp_coords(src, _origin_coords(flow, d0), flow.shape[1:4])


def _check_origin(src, flow) -> None:
    if src.shape[2:4] != flow.shape[2:4]:
        raise ValueError(f"a D-origin warp takes a source of the flow's H and W, got "
                         f"{tuple(src.shape)} and {tuple(flow.shape)}")


def _check(src, flow, what: str, d0: int | None = None) -> bool:
    """Argument checks; returns True for CPU tensors (the plain version)."""
    check_warp_args(src, flow)
    if d0 is not None:
        _check_origin(src, flow)
    if src.device.type == "cpu" and flow.device.type == "cpu":
        return True
    if src.device != flow.device or src.device.type != "cuda":
        raise ValueError(f"{what}: src on {src.device}, flow on {flow.device}; "
                         "the kernel takes both on one CUDA device")
    if src.dtype not in _build.IO_DTYPES or flow.dtype != torch.float32:
        raise TypeError(f"{what}: the kernel takes a float32 or bfloat16 src and a float32 "
                        f"flow, got {src.dtype}, {flow.dtype}")
    if not (src.is_contiguous() and flow.is_contiguous()):
        raise ValueError(f"{what}: src and flow must be contiguous")
    return False


def _scale(src, flow, d0=None):
    if d0 is not None:  # the gathered source's depth differs; nothing rescales
        return (1.0, 1.0, 1.0)
    return rescale_factors(src.shape[1:4], flow.shape[1:4]) or (1.0, 1.0, 1.0)


def _lanes_per_voxel(c: int, itemsize: int, *ptrs: int) -> int:
    """Lanes per output voxel of K2's and K5's vector path, or 0 for their
    scalar path (one thread per voxel).

    A row of ``c`` values of ``itemsize`` bytes takes the vector path when it
    is a whole number of 16-byte vectors and every pointer in ``ptrs`` is
    16-byte aligned. Its lanes are then the largest power of two, up to 32,
    that divides the row's vector count, so C * itemsize / 16 for the rows
    of 1 to 32 vectors that ModeT and the baselines warp; each lane takes
    every G-th vector of the row."""
    row = c * itemsize
    if row == 0 or row % 16 or any(p % 16 for p in ptrs):
        return 0
    vectors = row // 16
    return min(vectors & -vectors, 32)


def _launch_fwd(src, flow, d0=None) -> torch.Tensor:
    """K2: (B, FD, FH, FW, C) in src's dtype."""
    b, sd, sh, sw, c = src.shape
    fd, fh, fw = flow.shape[1:4]
    out = torch.empty((b, fd, fh, fw, c), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    lanes = _lanes_per_voxel(c, src.element_size(), src.data_ptr(), out.data_ptr())
    _build.launch(_build.entry("smilecode_warp3d_trilinear_fwd", src), _FWD_ARGTYPES, src,
                  src.data_ptr(), flow.data_ptr(), out.data_ptr(),
                  b, sd, sh, sw, c, lanes, fd, fh, fw, d0 or 0, *_scale(src, flow, d0),
                  what="warp3d_trilinear_fwd launch")
    _build.count(warp3d_trilinear, src, mode=None if d0 is None else "origin")
    warp3d_trilinear.launches_vector += bool(lanes)
    return out


def _launch_bwd(src, flow, g, want_dsrc: bool, d0=None):
    """K5: (d_src or None, d_flow); d_src in src's dtype, d_flow float32."""
    b, sd, sh, sw, c = src.shape
    fd, fh, fw = flow.shape[1:4]
    d_flow = torch.empty_like(flow)
    # the scatter adds into float32 zeros, cast once for a bf16 source
    d_src = torch.zeros(src.shape, dtype=torch.float32, device=src.device) if want_dsrc else None
    if d_flow.numel() == 0 or c == 0:
        return None if d_src is None else d_src.to(src.dtype), d_flow.zero_()
    ptrs = (src.data_ptr(), g.data_ptr()) + ((d_src.data_ptr(),) if want_dsrc else ())
    lanes = _lanes_per_voxel(c, src.element_size(), *ptrs)
    _build.launch(_build.entry("smilecode_warp3d_trilinear_bwd", src), _BWD_ARGTYPES, src,
                  src.data_ptr(), flow.data_ptr(), g.data_ptr(),
                  d_src.data_ptr() if want_dsrc else None, d_flow.data_ptr(),
                  b, sd, sh, sw, c, lanes, fd, fh, fw, d0 or 0, *_scale(src, flow, d0),
                  what="warp3d_trilinear_bwd launch")
    mode = None if d0 is None else "origin"
    _build.count(warp3d_trilinear_bwd, src, mode=mode)
    warp3d_trilinear_bwd.launches_vector += bool(lanes)
    if want_dsrc:
        _build.count(warp3d_trilinear_bwd, src, "scatters", mode)
        d_src = d_src.to(src.dtype)
    return d_src, d_flow


def warp3d_trilinear_bwd_plain(src, flow, g, want_dsrc: bool = True, d0: int | None = None):
    """Adjoint of the trilinear warp for the output cotangent ``g``
    (B, FD, FH, FW, C), written out (no autograd) as K5 computes it.

    Per output voxel at coord = (grid + flow) * rescale, with corner weights
    w = prod_a (t_a or 1 - t_a) and in-volume indicators:
    d_coord_a = sum_corners (+-1 on axis a) (the other two axes' factors)
    [corner in volume] sum_c g_c src[corner, c]; d_flow = d_coord * rescale;
    d_src[corner] += w_corner g (only when ``want_dsrc``). A voxel with a
    NaN or infinite coordinate has every corner outside the volume
    (`guard_non_finite`): d_flow 0 and no d_src, as K5 and JAX `ops.warp`.
    ``d0``: D-origin mode (coord_d + d0, no rescale).
    Returns (d_src or None, d_flow)."""
    check_warp_args(src, flow)
    b, sd, sh, sw, c = src.shape
    fd, fh, fw = flow.shape[1:4]
    n = fd * fh * fw
    dt = torch.float32
    scale = torch.tensor(_scale(src, flow, d0), dtype=dt, device=flow.device)
    if d0 is None:
        coords = base_grid(fd, fh, fw, dt, flow.device) + flow.to(dt)
        coords = guard_non_finite((coords * scale).reshape(b, n, 3))
    else:
        _check_origin(src, flow)
        coords = guard_non_finite(_origin_coords(flow, d0).to(dt))
    c0 = torch.floor(coords)
    t = coords - c0
    sizes = torch.tensor([sd, sh, sw], dtype=dt, device=src.device)
    src_flat = src.reshape(b, sd * sh * sw, c).to(dt)
    gf = g.reshape(b, n, c).to(dt)
    bidx = torch.arange(b, device=src.device)[:, None]
    d_coord = torch.zeros((b, n, 3), dtype=dt, device=src.device)
    d_src = torch.zeros((b * sd * sh * sw, c), dtype=dt, device=src.device) if want_dsrc else None
    for od in (0, 1):
        for oh in (0, 1):
            for ow in (0, 1):
                idx = c0 + torch.tensor([od, oh, ow], dtype=dt, device=src.device)
                inb = ((idx >= 0) & (idx <= sizes - 1)).all(dim=-1)
                idxi = torch.where(inb[..., None], idx, torch.zeros((), dtype=dt,
                                                                    device=src.device)).long()
                lin = (idxi[..., 0] * sh + idxi[..., 1]) * sw + idxi[..., 2]
                m = inb.to(dt)
                fac = [t[..., a] if o else 1.0 - t[..., a] for a, o in enumerate((od, oh, ow))]
                sign = [1.0 if o else -1.0 for o in (od, oh, ow)]
                gv = (gf * src_flat[bidx, lin]).sum(-1) * m  # sum_c g_c src[corner, c]
                d_coord[..., 0] += sign[0] * fac[1] * fac[2] * gv
                d_coord[..., 1] += fac[0] * sign[1] * fac[2] * gv
                d_coord[..., 2] += fac[0] * fac[1] * sign[2] * gv
                if want_dsrc:
                    wgt = fac[0] * fac[1] * fac[2] * m
                    rows = (bidx * (sd * sh * sw) + lin).reshape(-1)
                    d_src.index_add_(0, rows, (wgt[..., None] * gf).reshape(-1, c))
    d_flow = (d_coord * scale).reshape(flow.shape).to(flow.dtype)
    if want_dsrc:
        d_src = d_src.reshape(src.shape).to(src.dtype)
    return d_src, d_flow


def warp3d_trilinear_bwd(src, flow, g, want_dsrc: bool = True, d0: int | None = None):
    """(d_src or None, d_flow) for the output cotangent ``g``: K5 for CUDA
    tensors, `warp3d_trilinear_bwd_plain` for CPU tensors; ``d0`` as
    `warp3d_trilinear`'s.

    Adds one to ``warp3d_trilinear_bwd.launches`` per K5 launch, and one to
    ``warp3d_trilinear_bwd.scatters`` when that launch also scattered d_src
    (and to ``.launches_bf16``, ``.scatters_bf16`` for a bf16 source,
    ``.launches_origin``, ``.scatters_origin`` in D-origin mode, and to
    ``.launches_vector`` when it took the vector path).

    Span ``kernel.K5`` (`utils.profiling.span`) from entry to return,
    the plain version's too, while a profiler records.
    """
    with span("kernel.K5"):
        if _check(src, flow, "warp3d_trilinear_bwd", d0):
            return warp3d_trilinear_bwd_plain(src, flow, g, want_dsrc, d0)
        out_shape = (src.shape[0], *flow.shape[1:4], src.shape[4])
        if tuple(g.shape) != out_shape or g.device != src.device:
            raise ValueError(f"warp3d_trilinear_bwd: g must be {out_shape} on {src.device}, "
                             f"got {tuple(g.shape)} on {g.device}")
        if g.dtype != src.dtype:
            raise TypeError(f"warp3d_trilinear_bwd: g must have src's dtype {src.dtype}, "
                            f"got {g.dtype}")
        return _launch_bwd(src, flow, g.contiguous(), want_dsrc, d0)


class Warp3dTrilinearFunction(torch.autograd.Function):
    """K2 forward, K5 backward (CUDA tensors)."""

    @staticmethod
    def forward(ctx, src, flow, d0):
        ctx.save_for_backward(src, flow)
        ctx.d0 = d0
        return _launch_fwd(src, flow, d0)

    @staticmethod
    def backward(ctx, g):
        src, flow = ctx.saved_tensors
        d_src, d_flow = warp3d_trilinear_bwd(src, flow, g, want_dsrc=ctx.needs_input_grad[0],
                                             d0=ctx.d0)
        return d_src, d_flow if ctx.needs_input_grad[1] else None, None


def warp3d_trilinear(src: torch.Tensor, flow: torch.Tensor, d0: int | None = None) -> torch.Tensor:
    """src (B, SD, SH, SW, C), flow (B, FD, FH, FW, 3) -> (B, FD, FH, FW, C)
    in src's dtype (float32 or bf16; the flow is float32), differentiable in
    both. ``d0`` (D-origin mode): sample at (fd + d0, fh, fw) + flow, with
    SH, SW = FH, FW and no rescale.

    Adds one to ``warp3d_trilinear.launches`` per K2 launch, to
    ``warp3d_trilinear.launches_bf16`` when it was the bf16 instance, to
    ``warp3d_trilinear.launches_origin`` in D-origin mode, and to
    ``warp3d_trilinear.launches_vector`` when it took the vector path.

    Span ``kernel.K2`` (`utils.profiling.span`) from entry to return,
    the plain version's too, while a profiler records.
    """
    with span("kernel.K2"):
        if _check(src, flow, "warp3d_trilinear", d0):
            return warp3d_trilinear_plain(src, flow, d0)
        if torch.is_grad_enabled() and (src.requires_grad or flow.requires_grad):
            return Warp3dTrilinearFunction.apply(src, flow, d0)
        return _launch_fwd(src, flow, d0)


# F's entries (`smilecode_tpu/kernels/warp3d.py:238,259`): the same K2 wrapper
# and launch count, with no fallback
warp3d_pallas = warp3d_guarded = warp3d_trilinear

warp3d_trilinear.launches = warp3d_trilinear.launches_bf16 = warp3d_trilinear.launches_vector = 0
warp3d_trilinear.launches_origin = 0
warp3d_trilinear_bwd.launches = warp3d_trilinear_bwd.launches_bf16 = 0
warp3d_trilinear_bwd.launches_vector = warp3d_trilinear_bwd.launches_origin = 0
warp3d_trilinear_bwd.scatters = warp3d_trilinear_bwd.scatters_bf16 = 0
warp3d_trilinear_bwd.scatters_origin = 0
