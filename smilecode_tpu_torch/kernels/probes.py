"""Hopper kernels P1-P4 of the root probe scripts (`csrc/probes.cu`).

The scripts `_probe_prims.py`, `_probe2.py`, `_probe3.py` and `_probe4.py`
hold 14 toy TPU kernels on f32 iota arrays that diagnose a TPU compiler
fault. Their functions reduce to four:

* P1 `roll` (k1, k1b, k2): ``np.roll(x, -a, axis)``;
* P2 `row_window_sum` (k3, k7, k8a, k8b, k8d, k8e, k9, k10): a sum over
  ``t`` in ``[lo, hi)`` of ``w(t)`` times rows ``base + s*t + r`` of x;
* P3 `affine` (k4, k5): ``alpha * x + beta``;
* P4 `floor_divmod` (k6): ``(t // m) * m`` and ``t % m`` with Python's
  floor semantics.

Each wrapper checks device, dtype and shape and runs its plain PyTorch
version (``*_plain``) for CPU tensors; for CUDA tensors it launches its
kernel once and adds one to its ``launches``, and never falls back. An
amount or bounds given as an int32 tensor on the card is read by the kernel
on the device: the wrapper neither copies it to the host nor syncs. A size
or value that goes to the kernel as a C ``int`` and does not fit one raises
`ValueError` before anything is allocated or launched (`_c_ints`): ctypes
would wrap it silently.
"""

from __future__ import annotations

import ctypes

import torch

from smilecode_tpu_torch.kernels import _build

_ROLL_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int,
                                                                ctypes.c_void_p]
_WINDOW_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p] + [
    ctypes.c_int] * 2 + [ctypes.c_void_p]
_AFFINE_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_float] * 2 + [
    ctypes.c_void_p]
_DIVMOD_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
C_INT_MIN, C_INT_MAX = -2 ** 31, 2 ** 31 - 1


def _kernel_ints(what: str, x: torch.Tensor, dtype, ndim: int, ints=None, n: int = 0):
    """One pass over a wrapper's arguments: ``x`` (``ndim`` dims of
    ``dtype``) and ``ints`` (an amount or bounds: ``n`` Python ints, or an
    int32 tensor of ``n`` values on x's device). None for a CPU ``x`` (the
    plain version); for a CUDA ``x`` the kernel's (pointer, by-value ints):
    the tensor's address with the by-value slots 0, or None and the ints."""
    if x.dtype != dtype or x.dim() != ndim:
        raise TypeError(f"{what}: takes a {ndim}-D {dtype} tensor, got {x.dim()}-D {x.dtype}")
    on_card = x.is_cuda
    if not on_card and x.device.type != "cpu":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {x.device}")
    if isinstance(ints, torch.Tensor):
        if ints.dtype != torch.int32 or ints.get_device() != x.get_device():
            raise TypeError(f"{what}: an amount or bound tensor must be int32 on {x.device}, "
                            f"got {ints.dtype} on {ints.device}")
        if not on_card:
            return None
        if ints.numel() != n or (n > 1 and not ints.is_contiguous()):
            raise ValueError(f"{what}: expected {n} contiguous int32 values, got shape "
                             f"{tuple(ints.shape)}")
        return ints.data_ptr(), (0,) * n
    if not on_card:
        return None
    vals = (ints,) if n == 1 else tuple(ints or ())
    if len(vals) != n:
        raise ValueError(f"{what}: expected {n} ints, got {ints!r}")
    return None, tuple(int(a) for a in vals)


def _c_ints(what: str, names: str, *ints: int) -> None:
    """Raise `ValueError` for a size or value in ``ints`` (named by the
    words of ``names``) that a C ``int`` cannot hold (a size of 2**31 or
    more), before the wrapper allocates or launches: ctypes would pass it
    wrapped (2**31 + 5 arrives as -2147483643, 2**32 + 3 as 3)."""
    if min(ints) < C_INT_MIN or max(ints) > C_INT_MAX:
        name, v = next((k, v) for k, v in zip(names.split(), ints)
                       if not C_INT_MIN <= v <= C_INT_MAX)
        raise ValueError(f"{what}: {name} = {v} does not fit the kernel's 32-bit int")


def _host_ints(v) -> tuple[int, ...]:
    return tuple(int(a) for a in v.reshape(-1).tolist()) if isinstance(v, torch.Tensor) else (
        (int(v),) if isinstance(v, int) else tuple(int(a) for a in v))


# --------------------------------------------------------------------- P1


def roll_plain(x: torch.Tensor, amount, axis: int) -> torch.Tensor:
    """``np.roll(x, -amount, axis)``: out[i] = x[(i + amount) mod n] along ``axis``."""
    (a,) = _host_ints(amount)
    return torch.roll(x, -a, axis)


def roll(x: torch.Tensor, amount, axis: int) -> torch.Tensor:
    """P1 on a 2-D float32 ``x``: ``np.roll(x, -amount, axis)`` for axis 0
    or 1; ``amount`` an int, or an int32 tensor of one value read on the
    device. Any amount: it is taken modulo the axis length."""
    if axis not in (0, 1):
        raise ValueError(f"roll: axis must be 0 or 1, got {axis}")
    dev = _kernel_ints("roll", x, torch.float32, 2, amount, 1)
    if dev is None:
        return roll_plain(x, amount, axis)
    ptr, (a,) = dev
    rows, cols = x.shape
    _c_ints("roll", "rows cols amount", rows, cols, a)
    x = x.contiguous()
    out = torch.empty_like(x)
    _build.launch("smilecode_probe_roll", _ROLL_ARGTYPES, x, x.data_ptr(), out.data_ptr(), rows,
                  cols, axis, ptr, a, what="probe roll launch")
    roll.launches += 1
    return out


# --------------------------------------------------------------------- P2


def row_window_sum_plain(x: torch.Tensor, n: int, base: int, stride: int, bounds,
                         weighted: bool = False, bcast: bool = False) -> torch.Tensor:
    """out[r] = sum over t in [lo, hi) of w(t) * x[base + stride*t + (0 if
    bcast else r)] for r < n, w(t) = t if ``weighted`` else 1, rows outside
    x contributing 0; summed in order of t."""
    lo, hi = _host_ints(bounds)
    rows = x.shape[0]
    if rows == 0:
        return x.new_zeros((n, x.shape[1]))
    r = torch.zeros(n, dtype=torch.long, device=x.device) if bcast else torch.arange(
        n, device=x.device)
    acc = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    for t in range(lo, hi):
        idx = base + stride * t + r
        inside = (idx >= 0) & (idx < rows)
        v = torch.where(inside[:, None], x[idx.clamp(0, rows - 1)], 0.0)
        acc = acc + (v * float(t) if weighted else v)
    return acc


def row_window_sum(x: torch.Tensor, n: int, base: int, stride: int, bounds,
                   weighted: bool = False, bcast: bool = False) -> torch.Tensor:
    """P2 on a 2-D float32 ``x``: (n, cols), as `row_window_sum_plain`;
    ``bounds`` (lo, hi) as two ints, or an int32 tensor of two values read
    on the device."""
    if stride not in (0, 1) or n < 0:
        raise ValueError(f"row_window_sum: stride must be 0 or 1 and n >= 0, got {stride}, {n}")
    dev = _kernel_ints("row_window_sum", x, torch.float32, 2, bounds, 2)
    if dev is None:
        return row_window_sum_plain(x, n, base, stride, bounds, weighted, bcast)
    ptr, (lo, hi) = dev
    rows, cols = x.shape
    _c_ints("row_window_sum", "rows cols n base lo hi", rows, cols, n, base, lo, hi)
    x = x.contiguous()
    out = x.new_empty((n, cols))
    flags = stride | 2 * bool(weighted) | 4 * bool(bcast)  # the kernel's instance
    _build.launch("smilecode_probe_row_window", _WINDOW_ARGTYPES, x, x.data_ptr(), out.data_ptr(),
                  rows, cols, n, base, flags, ptr, lo, hi, what="probe row_window_sum launch")
    row_window_sum.launches += 1
    return out


# --------------------------------------------------------------------- P3


def affine_plain(x: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    return x * alpha + beta


def affine(x: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    """P3 on a 2-D float32 ``x``: ``alpha * x + beta``, the product and the
    sum each rounded, as `affine_plain`."""
    if _kernel_ints("affine", x, torch.float32, 2) is None:
        return affine_plain(x, alpha, beta)
    x = x.contiguous()
    out = torch.empty_like(x)
    _build.launch("smilecode_probe_affine", _AFFINE_ARGTYPES, x, x.data_ptr(), out.data_ptr(),
                  x.numel(), alpha, beta, what="probe affine launch")
    affine.launches += 1
    return out


# --------------------------------------------------------------------- P4


def floor_divmod_plain(t: torch.Tensor, m: int) -> torch.Tensor:
    """(2, n) int32: row 0 ``(t // m) * m``, row 1 ``t % m``, Python's floor semantics."""
    return torch.stack([torch.div(t, m, rounding_mode="floor") * m, torch.remainder(t, m)])


def floor_divmod(t: torch.Tensor, m: int) -> torch.Tensor:
    """P4 on a 1-D int32 ``t`` and an int ``m`` != 0, as `floor_divmod_plain`."""
    if m == 0:
        raise ZeroDivisionError("floor_divmod: m must not be 0")
    if _kernel_ints("floor_divmod", t, torch.int32, 1) is None:
        return floor_divmod_plain(t, m)
    _c_ints("floor_divmod", "m", m)  # the count goes as a 64-bit long long
    t = t.contiguous()
    out = torch.empty((2, t.numel()), dtype=torch.int32, device=t.device)
    _build.launch("smilecode_probe_floor_divmod", _DIVMOD_ARGTYPES, t, t.data_ptr(),
                  out.data_ptr(), t.numel(), m, what="probe floor_divmod launch")
    floor_divmod.launches += 1
    return out


KERNELS = {"P1": roll, "P2": row_window_sum, "P3": affine, "P4": floor_divmod}
PLAIN = {"P1": roll_plain, "P2": row_window_sum_plain, "P3": affine_plain,
         "P4": floor_divmod_plain}
for _fn in KERNELS.values():
    _fn.launches = 0
