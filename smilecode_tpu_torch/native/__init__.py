"""Host data-path kernels in C++/OpenMP (`preproc.cpp`), loaded with ctypes.

Counterpart of `smilecode_tpu/native/__init__.py`: `seg_remap` (the
`Seg_norm` label lookup), `minmax_normalize`, `halfres` (the half
datasets' stride-2 copy), `dice_counts` and `dice_val_voi_native`, each one
pass over the volume.

The library is built by ``g++ -O3 -fopenmp -shared -fPIC`` at the first
call, never at import, into ``smilecode_tpu_torch/_build/`` (git-ignored),
named by a hash of the source and the flags and written under a temporary
name first, so that processes building at once never load half a file. A
failed build or load raises: there is no silent numpy fallback. Inputs the
kernels do not take (labels that are not uint16, images that are not
float32, volumes that are not 3-D) go through the numpy formula of the same
function.

OpenMP: torch is imported first, so the library's ``libgomp.so.1`` is the
runtime torch already loaded wherever torch ships it under that name. A
call from the main thread uses ``torch.get_num_threads()`` threads; a call
from any other thread (the loader's workers, which already run side by
side) uses one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "preproc.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]

_lib = None
_lock = threading.Lock()


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpreproc_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *GXX_FLAGS, SOURCE, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: smilecode_tpu_torch.native builds "
                           "preproc.cpp with g++ at first use") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build never loads half a file


def library() -> ctypes.CDLL:
    """The loaded library, built first if this source hash is new."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise RuntimeError(f"cannot load {path}, built by g++ from {SOURCE}: {e}") from e
        i64, i32 = ctypes.c_int64, ctypes.c_int
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        for name, args in (("seg_remap_u16", [u16p, i64, u16p, i64, u16p, i32]),
                           ("minmax_normalize_f32", [f32p, i64, f32p, i32]),
                           ("halfres_f32", [f32p, i64, i64, i64, f32p, i32]),
                           ("halfres_u16", [u16p, i64, i64, i64, u16p, i32]),
                           ("dice_counts_u16", [u16p, u16p, i64, i64, i64p, i64p, i64p])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = None
        _lib = lib
        return lib


def _threads() -> int:
    if threading.current_thread() is threading.main_thread():
        return max(1, torch.get_num_threads())
    return 1


def seg_remap(seg: np.ndarray, table: np.ndarray) -> np.ndarray:
    """out[v] = index of v in ``table`` (0 if absent), one lookup-table pass
    (`Seg_norm`). Labels that are not uint16 take
    `smilecode_tpu_torch.data.trans.seg_remap`."""
    table = np.asarray(table)
    if seg.dtype != np.uint16 or not seg.size:
        from smilecode_tpu_torch.data.trans import seg_remap as plain

        return plain(seg, table)
    if table.min() < 0 or table.max() > np.iinfo(np.uint16).max:
        raise ValueError("seg_remap: a uint16 label volume needs table ids in [0, 65535]")
    lib = library()
    seg_c = np.ascontiguousarray(seg)
    table_c = np.ascontiguousarray(table, np.uint16)
    out = np.empty_like(seg_c)
    lib.seg_remap_u16(seg_c.reshape(-1), seg_c.size, table_c, table_c.size, out.reshape(-1),
                      _threads())
    return out


def minmax_normalize_np(img: np.ndarray) -> np.ndarray:
    """(x - min) · (1 / (max - min)) in float64, rounded to float32: the
    native kernel's arithmetic, in numpy."""
    lo, hi = float(img.min()), float(img.max())
    return ((img.astype(np.float64) - lo) * (1.0 / (hi - lo))).astype(np.float32)


def minmax_normalize(img: np.ndarray) -> np.ndarray:
    """Min-max normalisation to [0, 1] float32; images that are not float32
    take `minmax_normalize_np`."""
    if img.dtype != np.float32 or not img.size:
        return minmax_normalize_np(img)
    lib = library()
    img_c = np.ascontiguousarray(img)
    out = np.empty_like(img_c)
    lib.minmax_normalize_f32(img_c.reshape(-1), img_c.size, out.reshape(-1), _threads())
    return out


def halfres(vol: np.ndarray) -> np.ndarray:
    """``vol[::2, ::2, ::2]``, contiguous (the half datasets); volumes that
    are not 3-D float32 or uint16 take
    `smilecode_tpu_torch.data.datasets.halfres`."""
    if vol.ndim != 3 or vol.dtype not in (np.float32, np.uint16):
        from smilecode_tpu_torch.data.datasets import halfres as plain

        return plain(vol)
    lib = library()
    vol_c = np.ascontiguousarray(vol)
    d, h, w = vol.shape
    out = np.empty(((d + 1) // 2, (h + 1) // 2, (w + 1) // 2), vol.dtype)
    fn = lib.halfres_f32 if vol.dtype == np.float32 else lib.halfres_u16
    fn(vol_c, d, h, w, out, _threads())
    return out


def dice_counts(pred: np.ndarray, true: np.ndarray, nlabels: int):
    """(intersection, |pred|, |true|) per label id in [0, nlabels), one
    pass over both volumes; labels are taken as uint16 (as the JAX
    package's kernel takes them), ids >= nlabels are counted nowhere."""
    if pred.size != true.size:
        raise ValueError(f"dice_counts: {pred.shape} and {true.shape} differ in size")
    lib = library()
    p = np.ascontiguousarray(pred.reshape(-1), np.uint16)
    t = np.ascontiguousarray(true.reshape(-1), np.uint16)
    inter = np.zeros(nlabels, np.int64)
    pc = np.zeros(nlabels, np.int64)
    tc = np.zeros(nlabels, np.int64)
    lib.dice_counts_u16(p, t, p.size, nlabels, inter, pc, tc)
    return inter, pc, tc


def dice_val_voi_native(pred: np.ndarray, true: np.ndarray, nlabels: int = 55) -> float:
    """54-VOI mean Dice (labels 1..nlabels-1) from the single-pass counts."""
    inter, pc, tc = dice_counts(pred, true, nlabels)
    dsc = 2.0 * inter[1:] / (pc[1:] + tc[1:] + 1e-5)
    return float(np.mean(dsc))
