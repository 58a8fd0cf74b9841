"""Build and load the Hopper kernels of `smilecode_tpu_torch/csrc/`.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``. The library
is named by a hash of the sources and flags, so an edit rebuilds; it lives in
``smilecode_tpu_torch/_build/`` (git-ignored). The build runs at the first
launch of any kernel, never at import, so a checkout alone is enough:
``python3 chip_smoke.py`` builds everything.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers turn a non-zero code into an exception through `check`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

IO_DTYPES = (torch.float32, torch.bfloat16)  # storage types with a kernel instance

_lib = None
build_info: dict = {}  # seconds, path and nvcc/ptxas output of the build (kept beside it)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsmilecode_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds) -> str:
    """Start every command at once, wait for all, raise on the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash is new."""
    global _lib
    if _lib is not None:
        return _lib
    path = _library_path()
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        nvcc = _nvcc()
        cus = [s for s in _sources() if s.endswith(".cu")]
        objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cus]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(cus, objs)])
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        for o in objs:
            os.remove(o)
        with open(f"{path}.log", "w") as f:
            f.write(log)
        os.replace(tmp, path)  # atomic: a concurrent build never loads half a file
    elif os.path.exists(f"{path}.log"):  # built by an earlier process: its ptxas report
        with open(f"{path}.log") as f:
            log = f.read()
    lib = ctypes.CDLL(path)
    lib.smilecode_error_string.argtypes = [ctypes.c_int]
    lib.smilecode_error_string.restype = ctypes.c_char_p
    build_info.update(seconds=time.perf_counter() - t0, path=path, log=log)
    _lib = lib
    return lib


def function(name: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``name`` with its argument types; returns int error code."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(code: int, what: str) -> None:
    if code != 0:
        msg = library().smilecode_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def entry(name: str, t) -> str:
    """The C entry point ``name`` of the instance for tensor ``t``'s storage
    type: ``<name>_bf16`` for bfloat16, ``name`` for float32."""
    return f"{name}_bf16" if t.dtype == torch.bfloat16 else name


def count(fn, t, what: str = "launches", mode: str | None = None) -> None:
    """Add one to ``fn.<what>``, to ``fn.<what>_bf16`` when ``t`` is
    bfloat16, and to ``fn.<what>_<mode>`` for a launch in ``mode`` (the
    D-sharded step's "halo" attention and "origin" warps): the wrappers'
    launch counters."""
    setattr(fn, what, getattr(fn, what) + 1)
    if t.dtype == torch.bfloat16:
        setattr(fn, f"{what}_bf16", getattr(fn, f"{what}_bf16") + 1)
    if mode:
        setattr(fn, f"{what}_{mode}", getattr(fn, f"{what}_{mode}") + 1)
