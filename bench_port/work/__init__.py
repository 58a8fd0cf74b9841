"""The benchmark's yardstick for the hand-written kernels K1-K5: bytes and
float32 operations of one call from its shapes, and the least time the card
could take for them.

A frozen copy of `chip_smoke.py`'s `bound`, `attn_work` and `warp_work`, with
the brick rule of K1/K3's launch (`kernels/modet_attn.py:attn_geometry`) that
counts K3's drpb partials. The benchmark keeps its own copy so that an edit
of the program or of `chip_smoke.py` cannot move the yardstick; a CPU test
(`tests/test_bench_port_work.py`) holds the copy to them at ModeT's shapes.
Pure Python: no torch, nothing of the program.

Each input byte is counted read once and each output byte written once; the
operations are the kernels' float32 operations (their bf16 instances also
compute in float32). The peaks are NVIDIA's published H100 SXM figures:
3.35 TB/s of HBM and 67 TFLOP/s of float32 outside the tensor cores.
"""

from __future__ import annotations

import json
import math
import os

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# the __global__ functions of each kernel, as the profiler's trace names them
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels.json")) as _f:
    KERNELS = json.load(_f)

# K1/K3 bricks as the kernels launch them (`kernels/modet_attn.py:60-72`)
_ATTN_THREADS = 256
_ATTN_MAX_BH, _ATTN_MAX_BW = 8, 32
_ATTN_RING_BYTES = 64 * 1024
_ATTN_TARGET_BLOCKS = 2048
_RING_SLOTS = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def attn_blocks(shape, isz: int) -> int:
    """Blocks of K1's and K3's grid on q of ``shape`` (B, D, H, W, heads,
    hd): the number of K3's drpb partials."""
    b, d, h, w, heads, hd = (int(n) for n in shape)
    row = heads * hd * isz

    def ring(bh, bw):
        return _RING_SLOTS * _cdiv((bh + 2) * (bw + 2) * row, 16) * 16

    voxels = max(1, _ATTN_THREADS // heads)
    bw = max(1, min(_ATTN_MAX_BW if w % _ATTN_MAX_BW == 0 else 16, voxels, w))
    bh = max(1, min(voxels // bw, _ATTN_MAX_BH, h))
    while ring(bh, bw) > _ATTN_RING_BYTES and bh > 1:
        bh -= 1
    while ring(bh, bw) > _ATTN_RING_BYTES and bw > 1:
        bw -= 1
    cols = b * _cdiv(h, bh) * _cdiv(w, bw)
    chunks = max(1, min(d, _cdiv(_ATTN_TARGET_BLOCKS, max(cols, 1))))
    cd = max(1, _cdiv(d, chunks))
    return cols * _cdiv(d, cd)


def bound(nbytes: float, ops: float, bytes_per_s: float = HBM_BYTES_PER_S,
          ops_per_s: float = F32_OPS_PER_S):
    """(ms, "bytes" | "operations"): the least time to move ``nbytes`` and
    do ``ops`` float32 operations, whichever is longer."""
    t_bytes, t_ops = nbytes / bytes_per_s * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_work(kernel: str, shape, isz: int, with_rpb: bool = True):
    """(bytes, float32 operations) of one attention call on q and k of
    ``shape`` (B, D, H, W, heads, hd) with ``isz``-byte values: K1 forward,
    K3 dq/dl/drpb partials, K4 dk. Per (voxel, head): 27 tokens of a hd dot
    product (2*hd), the bias add, exp and the online softmax (~10); K3 adds
    the dl arithmetic and the dq contraction (2*hd + 6); K4 is the 27-token
    dk contraction alone."""
    voxels, heads, hd = math.prod(int(n) for n in shape[:4]), int(shape[4]), int(shape[5])
    rows = voxels * heads
    rpb = heads * 27 * 4 if with_rpb else 0
    if kernel == "K1":
        return rows * (2 * hd + 3) * isz + rpb, rows * (27 * (2 * hd + 10) + 3)
    if kernel == "K3":
        parts = (attn_blocks(shape, isz) if with_rpb else 0) * heads * 27 * 4
        return rows * (3 * hd + 3 + 27) * isz + rpb + parts, rows * 27 * (4 * hd + 16)
    if kernel == "K4":
        return rows * (2 * hd + 27) * isz, rows * 27 * 2 * hd
    raise ValueError(f"not an attention kernel: {kernel!r}")


def warp_work(kernel: str, src_voxels: int, voxels: int, c: int, isz: int, scatter: bool = False):
    """(bytes, float32 operations) of one warp call: K2 reads the source
    once, the float32 flow, and writes C values per output voxel; K5 also
    reads g and writes the float32 d_flow, and d_src when it scatters. Per
    output voxel ~40 operations for coordinates and corner weights and 8
    corners x C multiply-adds (K2); K5 the same plus the derivative
    coefficients, and 8 x C more for the scatter."""
    if kernel == "K2":
        return src_voxels * c * isz + voxels * (12 + c * isz), voxels * (40 + 16 * c)
    if kernel == "K5":
        nbytes = src_voxels * c * isz * (2 if scatter else 1) + voxels * (24 + c * isz)
        return nbytes, voxels * (60 + 16 * c * (2 if scatter else 1))
    raise ValueError(f"not a warp kernel: {kernel!r}")


def call_work(call: dict):
    """(kernel, bytes, operations) of one recorded call (`reference.common.Ops`)."""
    if call["kernel"] in ("K1", "K3", "K4"):
        return (call["kernel"], *attn_work(call["kernel"], call["shape"], call["isz"],
                                           call.get("rpb", True)))
    return (call["kernel"], *warp_work(call["kernel"], call["src_voxels"], call["voxels"],
                                       call["c"], call["isz"], call.get("scatter", False)))
