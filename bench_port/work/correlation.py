"""The benchmark's yardstick for the hand-written kernel K7, PR++'s windowed
3D correlation (`smilecode_tpu_torch/csrc/correlation3d.cu`): the calls a
training step or a registered pair makes, counted from a PR++
configuration's volume and width, and the bytes and float32 operations of
each. Pure Python: no torch, nothing of the program.

PR++ correlates its five pyramid levels: 4c-wide maps at 1/8 and 1/4 of
the volume, 2c at 1/2 and at full size, c at full size (c the
configuration's ``first_channel``). A registered pair runs each level's
forward; a training step also its adjoint. Each input byte is counted read
once and each output byte written once: the forward reads mov and fix and
writes 27 values a voxel, the adjoint reads g (27 a voxel), mov and fix and
writes d_mov and d_fix. Operations per voxel: two separable 3^3 box sums (6
C additions each), 27 C multiply-adds and 27 divisions forward; two gathers
of 27 C multiply-adds, 2 C divisions and two box sums in the adjoint.
"""

from __future__ import annotations

import math

# K7's __global__ functions as the profiler's trace names them
GLOBALS = ("correlation3d_box_kernel<", "correlation3d_fwd_kernel<",
           "correlation3d_bwd_mov_kernel<", "correlation3d_bwd_fix_kernel<")
LEVELS = ((8, 4), (4, 4), (2, 2), (1, 2), (1, 1))  # (the volume's divisor, c multiple)


def work(kernel: str, voxels: int, c: int):
    """(bytes, float32 operations) of one K7 call, ``kernel`` "fwd" or
    "bwd", on (voxels, c) maps in float32."""
    if kernel == "fwd":
        return 4 * voxels * (2 * c + 27), voxels * (12 * c + 54 * c + 27)
    if kernel == "bwd":
        return 4 * voxels * (27 + 4 * c), voxels * (108 * c + 2 * c + 12 * c)
    raise ValueError(f"not a K7 call: {kernel!r}")


def calls(config: dict, train: bool) -> list:
    """(kernel, voxels, c) of each K7 call of one training step (``train``)
    or registered pair of the PR++ configuration ``config``, at its
    ``volume`` and ``knobs.first_channel``."""
    c = config["knobs"]["first_channel"]
    out = []
    for div, mult in LEVELS:
        voxels = math.prod(n // div for n in config["volume"])
        out.append(("fwd", voxels, mult * c))
        if train:
            out.append(("bwd", voxels, mult * c))
    return out
