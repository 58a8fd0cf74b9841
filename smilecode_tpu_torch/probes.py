"""The root probe scripts' checks through the port's kernels P1-P4.

Runs every probe of `_probe_prims.py`, `_probe2.py`, `_probe3.py` and
`_probe4.py` (14 kernels, 17 runs: k1 with three amounts and k1b with two)
on the scripts' own inputs, ``X = arange(32*128)`` or ``arange(64*128)`` as
float32, through `kernels/probes.py`, prints one line per run with the max
error against the script's numpy ``want``, and raises if any error is not
exactly 0. Amounts and bounds that a probe reads from SMEM (`Smem`) are
int32 tensors on the device; static ones are passed by value.

Runs on the CUDA card unless asked for the CPU (the plain versions):

    python -m smilecode_tpu_torch.probes [device=cpu]
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from smilecode_tpu_torch.kernels.probes import (
    KERNELS,
    affine_plain,
    floor_divmod_plain,
    roll_plain,
    row_window_sum_plain,
)
from smilecode_tpu_torch.utils import resolve_device

X32 = np.arange(32 * 128, dtype=np.float32).reshape(32, 128)
X64 = np.arange(64 * 128, dtype=np.float32).reshape(64, 128)
XS = {"X32": X32, "X64": X64}  # the scripts' inputs by name
_K7_WANT = X64[17:33] + X64[18:34]


class Smem(tuple):
    """Ints that the script's kernel reads from SMEM: an int32 tensor on the
    device in the port's call."""


class Probe(NamedTuple):
    name: str
    where: str  # the script's kernel, file:line
    kernel: str  # P1..P4
    x: str | None  # "X32", "X64", or None (P4 takes only its SMEM operand)
    args: tuple  # the wrapper's arguments after x; a Smem becomes a device tensor
    kwargs: dict
    want: np.ndarray  # the script's numpy reference


PROBES = [
    *(Probe(f"k1 amt={a}", "_probe_prims.py:12", "P1", "X32", (Smem([a]), 0), {},
            np.roll(X32, -a, axis=0)) for a in (0, 3, 5)),
    *(Probe(f"k1b amt={a}", "_probe_prims.py:31", "P1", "X32", (Smem([a]), 1), {},
            np.roll(X32, -a, axis=1)) for a in (0, 7)),
    Probe("k2", "_probe_prims.py:50", "P1", "X32", (3, 0), {}, np.roll(X32, -3, axis=0)),
    # every row of k3's (8, 128) output is the sum; the script reads row 0
    Probe("k3", "_probe_prims.py:58", "P2", "X32", (8, 0, 1, Smem([2, 7])), {"bcast": True},
          np.broadcast_to(X32[2:7].sum(axis=0), (8, 128))),
    Probe("k4", "_probe2.py:10", "P3", "X64", (1.0, 1.0), {}, X64 + 1),
    Probe("k5", "_probe2.py:22", "P3", "X64", (2.0, 0.0), {}, X64 * 2),
    Probe("k6", "_probe2.py:34", "P4", None, (Smem([-3]), 8), {}, np.array([[-8], [5]], np.int32)),
    Probe("k7", "_probe2.py:48", "P2", "X64", (16, 16, 1, Smem([1, 3])), {}, _K7_WANT),
    Probe("k8a", "_probe3.py:18", "P2", "X64", (16, 16, 1, (1, 3)), {}, _K7_WANT),
    Probe("k8b", "_probe3.py:28", "P2", "X64", (16, 16, 0, Smem([1, 3])), {"weighted": True},
          X64[16:32] * 3.0),
    Probe("k8d", "_probe3.py:44", "P2", "X64", (16, 16, 1, Smem([1, 3])), {}, _K7_WANT),
    Probe("k8e", "_probe3.py:59", "P2", "X64", (16, 16, 1, Smem([1, 3])), {}, _K7_WANT),
    Probe("k9", "_probe4.py:11", "P2", "X64", (16, 16, 1, (1, 3)), {}, _K7_WANT),
    Probe("k10", "_probe4.py:26", "P2", "X64", (8, 16, 1, (1, 3)), {}, X64[17:25] + X64[18:26]),
]


class EdgeCase(NamedTuple):
    id: str
    kernel: str  # P1..P4
    x: np.ndarray  # the operand (P4: t)
    args: tuple  # the wrapper's arguments after x; a Smem is by value or on the device
    kwargs: dict
    want: torch.Tensor  # the plain version's output
    offset: int = 0  # x's first value this many values into its buffer (4 bytes each)


INT32_EXTREMES = np.array([-2 ** 31, -2 ** 31 + 1, -9, -8, -1, 0, 7, 2 ** 31 - 1], np.int32)


def _edge_rand(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _edge_cases() -> list[EdgeCase]:
    cases = []
    x = _edge_rand((7, 45), 60)
    amounts = {"0": lambda n: 0, "3": lambda n: 3, "-5": lambda n: -5, "n": lambda n: n,
               "2n+1": lambda n: 2 * n + 1, "-(2n+1)": lambda n: -(2 * n + 1)}
    for axis in (0, 1):
        for label, fn in amounts.items():
            a = fn(x.shape[axis])
            cases.append(EdgeCase(f"P1-axis{axis}-{label}", "P1", x, (Smem([a]), axis), {},
                                  roll_plain(torch.from_numpy(x), a, axis)))
    x = _edge_rand((47, 33), 61)
    windows = {  # (n, base, stride, bounds, weighted, bcast)
        "k7": (16, 16, 1, (1, 3), False, False),
        "k3-bcast": (8, 0, 1, (2, 7), False, True),
        "k8b-weighted": (16, 16, 0, (1, 3), True, False),
        "empty": (5, 2, 1, (3, 3), False, False),
        "lo>hi": (5, 2, 1, (6, 2), True, False),
        "rows-outside-x": (9, -4, 1, (-3, 5), True, False),  # contribute 0
        "bcast-weighted-no-stride": (3, 40, 0, (-2, 4), True, True),
    }
    for label, (n, base, stride, bounds, weighted, bcast) in windows.items():
        kw = {"weighted": weighted, "bcast": bcast}
        cases.append(EdgeCase(f"P2-{label}", "P2", x, (n, base, stride, Smem(bounds)), kw,
                              row_window_sum_plain(torch.from_numpy(x), n, base, stride, bounds,
                                                   **kw)))
    # P1's 16-byte paths: axis 1 staged at amounts of 1, 2 and 3 mod 4, whole
    # rows as float4s on axis 0, views 4 bytes off (offset 1), 4097x130
    for shape, axis, a, offset in (((33, 128), 1, 1, 0), ((33, 128), 1, 2, 0),
                                   ((33, 128), 1, 131, 0), ((33, 128), 0, 5, 1),
                                   ((33, 128), 1, 6, 1), ((4097, 128), 0, 2049, 0),
                                   ((4097, 130), 0, -7, 0), ((4097, 130), 1, 67, 0)):
        x = _edge_rand(shape, 63)
        off = f"-off{offset}" if offset else ""
        cases.append(EdgeCase(f"P1-axis{axis}-{shape[0]}x{shape[1]}-a{a}{off}", "P1", x,
                              (Smem([a]), axis), {}, roll_plain(torch.from_numpy(x), a, axis),
                              offset))
    x = _edge_rand((64, 129), 62)
    for alpha, beta in ((1.0, 1.0), (2.0, 0.0), (-0.3, 1.7)):
        cases.append(EdgeCase(f"P3-{alpha}x+{beta}", "P3", x, (alpha, beta), {},
                              affine_plain(torch.from_numpy(x), alpha, beta)))
    # P3's head and tail: a view 4 bytes off 16-byte alignment, 315 values
    # (not a multiple of 4), 4097x130
    for shape, offset in (((64, 128), 1), ((7, 45), 0), ((7, 45), 3), ((4097, 130), 0)):
        x = _edge_rand(shape, 64)
        off = f"-off{offset}" if offset else ""
        cases.append(EdgeCase(f"P3-{shape[0]}x{shape[1]}{off}", "P3", x, (-0.3, 1.7), {},
                              affine_plain(torch.from_numpy(x), -0.3, 1.7), offset))
    # P2 on grids too small for the stage (the direct kernel): 4097x130
    # (columns not a multiple of 4), a view 4 bytes off, a 300-term window
    # with rows past x, the zero-padded 9-row box window; stride 0 through
    # its scalar loads; bcast stored to 1000 rows; and 2100 rows, enough
    # tiles for the staged kernel
    big = _edge_rand((4097, 130), 65)
    wide, wide520 = _edge_rand((2100, 512), 69), _edge_rand((2100, 520), 70)
    for label, x, offset, (n, base, stride, bounds, weighted, bcast) in (
            ("4097x130", big, 0, (4000, 50, 1, (-3, 4), True, False)),
            ("33x128-off1", _edge_rand((33, 128), 66), 1, (20, 5, 1, (1, 4), False, False)),
            ("window300-4097x130", big, 0, (600, 3800, 1, (-50, 250), False, False)),
            ("box9-40x33", _edge_rand((40, 33), 67), 0, (40, 0, 1, (-4, 5), False, False)),
            ("stride0-4097x130-off1", big, 1, (4000, -7, 0, (1, 4), True, False)),
            ("bcast-n1000", big, 0, (1000, 100, 1, (5, 17), False, True)),
            # the stage's 16-byte and 4-byte copies, a window of two stages
            ("rows4-2100x512-window40", wide, 0, (2100, -10, 1, (-5, 35), False, False)),
            ("rows4-2100x520-off1", wide520, 1, (2100, 1, 1, (-3, 4), True, False))):
        kw = {"weighted": weighted, "bcast": bcast}
        cases.append(EdgeCase(f"P2-{label}", "P2", x, (n, base, stride, Smem(bounds)), kw,
                              row_window_sum_plain(torch.from_numpy(x), n, base, stride, bounds,
                                                   **kw), offset))
    t = np.arange(-20, 21, dtype=np.int32)
    for m in (1, 3, 8, -3, -8):
        cases.append(EdgeCase(f"P4-m{m}", "P4", t, (m,), {},
                              floor_divmod_plain(torch.from_numpy(t), m)))
    # P4 at the int32 extremes (quotients whose product wraps, |m| = 1), and
    # on 4099 values (row 1 not 16-byte aligned) at and 4 bytes off alignment
    for m in (1, -1, 3, 8, -8, 2 ** 31 - 1):
        cases.append(EdgeCase(f"P4-extremes-m{m}", "P4", INT32_EXTREMES, (m,), {},
                              floor_divmod_plain(torch.from_numpy(INT32_EXTREMES), m)))
    t = np.random.default_rng(68).integers(-2 ** 31, 2 ** 31, 4099).astype(np.int32)
    for offset in (0, 1):
        cases.append(EdgeCase(f"P4-4099{'-off1' * offset}", "P4", t, (-1000,), {},
                              floor_divmod_plain(torch.from_numpy(t), -1000), offset))
    return cases


# P1-P4's edge cases beyond the scripts' inputs, each with its plain
# version's output: roll amounts negative or past the axis on both axes,
# the 16-byte paths with their heads and tails (views 4 bytes off, counts
# not a multiple of 4, 4097x130), empty windows, rows outside x, both
# weight modes, P2's long windows on both of its stride-1 kernels and bcast
# to 1000 rows, t in -20..20 and at the int32 extremes for several
# divisors. The card tests and chip_smoke.py's phase 25 hold the kernels to
# them.
EDGE_CASES = _edge_cases()


def edge_operand(case: EdgeCase, device) -> torch.Tensor:
    """``case.x`` on ``device``: a contiguous view ``case.offset`` values
    into a buffer of its own (a view 4 bytes off 16-byte alignment for an
    offset of 1)."""
    buf = torch.empty(case.x.size + case.offset, dtype=torch.from_numpy(case.x).dtype,
                      device=device)
    x = buf[case.offset:].view(case.x.shape)
    x.copy_(torch.from_numpy(case.x))
    return x


def launch_edge_case(case: EdgeCase, device, on_device: bool = True) -> torch.Tensor:
    """``case`` through its kernel's wrapper on the CUDA ``device``, its
    `Smem` ints as int32 tensors there (``on_device``) or by value. With
    them on the device the call runs under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any copy
    to the host or sync inside the wrapper. Raises unless the call launched
    its kernel exactly once; returns the output on the host."""
    fn = KERNELS[case.kernel]
    args = [(torch.tensor(a, dtype=torch.int32, device=device) if on_device else
             (a[0] if len(a) == 1 else tuple(a))) if isinstance(a, Smem) else a
            for a in case.args]
    x = edge_operand(case, device)
    before = fn.launches
    torch.cuda.synchronize(device)
    if on_device:
        torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(x, *args, **case.kwargs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(device)
    if fn.launches != before + 1:
        raise RuntimeError(f"{case.id}: {fn.launches - before} launches for one call")
    return out.cpu()


def probe_args(probe: Probe, device) -> tuple:
    """The wrapper's positional arguments for ``probe`` on ``device``: the
    script's X, then its arguments with each `Smem` as an int32 tensor."""
    args = [torch.tensor(a, dtype=torch.int32, device=device) if isinstance(a, Smem) else a
            for a in probe.args]
    if probe.x is not None:
        args.insert(0, torch.from_numpy(XS[probe.x]).to(device))
    return tuple(args)


def run_probe(probe: Probe, device) -> torch.Tensor:
    """``probe`` through its kernel's wrapper on ``device``."""
    return KERNELS[probe.kernel](*probe_args(probe, device), **probe.kwargs)


def main(device: str = "cuda") -> list[tuple[str, str, float]]:
    """Every probe run on ``device``; returns (name, location, max error)
    per run and raises `RuntimeError` if any error is not 0."""
    dev = resolve_device(device)
    results = []
    for probe in PROBES:
        got = run_probe(probe, dev).cpu().numpy()
        err = (float(np.abs(got.astype(np.float64) - probe.want).max())
               if got.shape == probe.want.shape else float("inf"))
        print(f"{probe.name} ({probe.where}, {probe.kernel}): max err {err}", flush=True)
        results.append((probe.name, probe.where, err))
    bad = [(name, err) for name, _, err in results if err != 0]
    if bad:
        raise RuntimeError(f"probes with a non-zero error: {bad}")
    print(f"{len(results)} probe runs on {dev}: all exact", flush=True)
    return results


if __name__ == "__main__":
    args = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    if set(args) - {"device"} or len(args) != len(sys.argv) - 1:
        raise SystemExit("usage: python -m smilecode_tpu_torch.probes [device=cpu]")
    main(**args)
