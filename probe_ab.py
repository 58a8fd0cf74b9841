#!/usr/bin/env python3
"""Device time of the probe kernels P1 (roll) and P3 (affine) against other
checkouts' on one NVIDIA card, in turns.

    python3 probe_ab.py --parent DIR [--candidate NAME=DIR ...] [--json PATH]

Each DIR is an unpacked checkout (for example ``git archive <commit> | tar
-x -C _checkout/parent``); its `smilecode_tpu_torch/csrc/probes.cu` and
`common.cu` are built with this checkout's nvcc flags into a library of its
own (`attn_ab.build_checkouts`); this checkout's ("new") is its kernel
library (`kernels/_build.py`). Every build is called the same way,
straight through ctypes on the current stream, with the output allocated
per call as `kernels/probes.py` does.

On each P1 and P3 run of the probe scripts (`probes.PROBES`: 32x128 and
64x128, amounts on the card or by value), on P1 along axis 0 through a view
4 bytes off 16-byte alignment (a path without vectors), and on P1 (both
axes) and P3 at 4097x130, every build is first held to the plain version
bit for bit; then its device us per call (`chip_smoke.device_ms`, 200
calls behind a spin kernel) is taken in turns, parent, new, candidates,
and back, twice. Printed per case: each build's mean and spread (max -
min), the one PyTorch call that computes the same function (`torch.roll`,
``x + 1`` or ``x * alpha``) and, once, an empty kernel's (`torch.cuda._sleep(0)`).
``--json`` also writes the rows to PATH.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np

import chip_smoke as cs
from attn_ab import build_checkouts

UNITS = ("probes.cu", "common.cu")


def entries(lib):
    """(P1, P3) entry points of a built checkout, with argument types."""
    from smilecode_tpu_torch.kernels import probes as kp

    fns = []
    for name, argtypes in (("smilecode_probe_roll", kp._ROLL_ARGTYPES),
                           ("smilecode_probe_affine", kp._AFFINE_ARGTYPES)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns.append(fn)
    return fns


def call(fns, kernel, args):
    """One P1 or P3 launch of a build on ``args`` (the wrapper's)."""
    import torch

    roll, affine = fns
    x = args[0]
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "P1":
        amount, axis = args[1], args[2]
        ptr, val = (amount.data_ptr(), 0) if isinstance(amount, torch.Tensor) else (None, amount)
        code = roll(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], axis, ptr, val, stream)
    else:
        code = affine(x.data_ptr(), out.data_ptr(), x.numel(), args[1], args[2], stream)
    cs.require(code == 0, f"{kernel} launch: CUDA error {code}")
    return out


def cases(device):
    """(label, kernel, wrapper arguments): the scripts' P1 and P3 runs, a
    view 4 bytes off on axis 0, and 4097x130."""
    import torch

    from smilecode_tpu_torch import probes

    out = [(p.name, p.kernel, probes.probe_args(p, device)) for p in probes.PROBES
           if p.kernel in ("P1", "P3")]
    x32 = torch.from_numpy(probes.X32).to(device)
    off = torch.empty(x32.numel() + 1, device=device)[1:].view(x32.shape)
    off.copy_(x32)
    big = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4097, 130)).astype(np.float32)).to(device)
    amount = torch.tensor([3], dtype=torch.int32, device=device)
    return out + [("P1 axis 0, 32x128 view 4 bytes off", "P1", (off, amount, 0)),
                  ("P1 axis 0, 4097x130", "P1", (big, amount, 0)),
                  ("P1 axis 1, 4097x130", "P1", (big, amount, 1)),
                  ("P3 -0.3x+1.7, 4097x130", "P3", (big, -0.3, 1.7))]


def library(kernel, args):
    import torch

    if kernel == "P1":
        shift = -args[1] if isinstance(args[1], int) else -int(args[1].item())
        return lambda: torch.roll(args[0], shift, args[2])
    x, alpha, beta = args
    return (lambda: x + beta) if alpha == 1.0 else (lambda: x * alpha)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--candidate", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_ab: torch.cuda.is_available() is False; this runs on the card")
    from smilecode_tpu_torch.kernels import _build
    from smilecode_tpu_torch.kernels import probes as kp

    card = cs.card_line()
    print(card, flush=True)
    dirs = {"parent": args.parent, **dict(c.split("=", 1) for c in args.candidate)}
    built = {name: entries(lib) for name, (lib, _) in build_checkouts(dirs, UNITS).items()}
    builds = {"parent": built.pop("parent"), "new": entries(_build.library()), **built}
    device = torch.device("cuda:0")
    names = list(builds)
    order = (names + names[::-1]) * 2
    rows = []
    for label, kernel, a in cases(device):
        ref = kp.PLAIN[kernel](*a)
        for name, fns in builds.items():
            cs.require(torch.equal(call(fns, kernel, a), ref), f"{label}: {name} differs")
        t = {name: [] for name in names}
        for name in order:
            t[name].append(cs.device_ms(lambda f=builds[name]: call(f, kernel, a), 200) * 1e3)
        lib_us = cs.device_ms(library(kernel, a), 200) * 1e3
        row = {"case": label, "kernel": kernel, "library_us": lib_us,
               **{f"{n}_us": float(np.mean(v)) for n, v in t.items()},
               **{f"{n}_spread_us": float(np.ptp(v)) for n, v in t.items()}}
        rows.append(row)
        print(f"[{card}] {label}: device us " + ", ".join(
            f"{n} {row[f'{n}_us']:.3f} (spread {row[f'{n}_spread_us']:.3f})" for n in names)
            + f"; library {lib_us:.3f}", flush=True)
    empty = cs.device_ms(lambda: torch.cuda._sleep(0), 200) * 1e3
    print(f"[{card}] empty kernel: device us {empty:.3f}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": rows, "empty_us": empty}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
