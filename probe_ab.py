#!/usr/bin/env python3
"""Device time of the probe kernels P1-P4 against other checkouts' on one
NVIDIA card, in turns.

    python3 probe_ab.py --parent DIR [--candidate NAME=DIR ...] [--kernels P1,P2,P3,P4]
                        [--json PATH]

Each DIR is an unpacked checkout (for example ``git archive <commit> | tar
-x -C _checkout/parent``); its `smilecode_tpu_torch/csrc/probes.cu` and
`common.cu` are built with this checkout's nvcc flags into a library of its
own (`attn_ab.build_checkouts`); this checkout's ("new") is its kernel
library (`kernels/_build.py`). Each build's entry points are bound with the
argument types of that checkout's own `kernels/probes.py` (P2's entry took
13 arguments before its flags were packed into one, P4's count was a C
``int``), and every build is called the same way, straight through ctypes
on the current stream, with the output allocated per call as
`kernels/probes.py` does.

Cases: each run of the probe scripts (`probes.PROBES`: 32x128 and 64x128,
amounts and bounds on the card or by value); P1 along axis 0 through a view
4 bytes off 16-byte alignment (a path without vectors); P1 (both axes), P2
(a k7 window, bounds on the card) and P3 at 4097x130; and P2 and P4 at one
160x192x160 volume's size (`chip_smoke.sized_cases`). Every build is first
held to the plain version bit for bit; then its device us per call
(`chip_smoke.device_ms`, 200 calls behind a spin kernel) is taken in turns,
parent, new, candidates, and back, twice. Printed per case: each build's
mean and spread (max - min), the PyTorch call that computes the same
function where there is one (`torch.roll`, ``x + 1`` or ``x * alpha``,
P2's unfold sum on its by-value runs or `F.avg_pool2d` at the volume's
size, P4's pair `torch.div` floor and `torch.remainder`) and, once, an
empty kernel's (`torch.cuda._sleep(0)`). ``--json`` also writes the rows to
PATH.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import sys

import numpy as np

import chip_smoke as cs
from attn_ab import build_checkouts

UNITS = ("probes.cu", "common.cu")
ENTRIES = {"P1": ("smilecode_probe_roll", "_ROLL_ARGTYPES"),
           "P2": ("smilecode_probe_row_window", "_WINDOW_ARGTYPES"),
           "P3": ("smilecode_probe_affine", "_AFFINE_ARGTYPES"),
           "P4": ("smilecode_probe_floor_divmod", "_DIVMOD_ARGTYPES")}


def wrapper_module(top):
    """`kernels/probes.py` of the checkout at ``top`` (None: this one), for
    its argument types."""
    if top is None:
        from smilecode_tpu_torch.kernels import probes as kp

        return kp
    path = os.path.join(top, "smilecode_tpu_torch", "kernels", "probes.py")
    spec = importlib.util.spec_from_file_location(f"_probes_ab_{abs(hash(top))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entries(lib, top=None):
    """{kernel: entry point} of a built checkout, typed as that checkout's
    wrappers type them."""
    mod = wrapper_module(top)
    fns = {}
    for kernel, (name, types) in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = getattr(mod, types), ctypes.c_int
        fns[kernel] = fn
    return fns


def call(fns, kernel, args, kwargs):
    """One launch of a build's ``kernel`` on ``args`` and ``kwargs`` (the
    wrapper's)."""
    import torch

    fn, x = fns[kernel], args[0]
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "P1":
        out = torch.empty_like(x)
        amount, axis = args[1], args[2]
        ptr, val = (amount.data_ptr(), 0) if isinstance(amount, torch.Tensor) else (None, amount)
        code = fn(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], axis, ptr, val, stream)
    elif kernel == "P2":
        n, base, stride, bounds = args[1:]
        out = torch.empty((n, x.shape[1]), device=x.device)
        ptr, (lo, hi) = ((bounds.data_ptr(), (0, 0)) if isinstance(bounds, torch.Tensor)
                         else (None, bounds))
        weighted, bcast = int(kwargs.get("weighted", False)), int(kwargs.get("bcast", False))
        mode = ((stride | 2 * weighted | 4 * bcast,) if len(fn.argtypes) == 11
                else (stride, weighted, bcast))  # before the flags were packed
        code = fn(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], n, base, *mode, ptr, lo,
                  hi, stream)
    elif kernel == "P3":
        out = torch.empty_like(x)
        code = fn(x.data_ptr(), out.data_ptr(), x.numel(), args[1], args[2], stream)
    else:
        out = torch.empty((2, x.numel()), dtype=torch.int32, device=x.device)
        code = fn(x.data_ptr(), out.data_ptr(), x.numel(), args[1], stream)
    cs.require(code == 0, f"{kernel} launch: CUDA error {code}")
    return out


def cases(device):
    """(label, kernel, wrapper arguments, keyword arguments, library call or
    None)."""
    import torch

    from smilecode_tpu_torch import probes

    out = []
    for p in probes.PROBES:
        args = probes.probe_args(p, device)
        lib = cs.probe_library(p, args)
        if p.kernel == "P4":
            lib = lambda a=args: cs.floor_divmod_pair(*a)  # noqa: E731
        out.append((p.name, p.kernel, args, p.kwargs, lib))
    x32 = torch.from_numpy(probes.X32).to(device)
    off = torch.empty(x32.numel() + 1, device=device)[1:].view(x32.shape)
    off.copy_(x32)
    big = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4097, 130)).astype(np.float32)).to(device)
    amount = torch.tensor([3], dtype=torch.int32, device=device)
    bounds = torch.tensor([1, 3], dtype=torch.int32, device=device)
    out += [("P1 axis 0, 32x128 view 4 bytes off", "P1", (off, amount, 0), {},
             lambda: torch.roll(off, -3, 0)),
            ("P1 axis 0, 4097x130", "P1", (big, amount, 0), {}, lambda: torch.roll(big, -3, 0)),
            ("P1 axis 1, 4097x130", "P1", (big, amount, 1), {}, lambda: torch.roll(big, -3, 1)),
            ("P2 k7 window, 4097x130", "P2", (big, 4000, 16, 1, bounds), {}, None),
            ("P3 -0.3x+1.7, 4097x130", "P3", (big, -0.3, 1.7), {}, None)]
    return out + [(label, kernel, args, {}, lib)
                  for label, kernel, args, lib, _ in cs.sized_cases(device)]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--candidate", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--kernels", default="P1,P2,P3,P4")
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_ab: torch.cuda.is_available() is False; this runs on the card")
    from smilecode_tpu_torch.kernels import _build
    from smilecode_tpu_torch.kernels import probes as kp

    card = cs.card_line()
    print(card, flush=True)
    dirs = {"parent": args.parent, **dict(c.split("=", 1) for c in args.candidate)}
    built = {name: entries(lib, dirs[name])
             for name, (lib, _) in build_checkouts(dirs, UNITS).items()}
    builds = {"parent": built.pop("parent"), "new": entries(_build.library()), **built}
    device = torch.device("cuda:0")
    names = list(builds)
    order = (names + names[::-1]) * 2
    wanted = set(args.kernels.split(","))
    rows = []
    for label, kernel, a, kw, lib in cases(device):
        if kernel not in wanted:
            continue
        ref = kp.PLAIN[kernel](*a, **kw)
        for name, fns in builds.items():
            cs.require(torch.equal(call(fns, kernel, a, kw), ref), f"{label}: {name} differs")
        t = {name: [] for name in names}
        for name in order:
            t[name].append(cs.device_ms(lambda f=builds[name]: call(f, kernel, a, kw), 200) * 1e3)
        lib_us = cs.device_ms(lib, 200) * 1e3 if lib is not None else None
        row = {"case": label, "kernel": kernel, "library_us": lib_us,
               **{f"{n}_us": float(np.mean(v)) for n, v in t.items()},
               **{f"{n}_spread_us": float(np.ptp(v)) for n, v in t.items()}}
        rows.append(row)
        print(f"[{card}] {label}: device us " + ", ".join(
            f"{n} {row[f'{n}_us']:.3f} (spread {row[f'{n}_spread_us']:.3f})" for n in names)
            + ("; library " + (f"{lib_us:.3f}" if lib_us is not None else "none")), flush=True)
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
