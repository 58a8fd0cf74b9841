#!/usr/bin/env python3
"""Device time of the warp kernels K2 and K5 against another checkout's on
one NVIDIA card, in turns.

    python3 warp_ab.py --parent DIR [--rounds 3] [--json PATH]

DIR is an unpacked checkout of an earlier commit (for example
``git archive <commit> | tar -x -C _checkout/parent``); its
`smilecode_tpu_torch/csrc/warp3d.cu`, `warp3d_bwd.cu` and `common.cu` are
built with this checkout's nvcc flags into a library of their own
(`attn_ab.build_checkouts`). Both builds' entry points take this
checkout's arguments, the D origin ``d0 = 0`` as ModeT's unsharded path
passes it, and are called the same way, straight through ctypes, with the
allocations `kernels/warp3d.py` makes (K5's d_src zeroed per call).

At each of the nine warps of a ModeT pair at 160x192x160
(`chip_smoke.warp_calls`), float32, on a smooth +-5 voxel flow, both
builds' K2 and K5 (with the d_src scatter but for the moved image's, as a
training step runs it) are first held against the plain versions
(chip_smoke.py's tolerances); then each kernel's device ms per call
(`chip_smoke.device_ms`) is taken parent, new, new, parent, ``--rounds``
times. Printed: per warp shape the two means; per pair (K2) and per step
(K5) each build's sum over the nine warps for each of its 2 x rounds
samples, their mean and spread (max - min), and new - parent. ``--json``
also writes them to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

import chip_smoke as cs
from attn_ab import build_checkouts

UNITS = ("warp3d.cu", "warp3d_bwd.cu", "common.cu")


def warp_fns(lib):
    """(K2, K5) float32 entry points of a built checkout with this
    checkout's argument types."""
    from smilecode_tpu_torch.kernels import _build, warp3d

    fns = []
    for name, argtypes in (("smilecode_warp3d_trilinear_fwd", warp3d._FWD_ARGTYPES),
                           ("smilecode_warp3d_trilinear_bwd", warp3d._BWD_ARGTYPES)):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _build.ctypes.c_int
        fns.append(fn)
    return fns


def caller(lib):
    """{"K2": f(src, flow), "K5": f(src, flow, g, want_dsrc)} calling the
    build's entry points directly on the current stream."""
    import torch

    from smilecode_tpu_torch.kernels.warp3d import _lanes_per_voxel, _scale

    k2, k5 = warp_fns(lib)

    def fwd(src, flow):
        b, sd, sh, sw, c = src.shape
        out = torch.empty((b, *flow.shape[1:4], c), dtype=src.dtype, device=src.device)
        lanes = _lanes_per_voxel(c, 4, src.data_ptr(), out.data_ptr())
        code = k2(src.data_ptr(), flow.data_ptr(), out.data_ptr(), b, sd, sh, sw, c, lanes,
                  *flow.shape[1:4], 0, *_scale(src, flow),
                  torch.cuda.current_stream().cuda_stream)
        cs.require(code == 0, f"K2 launch: CUDA error {code}")
        return out

    def bwd(src, flow, g, want_dsrc):
        b, sd, sh, sw, c = src.shape
        d_flow = torch.empty_like(flow)
        d_src = torch.zeros(src.shape, dtype=torch.float32, device=src.device) if want_dsrc \
            else None
        ptrs = (src.data_ptr(), g.data_ptr()) + ((d_src.data_ptr(),) if want_dsrc else ())
        code = k5(src.data_ptr(), flow.data_ptr(), g.data_ptr(),
                  d_src.data_ptr() if want_dsrc else None, d_flow.data_ptr(), b, sd, sh, sw, c,
                  _lanes_per_voxel(c, 4, *ptrs), *flow.shape[1:4], 0, *_scale(src, flow),
                  torch.cuda.current_stream().cuda_stream)
        cs.require(code == 0, f"K5 launch: CUDA error {code}")
        return d_src, d_flow

    return {"K2": fwd, "K5": bwd}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("warp_ab: torch.cuda.is_available() is False; this runs on the card")
    from smilecode_tpu_torch.kernels import _build
    from smilecode_tpu_torch.kernels.warp3d import (
        warp3d_trilinear_bwd_plain,
        warp3d_trilinear_plain,
    )

    card = cs.card_line()
    print(card, flush=True)
    (parent_lib, _), = build_checkouts({"parent": args.parent}, UNITS).values()
    runs = {"parent": caller(parent_lib), "new": caller(_build.library())}
    device = torch.device("cuda:0")
    rng = np.random.default_rng(2)
    order = ("parent", "new", "new", "parent") * args.rounds
    rows, samples = [], {(kernel, name): np.zeros(len(order) // 2)
                         for kernel in ("K2", "K5") for name in runs}
    shapes = {}
    for what, c, level in cs.warp_calls():
        key = (c, level, what != "moved image")
        shapes[key] = shapes.get(key, 0) + 1
    for (c, level, want_dsrc), mult in shapes.items():
        shape = cs.level_shape(level)
        src = torch.from_numpy(rng.standard_normal((1, *shape, c), dtype=np.float32)).to(device)
        g = torch.from_numpy(rng.standard_normal((1, *shape, c), dtype=np.float32)).to(device)
        flow = cs.smooth_flow(shape, 5.0, device)
        ref = warp3d_trilinear_plain(src, flow)
        p_src, p_flow = warp3d_trilinear_bwd_plain(src, flow, g, want_dsrc)
        for name, run in runs.items():
            err = float((run["K2"](src, flow) - ref).abs().max())
            tol = cs.WARP_TOL * float(src.abs().max())
            cs.require(err <= tol, f"K2 {name} C={c} {shape}: {err} > {tol}")
            d_src, d_flow = run["K5"](src, flow, g, want_dsrc)
            for what, a, b in (("d_flow", d_flow, p_flow),) + (
                    (("d_src", d_src, p_src),) if want_dsrc else ()):
                err, tol = float((a - b).abs().max()), cs.BWD_TOL * float(b.abs().max())
                cs.require(err <= tol, f"K5 {name} {what} C={c} {shape}: {err} > {tol}")
        for kernel, call in (("K2", lambda f: f(src, flow)),
                             ("K5", lambda f: f(src, flow, g, want_dsrc))):
            t = [cs.device_ms(lambda n=n: call(runs[n][kernel])) for n in order]
            by = {name: np.array([x for n, x in zip(order, t) if n == name]) for name in runs}
            for name, v in by.items():
                samples[(kernel, name)] += mult * v
            row = {"kernel": kernel, "c": c, "shape": list(shape), "d_src": want_dsrc,
                   "calls": mult, "times_in_turns": t,
                   **{f"{name}_ms": float(v.mean()) for name, v in by.items()}}
            rows.append(row)
            print(f"[{card}] {kernel} C={c} {shape}{'' if want_dsrc else ' without d_src'} "
                  f"x{mult}: device ms parent {row['parent_ms']:.4f}, new {row['new_ms']:.4f} "
                  f"(in turns {', '.join(f'{x:.4f}' for x in t)})", flush=True)
        del src, g, flow, ref, p_src, p_flow
        torch.cuda.empty_cache()
    totals = {}
    for (kernel, name), v in samples.items():
        totals[f"{kernel} {name}"] = {"samples": v.tolist(), "mean": float(v.mean()),
                                      "spread": float(v.max() - v.min())}
    for kernel, per in (("K2", "pair"), ("K5", "step")):
        p, n = totals[f"{kernel} parent"], totals[f"{kernel} new"]
        print(f"[{card}] {kernel} device ms per {per} over the nine warps: parent {p['mean']:.4f} "
              f"(spread {p['spread']:.4f}), new {n['mean']:.4f} (spread {n['spread']:.4f}); "
              f"new - parent {n['mean'] - p['mean']:+.4f}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": rows, "totals": totals}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
