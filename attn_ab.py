#!/usr/bin/env python3
"""Device time of the attention kernels K1 and K3 against another checkout's
on one NVIDIA card, in turns.

    python3 attn_ab.py --parent DIR [--candidate NAME=DIR ...] [--levels 1,2] [--sweep]
                       [--json PATH]

DIR is an unpacked checkout of an earlier commit (for example
``git archive <commit> | tar -x -C _checkout/parent``); its
`smilecode_tpu_torch/csrc/modet_attn.cu`, `modet_attn_bwd.cu` and `common.cu`
are built with this checkout's nvcc flags into a library of their own, whose
entry points take the arguments they took before the k-stage redesign (no
brick). At each of ModeT's level shapes of a 160x192x160 pair that
``--levels`` names (1 = full size, 1 head; 2 = half size, 1 head; ...), in
float32 and bf16, both kernels of both builds run on the same seeded inputs:
each new output is first held against its plain version (chip_smoke.py's
tolerances), then the device ms per call (`chip_smoke.device_ms`: calls queued
behind a spin kernel) is taken old, new, new, old. Printed per row: both
means, the bound (`chip_smoke.attn_work`), the new kernel's share of it, its
registers per thread (ptxas) and blocks per SM (from registers, threads and
shared memory). Each ``--candidate`` is another checkout whose kernels take
this checkout's arguments (a variant of the staged design): it is built the
same way, checked the same way and timed against this checkout's kernels,
this, candidate, candidate, this; a candidate named ``diag-*`` leaves out
part of the work (a measurement of that part's cost) and is timed without
the check. ``--sweep`` also times the new kernels
under other bricks (`ATTN_MAX_BH`, `ATTN_MAX_BW`, `ATTN_TARGET_BLOCKS` of
`kernels/modet_attn.py`). ``--json`` also writes the rows to PATH.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import sys

import numpy as np

import chip_smoke as cs

# entry points of the parent build (the signatures before the k stage: no brick arguments)
_OLD_FWD = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_void_p]
_OLD_DQ = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_void_p]
_OLD_ROWS_PER_BLOCK = 256  # the parent K3's drpb partial granularity
SWEEP = [(16, 16, 1024), (16, 16, 4096), (8, 32, 2048), (16, 32, 2048), (32, 16, 2048),
         (8, 16, 2048)]  # (ATTN_MAX_BH, ATTN_MAX_BW, ATTN_TARGET_BLOCKS)


def build_checkouts(dirs):
    """{name: (ctypes library, ptxas log)} of the attention kernels of each
    checkout in ``dirs`` ({name: directory}), built as `kernels/_build.py`
    builds this checkout's."""
    from smilecode_tpu_torch.kernels import _build

    nvcc, libs = _build._nvcc(), {}
    for name, top in dirs.items():
        csrc = os.path.join(top, "smilecode_tpu_torch", "csrc")
        out = os.path.join(top, "_ab_build")
        os.makedirs(out, exist_ok=True)
        cus = [os.path.join(csrc, f) for f in ("modet_attn.cu", "modet_attn_bwd.cu", "common.cu")]
        objs = [os.path.join(out, os.path.basename(c) + ".o") for c in cus]
        lib = os.path.join(out, "libattn.so")
        log = _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-c", "-o", o, c]
                               for c, o in zip(cus, objs)])
        _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        libs[name] = (ctypes.CDLL(lib), log)
    return libs


def registers(log: str):
    """{mangled kernel name: registers per thread} from a ptxas -v log."""
    regs, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
            name = None
    return regs


def find_regs(regs, kernel: str, bf16: bool, max_hd=8, pairs=None):
    tname = "13__nv_bfloat16" if bf16 else "f"
    want = f"{kernel}I{tname}Li{max_hd}E" + ("" if pairs is None else f"Lb{int(pairs)}E")
    hits = [r for n, r in regs.items() if want in n]
    return hits[0] if hits else None


def blocks_per_sm(regs, threads, smem):
    """Resident blocks per H100 SM from registers (256-register warp
    granules of 64K), shared memory (228 KB, 1 KB reserved per block),
    2048 threads and 32 blocks."""
    if regs is None:
        return None
    warps = -(-threads // 32)
    by_regs = (65536 // (-(-regs * 32 // 256) * 256)) // warps
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 2048 // threads, 32)


def smem_bytes(kernel, shape, isz):
    """Dynamic shared memory of a new K1 or K3 block (csrc/attn_tile.cuh,
    modet_attn_bwd.cu:dq_smem_bytes)."""
    from smilecode_tpu_torch.kernels.modet_attn import attn_geometry

    heads, hd = shape[4], shape[5]
    bh, bw, _, _ = attn_geometry(shape, isz)
    ring = 4 * (-(-(bh + 2) * (bw + 2) * heads * hd * isz // 16) * 16)
    if kernel == "K1":
        return ring + heads * 27 * 4
    v = 16 // isz
    stride = (bw * heads * 27 + 2 * v - 1) // v * v
    return ring + (bh * stride + heads * 27 * 9) * 4


def kernel_fns(lib, old: bool):
    """(K1, K3) entry points of a built checkout by dtype, with their
    argument types: the parent's (``old``) or this checkout's."""
    import torch

    from smilecode_tpu_torch.kernels import modet_attn as ma

    fns = []
    for base, argtypes in (("smilecode_modet_attn_fwd", _OLD_FWD if old else ma._FWD_ARGTYPES),
                           ("smilecode_modet_attn_bwd_dq", _OLD_DQ if old else ma._DQ_ARGTYPES)):
        by_dtype = {}
        for dt, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            fn = getattr(lib, base + sfx)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            by_dtype[dt] = fn
        fns.append(by_dtype)
    return fns


def call_k1(fn, old, q, k, rpb):
    import torch

    from smilecode_tpu_torch.kernels import modet_attn as ma

    b, d, h, w, heads, hd = q.shape
    out = torch.empty((b, d, h, w, heads * 3), dtype=q.dtype, device=q.device)
    extra = () if old else ma._launch_args(q, k)
    code = fn[q.dtype](q.data_ptr(), k.data_ptr(), rpb.data_ptr(), out.data_ptr(), b, d, h, w,
                       heads, hd, 1.0, *extra, torch.cuda.current_stream().cuda_stream)
    cs.require(code == 0, f"K1 launch: CUDA error {code}")
    return out


def call_k3(fn, old, q, k, rpb, g):
    import torch

    from smilecode_tpu_torch.kernels import modet_attn as ma

    b, d, h, w, heads, hd = q.shape
    dq = torch.empty_like(q)
    dl = torch.empty((b, d, h, w, heads, 27), dtype=q.dtype, device=q.device)
    blocks = (-(-b * d * h * w * heads // _OLD_ROWS_PER_BLOCK) if old
              else ma.attn_geometry(q.shape, q.element_size())[3])
    part = torch.empty((blocks, heads, 27), device=q.device)
    extra = () if old else ma._launch_args(q, k)
    code = fn[q.dtype](q.data_ptr(), k.data_ptr(), rpb.data_ptr(), g.data_ptr(), dq.data_ptr(),
                       dl.data_ptr(), part.data_ptr(), b, d, h, w, heads, hd, 1.0, *extra,
                       torch.cuda.current_stream().cuda_stream)
    cs.require(code == 0, f"K3 launch: CUDA error {code}")
    return dq, dl, part


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--candidate", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--levels", default="1,2")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attn_ab: torch.cuda.is_available() is False; this runs on the card")
    from smilecode_tpu_torch.kernels import _build, modet_attn as ma

    card = cs.card_line()
    print(card, flush=True)
    _build.library()
    dirs = {"parent": args.parent, **dict(c.split("=", 1) for c in args.candidate)}
    built = build_checkouts(dirs)
    regs = {name: registers(log) for name, (_, log) in built.items()}
    regs["new"] = registers(_build.build_info["log"])
    fns = {name: kernel_fns(lib, name == "parent") for name, (lib, _) in built.items()}
    runs = {name: (lambda q, k, r, f=f, old=name == "parent": call_k1(f[0], old, q, k, r),
                   lambda q, k, r, g, f=f, old=name == "parent": call_k3(f[1], old, q, k, r, g))
            for name, f in fns.items()}
    runs["new"] = (lambda q, k, r: ma.modet_attention(q, k, r.reshape(-1, 3, 3, 3), 1.0),
                   lambda q, k, r, g: ma.modet_attention_bwd_dq(q, k, r.reshape(-1, 3, 3, 3), 1.0, g))
    device = torch.device("cuda:0")

    rows, sweep_rows = [], []
    rng = np.random.default_rng(11)
    for level in (int(x) for x in args.levels.split(",")):
        heads = cs.NUM_HEADS[5 - level]
        shape = (1, *cs.level_shape(level), heads, cs.HEAD_DIM)
        q32, k32 = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)
                    for _ in range(2))
        rpb = torch.from_numpy(rng.standard_normal((heads, 27), dtype=np.float32) * 0.5).to(device)
        g32 = torch.from_numpy(rng.standard_normal((*shape[:4], heads * 3),
                                                   dtype=np.float32)).to(device)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, g = q32.to(dtype), k32.to(dtype), g32.to(dtype)
            isz = q.element_size()
            dname = str(dtype).split(".")[1]
            r4 = rpb.reshape(heads, 3, 3, 3)
            bf = dtype == torch.bfloat16
            ref = ma.modet_attention_plain(q, k, r4, 1.0).float()
            p_dq, p_dl, p_drpb = ma.modet_attention_bwd_dq_plain(q, k, r4, 1.0, g)
            drpb_lim = cs.DRPB_TOL * float(p_dl.float().abs().sum(dim=(0, 1, 2, 3)).max())
            for name, (k1, k3) in runs.items():  # every build but diag-* against the plain versions
                if name.startswith("diag"):  # a variant that leaves out work, timed only
                    continue
                err = float((k1(q, k, rpb).float() - ref).abs().max())
                lim = (cs.BF16_TOL if bf else cs.ATTN_TOL) * max(1.0, float(ref.abs().max()))
                cs.require(err <= lim, f"K1 {name} {dname} level {level}: {err} > {lim}")
                dq, dl, part = k3(q, k, rpb, g)
                for what, a, b in (("dq", dq, p_dq), ("dl", dl, p_dl)):
                    b = b.float()
                    err = float((a.float() - b).abs().max())
                    lim = (cs.BF16_TOL if bf else cs.BWD_TOL) * float(b.abs().max())
                    cs.require(err <= lim, f"K3 {name} {what} {dname} level {level}: {err} > {lim}")
                err = float((part.sum(0).reshape(p_drpb.shape) - p_drpb).abs().max())
                cs.require(err <= drpb_lim, f"K3 {name} drpb {dname} level {level}: {err} > {drpb_lim}")
            del ref, p_dq, p_dl, p_drpb, dq, dl, part
            torch.cuda.empty_cache()
            for ki, kernel in enumerate(("K1", "K3")):
                calls = {name: (lambda f=r[ki]: f(q, k, rpb)) if ki == 0 else
                         (lambda f=r[ki]: f(q, k, rpb, g)) for name, r in runs.items()}
                bound_ms = cs.bound(*cs.attn_work(kernel, shape, isz))[0]
                kname = "modet_attn_fwd_kernel" if kernel == "K1" else "modet_attn_bwd_dq_kernel"
                bh, bw, cd, blocks = ma.attn_geometry(shape, isz)
                smem = smem_bytes(kernel, shape, isz)
                for other in [n for n in runs if n != "new"]:
                    order = (other, "new", "new", other)
                    t = [cs.device_ms(calls[n]) for n in order]
                    other_ms, new_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
                    new_regs = find_regs(regs["new"], kname, bf, pairs=True)
                    oregs = find_regs(regs[other], kname, bf, pairs=None if other == "parent" else True)
                    old_smem = (27 * 257 * 4 if kernel == "K3" else 0) if other == "parent" else smem
                    row = {"kernel": kernel, "dtype": dname, "level": level, "shape": list(shape),
                           "against": other, "other_ms": other_ms, "new_ms": new_ms,
                           "times_in_turns": t, "bound_ms": bound_ms, "share": bound_ms / new_ms,
                           "other_share": bound_ms / other_ms, "brick": [bh, bw, cd],
                           "blocks": blocks, "regs": new_regs, "other_regs": oregs,
                           "smem": smem,
                           "blocks_per_sm": blocks_per_sm(new_regs, bh * bw * heads, smem),
                           "other_blocks_per_sm": blocks_per_sm(
                               oregs, 256 if other == "parent" else bh * bw * heads, old_smem)}
                    rows.append(row)
                    print(f"[{card}] {kernel} {dname} level {level} {shape}: device ms {other} "
                          f"{other_ms:.4f}, new {new_ms:.4f} (in turns "
                          f"{', '.join(f'{x:.4f}' for x in t)}); bound {bound_ms:.4f}, share new "
                          f"{row['share']:.3f}, {other} {row['other_share']:.3f}; brick "
                          f"{bh}x{bw}x{cd}, {blocks} blocks, smem {smem} B; regs new {new_regs}, "
                          f"{other} {oregs}; blocks/SM new {row['blocks_per_sm']}, {other} "
                          f"{row['other_blocks_per_sm']}", flush=True)
            if args.sweep:
                saved = (ma.ATTN_MAX_BH, ma.ATTN_MAX_BW, ma.ATTN_TARGET_BLOCKS)
                for bh_max, bw_max, target in SWEEP:
                    ma.ATTN_MAX_BH, ma.ATTN_MAX_BW, ma.ATTN_TARGET_BLOCKS = bh_max, bw_max, target
                    geo = ma.attn_geometry(shape, isz)
                    t1 = cs.device_ms(lambda: ma.modet_attention(q, k, r4, 1.0))
                    t3 = cs.device_ms(lambda: ma.modet_attention_bwd_dq(q, k, r4, 1.0, g))
                    sweep_rows.append({"dtype": dname, "level": level,
                                       "caps": [bh_max, bw_max, target], "geometry": list(geo),
                                       "K1_ms": t1, "K3_ms": t3})
                    print(f"  sweep {dname} level {level} caps bh<={bh_max} bw<={bw_max} target "
                          f"{target} -> brick {geo}: K1 {t1:.4f} ms, K3 {t3:.4f} ms", flush=True)
                ma.ATTN_MAX_BH, ma.ATTN_MAX_BW, ma.ATTN_TARGET_BLOCKS = saved
            del q, k, g
            torch.cuda.empty_cache()
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": rows, "sweep": sweep_rows}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
