#!/usr/bin/env python3
"""Device time of the attention kernels K1, K3 and K4 against another
checkout's on one NVIDIA card, in turns.

    python3 attn_ab.py --parent DIR [--candidate NAME=DIR ...] [--levels 1,2]
                       [--kernels K1,K3,K4] [--sweep] [--json PATH]

DIR is an unpacked checkout of an earlier commit (for example
``git archive <commit> | tar -x -C _checkout/parent``); its
`smilecode_tpu_torch/csrc/modet_attn.cu`, `modet_attn_bwd.cu` and `common.cu`
are built with this checkout's nvcc flags into a library of their own, whose
K1, K3 and K4 take this checkout's arguments. At each of ModeT's level
shapes of a 160x192x160 pair that ``--levels`` names (1 = full size, 1
head; 2 = half size, 1 head; ...), in float32 and bf16, the kernels of
``--kernels`` of both builds run on the same seeded inputs (K4 on the plain
version's dl): each output is first held
against its plain version (chip_smoke.py's tolerances), then the device ms
per call (`chip_smoke.device_ms`: calls queued behind a spin kernel) is taken
old, new, new, old. Printed per row: both means, the bound
(`chip_smoke.attn_work`), the new kernel's share of it, its registers per
thread (ptxas) and blocks per SM (from registers, threads and shared memory).
Each ``--candidate`` is another checkout whose kernels all take this
checkout's arguments (a variant of the staged design): it is built the same
way, checked the same way and timed against this checkout's kernels, this,
candidate, candidate, this; a candidate named ``diag-*`` leaves out part of
the work (a measurement of that part's cost) and is timed without the check.
``--sweep`` also times the new kernels under other bricks (`ATTN_MAX_BH`,
`ATTN_MAX_BW`, `ATTN_TARGET_BLOCKS` for K1 and K3; `K4_MAX_BH`, `K4_MAX_BW`,
`K4_TARGET_BLOCKS` for K4; all in `kernels/modet_attn.py`). ``--json`` also
writes the rows to PATH.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

import chip_smoke as cs

SWEEP = [(16, 16, 1024), (16, 16, 4096), (8, 32, 2048), (16, 32, 2048), (32, 16, 2048),
         (8, 16, 2048)]  # (ATTN_MAX_BH, ATTN_MAX_BW, ATTN_TARGET_BLOCKS)
SWEEP_K4 = [(8, 32, 1024, 1), (8, 32, 1024, 2), (8, 32, 1024, 3), (8, 32, 1024, 4),
            (8, 32, 2048, 1), (8, 16, 1024, 2), (4, 32, 1024, 2)]
# (K4_MAX_BH, K4_MAX_BW, K4_TARGET_BLOCKS, K4_MIN_CHUNK)
KERNEL_NAMES = {"K1": "modet_attn_fwd_kernel", "K3": "modet_attn_bwd_dq_kernel",
                "K4": "modet_attn_bwd_dk_kernel"}


def build_checkouts(dirs, units=("modet_attn.cu", "modet_attn_bwd.cu", "common.cu")):
    """{name: (ctypes library, ptxas log)} of the kernels in ``units`` (the
    attention kernels by default) of each checkout in ``dirs`` ({name:
    directory}), built as `kernels/_build.py` builds this checkout's."""
    from smilecode_tpu_torch.kernels import _build

    nvcc, jobs = _build._nvcc(), {}
    stem = os.path.splitext(units[0])[0]  # the library's name
    for name, top in dirs.items():
        csrc = os.path.join(top, "smilecode_tpu_torch", "csrc")
        out = os.path.join(top, "_ab_build")
        os.makedirs(out, exist_ok=True)
        cus = [os.path.join(csrc, f) for f in units]
        jobs[name] = (out, [(c, os.path.join(out, os.path.basename(c) + ".o")) for c in cus])
    # every object of every checkout compiles at once, then each links
    procs = [(name, subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", o, c], text=True,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
             for name, (_, units) in jobs.items() for c, o in units]
    logs = {name: "" for name in jobs}
    for name, proc in procs:
        logs[name] += proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
    libs = {}
    for name, (out, objs) in jobs.items():
        lib = os.path.join(out, f"lib{stem}.so")
        _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib, *(o for _, o in objs)]])
        libs[name] = (ctypes.CDLL(lib), logs[name])
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


def geometry(kernel, shape, isz):
    """(bh, bw, cd, blocks, dynamic shared memory) of a new K1, K3 or K4
    block (csrc/attn_tile.cuh, modet_attn_bwd.cu)."""
    from smilecode_tpu_torch.kernels import modet_attn as ma

    heads, hd = shape[4], shape[5]
    if kernel == "K4":
        bh, bw, cd, blocks = ma.dk_geometry(shape, isz)
        return bh, bw, cd, blocks, ma.dk_ring_bytes(bh, bw, heads, hd, isz) + 16  # + 2 mbarriers
    bh, bw, cd, blocks = ma.attn_geometry(shape, isz)
    ring = 4 * (-(-(bh + 2) * (bw + 2) * heads * hd * isz // 16) * 16)
    if kernel == "K1":
        return bh, bw, cd, blocks, ring + heads * 27 * 4
    v = 16 // isz
    stride = (bw * heads * 27 + 2 * v - 1) // v * v
    return bh, bw, cd, blocks, ring + (bh * stride + heads * 27 * 9) * 4


def kernel_fns(lib):
    """{kernel: {dtype: entry point}} of a built checkout, with this
    checkout's argument types."""
    import torch

    from smilecode_tpu_torch.kernels import modet_attn as ma

    fns = {}
    for kernel, base, argtypes in (("K1", "smilecode_modet_attn_fwd", ma._FWD_ARGTYPES),
                                   ("K3", "smilecode_modet_attn_bwd_dq", ma._DQ_ARGTYPES),
                                   ("K4", "smilecode_modet_attn_bwd_dk", ma._DK_ARGTYPES)):
        fns[kernel] = {}
        for dt, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            fn = getattr(lib, base + sfx)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[kernel][dt] = fn
    return fns


def call_k1(fn, q, k, rpb):
    import torch

    from smilecode_tpu_torch.kernels import modet_attn as ma

    b, d, h, w, heads, hd = q.shape
    out = torch.empty((b, d, h, w, heads * 3), dtype=q.dtype, device=q.device)
    code = fn[q.dtype](q.data_ptr(), k.data_ptr(), rpb.data_ptr(), out.data_ptr(), b, d, h, w,
                       heads, hd, 1.0, *ma._launch_args(q, k), 0,
                       torch.cuda.current_stream().cuda_stream)
    cs.require(code == 0, f"K1 launch: CUDA error {code}")
    return out


def call_k3(fn, q, k, rpb, g):
    import torch

    from smilecode_tpu_torch.kernels import modet_attn as ma

    b, d, h, w, heads, hd = q.shape
    dq = torch.empty_like(q)
    dl = torch.empty((b, d, h, w, heads, 27), dtype=q.dtype, device=q.device)
    part = torch.empty((ma.attn_geometry(q.shape, q.element_size())[3], heads, 27),
                       device=q.device)
    code = fn[q.dtype](q.data_ptr(), k.data_ptr(), rpb.data_ptr(), g.data_ptr(), dq.data_ptr(),
                       dl.data_ptr(), part.data_ptr(), b, d, h, w, heads, hd, 1.0,
                       *ma._launch_args(q, k), 0, torch.cuda.current_stream().cuda_stream)
    cs.require(code == 0, f"K3 launch: CUDA error {code}")
    return dq, dl, part


def call_k4(fn, q, dl):
    import torch

    from smilecode_tpu_torch.kernels import modet_attn as ma

    b, d, h, w, heads, hd = q.shape
    dk = torch.empty_like(q)
    code = fn[q.dtype](q.data_ptr(), dl.data_ptr(), dk.data_ptr(), b, d, h, w, heads, hd, 1.0,
                       *ma.dk_geometry(q.shape, q.element_size())[:3], 0,
                       torch.cuda.current_stream().cuda_stream)
    cs.require(code == 0, f"K4 launch: CUDA error {code}")
    return dk


def sweep(ma, caps, names, dname, level, shape, isz, calls):
    """Device ms of ``calls`` ({kernel: fn}) under each (max bh, max bw,
    target blocks[, min chunk]) of ``caps``, set on the module globals
    ``names``."""
    rows, saved = [], tuple(getattr(ma, n) for n in names)
    geo_fn = ma.dk_geometry if "K4_MAX_BH" in names else ma.attn_geometry
    for cap in caps:
        for n, v in zip(names, cap):
            setattr(ma, n, v)
        geo = geo_fn(shape, isz)
        row = {"dtype": dname, "level": level, "caps": list(cap), "geometry": list(geo),
               **{f"{key}_ms": cs.device_ms(fn) for key, fn in calls.items()}}
        rows.append(row)
        print(f"  sweep {dname} level {level} caps {dict(zip(names, cap))} -> "
              f"brick {geo}: " + ", ".join(f"{key} {row[f'{key}_ms']:.4f} ms" for key in calls),
              flush=True)
    for n, v in zip(names, saved):
        setattr(ma, n, v)
    return rows


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--candidate", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--levels", default="1,2")
    ap.add_argument("--kernels", default="K1,K3,K4")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attn_ab: torch.cuda.is_available() is False; this runs on the card")
    from smilecode_tpu_torch.kernels import _build, modet_attn as ma

    kernels = args.kernels.split(",")
    card = cs.card_line()
    print(card, flush=True)
    _build.library()
    dirs = {"parent": args.parent, **dict(c.split("=", 1) for c in args.candidate)}
    built = build_checkouts(dirs)
    regs = {name: registers(log) for name, (_, log) in built.items()}
    regs["new"] = registers(_build.build_info["log"])
    runs = {}
    for name, (lib, _) in built.items():
        f = kernel_fns(lib)
        runs[name] = {"K1": lambda q, k, r, dl, g, f=f: call_k1(f["K1"], q, k, r),
                      "K3": lambda q, k, r, dl, g, f=f: call_k3(f["K3"], q, k, r, g),
                      "K4": lambda q, k, r, dl, g, f=f: call_k4(f["K4"], q, dl)}
    runs["new"] = {
        "K1": lambda q, k, r, dl, g: ma.modet_attention(q, k, r.reshape(-1, 3, 3, 3), 1.0),
        "K3": lambda q, k, r, dl, g: ma.modet_attention_bwd_dq(q, k, r.reshape(-1, 3, 3, 3),
                                                               1.0, g),
        "K4": lambda q, k, r, dl, g: ma.modet_attention_bwd_dk(q, dl, 1.0)}
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
            p_dq, p_dl, p_drpb = ma.modet_attention_bwd_dq_plain(q, k, r4, 1.0, g)
            dl = p_dl.contiguous()

            def check(name, run):
                if "K1" in kernels:
                    ref = ma.modet_attention_plain(q, k, r4, 1.0).float()
                    err = float((run["K1"](q, k, rpb, dl, g).float() - ref).abs().max())
                    lim = (cs.BF16_TOL if bf else cs.ATTN_TOL) * max(1.0, float(ref.abs().max()))
                    cs.require(err <= lim, f"K1 {name} {dname} level {level}: {err} > {lim}")
                checks = []
                if "K3" in kernels:
                    dq, dl3, part = run["K3"](q, k, rpb, dl, g)
                    checks += [("K3 dq", dq, p_dq), ("K3 dl", dl3, p_dl)]
                    drpb_lim = cs.DRPB_TOL * float(p_dl.float().abs().sum(dim=(0, 1, 2, 3)).max())
                    err = float((part.sum(0).reshape(p_drpb.shape) - p_drpb).abs().max())
                    cs.require(err <= drpb_lim,
                               f"K3 {name} drpb {dname} level {level}: {err} > {drpb_lim}")
                if "K4" in kernels:
                    checks.append(("K4 dk", run["K4"](q, k, rpb, dl, g),
                                   ma.modet_attention_bwd_dk_plain(q, dl, 1.0)))
                for what, a, b in checks:
                    b = b.float()
                    err = float((a.float() - b).abs().max())
                    lim = (cs.BF16_TOL if bf else cs.BWD_TOL) * float(b.abs().max())
                    cs.require(err <= lim, f"{what} {name} {dname} level {level}: {err} > {lim}")

            for name, run in list(runs.items()):  # every build but diag-* against the plain versions
                if name.startswith("diag"):  # a variant that leaves out work, timed only
                    continue
                try:
                    check(name, run)
                except RuntimeError as err:  # a candidate that fails is reported and not timed
                    if name in ("new", "parent"):
                        raise
                    print(f"candidate {name} dropped: {err}", flush=True)
                    del runs[name]
            del p_dq, p_dl, p_drpb
            torch.cuda.empty_cache()
            for kernel in kernels:
                calls = {name: (lambda f=run[kernel]: f(q, k, rpb, dl, g)) for name, run in runs.items()}
                bound_ms = cs.bound(*cs.attn_work(kernel, shape, isz))[0]
                kname = KERNEL_NAMES[kernel]
                bh, bw, cd, blocks, smem = geometry(kernel, shape, isz)
                new_regs = find_regs(regs["new"], kname, bf, pairs=True)
                for other in [n for n in runs if n != "new"]:
                    order = (other, "new", "new", other)
                    t = [cs.device_ms(calls[n]) for n in order]
                    other_ms, new_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
                    oregs = find_regs(regs[other], kname, bf, pairs=True)
                    row = {"kernel": kernel, "dtype": dname, "level": level, "shape": list(shape),
                           "against": other, "other_ms": other_ms, "new_ms": new_ms,
                           "times_in_turns": t, "bound_ms": bound_ms, "share": bound_ms / new_ms,
                           "other_share": bound_ms / other_ms, "brick": [bh, bw, cd],
                           "blocks": blocks, "regs": new_regs, "other_regs": oregs,
                           "smem": smem,
                           "blocks_per_sm": blocks_per_sm(new_regs, bh * bw * heads, smem),
                           "other_blocks_per_sm": blocks_per_sm(oregs, bh * bw * heads, smem)}
                    rows.append(row)
                    print(f"[{card}] {kernel} {dname} level {level} {shape}: device ms {other} "
                          f"{other_ms:.4f}, new {new_ms:.4f} (in turns "
                          f"{', '.join(f'{x:.4f}' for x in t)}); bound {bound_ms:.4f}, share new "
                          f"{row['share']:.3f}, {other} {row['other_share']:.3f}; brick "
                          f"{bh}x{bw}x{cd}, {blocks} blocks, smem {smem} B; regs new {new_regs}, "
                          f"{other} {oregs}; blocks/SM new {row['blocks_per_sm']}, {other} "
                          f"{row['other_blocks_per_sm']}", flush=True)
            if args.sweep:
                new = runs["new"]
                k13 = {key: (lambda f=new[key]: f(q, k, rpb, dl, g))
                       for key in ("K1", "K3") if key in kernels}
                if k13:
                    sweep_rows += sweep(ma, SWEEP, ("ATTN_MAX_BH", "ATTN_MAX_BW",
                                                    "ATTN_TARGET_BLOCKS"),
                                        dname, level, shape, isz, k13)
                if "K4" in kernels:
                    sweep_rows += sweep(ma, SWEEP_K4, ("K4_MAX_BH", "K4_MAX_BW", "K4_TARGET_BLOCKS",
                                                       "K4_MIN_CHUNK"),
                                        dname, level, shape, isz,
                                        {"K4": lambda: new["K4"](q, k, rpb, dl, g)})
            del q, k, g, dl
            torch.cuda.empty_cache()
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": rows, "sweep": sweep_rows}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
