#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`smilecode_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the Hopper kernels from `smilecode_tpu_torch/csrc/` and then:

1. K1 (neighborhood attention) vs its plain PyTorch version at ModeT's five
   level shapes of a 160x192x160 pair; max abs error <= 1e-5.
2. K2 (trilinear warp) vs its plain version at the nine warp shapes of a
   pair, each with a smooth +-5 voxel flow and a wild uniform +-20 voxel
   flow; max abs error <= 1e-5 * max|src|.
3. The slice through its entry point: `smilecode_tpu_torch.infer.main` on 3
   synthetic 160x192x160 subjects (6 ordered pairs) with seeded full-width
   ModeT weights saved as a JAX-format checkpoint. The kernels' launch
   counts must be exactly 5 (K1) and 9 (K2) per pair; the same run with
   ``attn_impl="plain"`` must launch nothing and give the same Dice and fold.
4. One full forward with the kernels vs the plain forward on the card:
   flow within 1e-3 voxel, moved image within 1e-4.
5. Times: median ms per pair over 12 forwards each (kernels, plain), and
   each kernel beside its plain version, per pair.
6. K3 and K4 (attention backward) vs their plain versions at the five level
   shapes: dq, dl, drpb (K3) and dk (K4, on the plain dl).
7. K5 (warp adjoint) vs its plain version at the nine warp shapes, smooth
   +-5 and wild +-20 voxel flows: d_flow and the d_src scatter.
8. The training slice through its entry point:
   `smilecode_tpu_torch.train.main` on synthetic 160x192x160 subjects (6
   steps, then validation on 2 pairs and a checkpoint), which
   `smilecode_tpu_torch.infer.main` reads back. Launches must be exactly, per
   train step, K1 5, K3 5, K4 5, K2 9 and K5 9 (8 of them with the d_src
   scatter), plus 5 K1 and 9 K2 per validation pair; losses finite; the same
   run with ``attn_impl="plain"`` launches nothing and gives the same first
   loss.
9. One training step with the kernels vs the plain one, same weights and
   batch: the loss and every parameter's gradient.
10. Times: median ms per training step (forward, backward, AMSGrad update)
   over 5 steps each (kernels, plain), peak memory of each, each backward
   kernel beside its plain version per step, and the top device operations
   of one kernel step (`torch.profiler`).

The baseline-serving slice (Im2grid, RCN, RDN):

11. K1 at Im2grid's five level shapes with one head, head_dim 6 and no
   rpb (its `cotr`) vs plain, max abs error <= 1e-5; K3 and K4 without rpb
   at level 1 vs plain.
12. K2 through kernel F's entries, ``ops.warp(impl="pallas")`` and
   ``"guarded"``, at the baselines' warp shapes (RDN features C=16..128,
   C=3 flows, RCN's 128x192x128 image and flow, one source/flow shape
   mismatch), smooth +-5 and wild +-20 voxel flows, vs plain; one launch
   per call.
13. `smilecode_tpu_torch.infer.main` for im2grid, rdn and rdn_diff_share on
   the 160x192x160 subjects and rcn on 3 synthetic 128x192x128 subjects
   (VTN needs axes that are multiples of 64), with seeded weights whose
   flow heads are perturbed so that the flows move voxels, saved as
   JAX-format checkpoints. Launches per pair exactly as `BASELINE_LAUNCHES`;
   the ``attn_impl="plain"`` runs launch nothing and give the same Dice and
   fold.
14. Each baseline's forward, kernels vs plain: flow and every aux field
   within 1e-3 voxel, moved image within 1e-4; then median ms per pair over
   5 forwards each (kernels and plain alternating), the peak memory of
   each, and the top device operations of one kernel forward.

Every failed check raises, so the exit code is non-zero; without a CUDA card
it exits non-zero before printing any result. The kernels' JSON record lists
K1-K5 with their launches in the training run of phase 8, then K1 as
Im2grid runs it and K2 as kernel F's counterpart with their launches in the
kernel runs of phase 13; the last two lines are that record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SIZE = (160, 192, 160)  # LPBA
NUM_HEADS = (8, 4, 2, 1, 1)  # levels 5..1
HEAD_DIM = 6
ATTN_TOL = 1e-5
WARP_TOL = 1e-5  # times max|src|
FLOW_TOL = 1e-3
MOVED_TOL = 1e-4
N_SUBJECTS = 3
N_TIMED = 12
BWD_TOL = 1e-5  # times the largest |gradient| of the plain version
DRPB_TOL = 1e-6  # times the largest sum_x |dl_t| (see check_attention_bwd)
STEP_LOSS_TOL = 1e-4  # relative, kernels vs plain training loss
STEP_GRAD_TOL = 1e-3  # times each parameter's largest |gradient|, kernels vs plain step
STEP_GRAD_FLOOR = 1e-6  # times the model's largest |gradient| (zero-gradient conv biases)
N_VAL_SUBJECTS = 2
N_TIMED_STEPS = 5
RCN_SIZE = (128, 192, 128)  # the largest crop of 160x192x160 whose axes are multiples of 64
N_TIMED_BASELINE = 5
# (model, volume size, K1 and K2 launches per pair), derived from the JAX
# modules (`smilecode_tpu/models/`): Im2grid runs `cotr` at 5 levels and
# warps the features and composes the flow at levels 4..1 plus the moved
# image (9); RCN with its 10 cascades warps the moving image in each and
# composes in each after the first (19); RDN with stages 4 and levels
# (4, 4, 4, 4) composes after every estimate but the first, warps the
# features before every estimate at the finer levels and before the later
# ones at the coarsest, re-warps 4 feature levels and composes per later
# stage, and warps the moved image (136); diff adds an sv composition and 7
# vecint steps per estimate (644). A CPU test counts the same calls
# (`tests/test_torch_baselines.py::test_kernel_wrapper_calls_per_pair`).
BASELINES = (("im2grid", SIZE, 5, 9), ("rdn", SIZE, 0, 136),
             ("rdn_diff_share", SIZE, 0, 644), ("rcn", RCN_SIZE, 0, 19))
# seeded perturbation of the flow heads: (parameter name part, std)
BASELINE_HEADS = {"im2grid": ("proj", 0.1), "rdn": ("conv.4", 0.02),
                  "rdn_diff_share": ("conv.4", 0.02), "rcn": ("Pred0", 0.1)}
# kernel F's entries at the baselines' warps: (what, source shape, flow shape, C)
F_CASES = [("RDN level-0 features", (80, 96, 80), (80, 96, 80), 16),
           ("RDN level-1 features", (40, 48, 40), (40, 48, 40), 32),
           ("RDN level-2 features", (20, 24, 20), (20, 24, 20), 64),
           ("RDN level-3 features", (10, 12, 10), (10, 12, 10), 128),
           ("RDN/vecint flow", (80, 96, 80), (80, 96, 80), 3),
           ("RCN moved image", RCN_SIZE, RCN_SIZE, 1),
           ("RCN flow", RCN_SIZE, RCN_SIZE, 3),
           ("shape mismatch", (80, 96, 80), (40, 48, 40), 3)]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device ms per call of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def level_shape(level: int, size=SIZE):
    f = 2 ** (level - 1)
    return tuple(s // f for s in size)


def warp_calls():
    """The nine bilinear warps of one ModeT pair: (what, channels, level)."""
    return [("level4 features", 64, 4), ("level4 flow", 3, 3),
            ("level3 features", 32, 3), ("level3 flow", 3, 2),
            ("level2 features", 16, 2), ("level2 flow", 3, 2),
            ("level1 features", 8, 1), ("level1 flow", 3, 1),
            ("moved image", 1, 1)]


def smooth_flow(shape, amp, device):
    import torch

    axes = [torch.linspace(0, 3 * np.pi, s, device=device) for s in shape]
    g = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    comps = [torch.sin(g[..., 0] + i) * torch.cos(g[..., 1] - i) * torch.sin(g[..., 2] + 2 * i)
             for i in range(3)]
    return (amp * torch.stack(comps, -1))[None].contiguous()


def check_attention(device, size=SIZE, timed=True, num_heads=NUM_HEADS, with_rpb=True):
    """K1 vs plain at every level shape (heads per level 5..1, with or
    without rpb); returns (max_err, ms, plain_ms) per pair."""
    import torch

    from smilecode_tpu_torch.kernels.modet_attn import modet_attention, modet_attention_plain

    rng = np.random.default_rng(1)
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for level, heads in zip((5, 4, 3, 2, 1), num_heads):
        shape = (1, *level_shape(level, size), heads, HEAD_DIM)
        q = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)
        k = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)
        rpb = torch.from_numpy(rng.standard_normal((heads, 3, 3, 3), dtype=np.float32) * 0.5).to(
            device) if with_rpb else None
        out = modet_attention(q, k, rpb, 1.0)
        ref = modet_attention_plain(q, k, rpb, 1.0)
        err = float((out - ref).abs().max())
        require(bool(torch.isfinite(out).all()) and float(out.abs().max()) <= 1.0 + 1e-6,
                f"attention level {level}: output not finite or outside [-1, 1]")
        require(err <= ATTN_TOL, f"attention level {level} {shape}: max abs err {err} > {ATTN_TOL}")
        worst = max(worst, err)
        line = (f"K1 attention level {level} q,k {shape}, rpb {'yes' if with_rpb else 'none'}: "
                f"max_abs_err {err:.3e}")
        if timed:
            t = event_ms(lambda: modet_attention(q, k, rpb, 1.0), 20)
            tp = event_ms(lambda: modet_attention_plain(q, k, rpb, 1.0), 5)
            ms, plain_ms = ms + t, plain_ms + tp
            line += f", kernel {t:.4f} ms, plain {tp:.4f} ms"
        print(line, flush=True)
    return worst, ms, plain_ms


def check_warp(device, size=SIZE, timed=True):
    """K2 vs plain at the pair's warp shapes, smooth and wild flows;
    returns (max_err, ms, plain_ms) summed over the nine calls of a pair."""
    import torch

    from smilecode_tpu_torch.kernels.warp3d import warp3d_trilinear, warp3d_trilinear_plain

    rng = np.random.default_rng(2)
    worst, times = 0.0, {}
    for _, c, level in warp_calls():
        key = (c, level)
        if key in times:
            continue
        shape = level_shape(level, size)
        src = torch.from_numpy(rng.standard_normal((1, *shape, c), dtype=np.float32)).to(device)
        flows = {"smooth +-5": smooth_flow(shape, 5.0, device),
                 "wild +-20": torch.from_numpy(
                     rng.uniform(-20, 20, (1, *shape, 3)).astype(np.float32)).to(device)}
        tol = WARP_TOL * float(src.abs().max())
        for name, flow in flows.items():
            out = warp3d_trilinear(src, flow)
            err = float((out - warp3d_trilinear_plain(src, flow)).abs().max())
            require(bool(torch.isfinite(out).all()), f"warp C={c} {shape} {name}: not finite")
            require(err <= tol, f"warp C={c} {shape} {name}: max abs err {err} > {tol}")
            worst = max(worst, err)
            line = f"K2 warp C={c} {shape} {name}: max_abs_err {err:.3e} (tol {tol:.3e})"
            if timed:
                t = event_ms(lambda: warp3d_trilinear(src, flow), 20)
                tp = event_ms(lambda: warp3d_trilinear_plain(src, flow), 5)
                line += f", kernel {t:.4f} ms, plain {tp:.4f} ms"
                if name.startswith("smooth"):
                    times[key] = (t, tp)
            print(line, flush=True)
        times.setdefault(key, (0.0, 0.0))
    ms = sum(times[(c, level)][0] for _, c, level in warp_calls())
    plain_ms = sum(times[(c, level)][1] for _, c, level in warp_calls())
    return worst, ms, plain_ms


def check_attention_bwd(device, size=SIZE, specs=tuple(zip((5, 4, 3, 2, 1), NUM_HEADS)),
                        with_rpb=True):
    """K3, K4 vs their plain versions at every level shape; returns
    {kernel: (max_err, ms, plain_ms)} with times summed over the five calls
    of a training step.

    Tolerances: dq, dl and dk within BWD_TOL of the plain version's largest
    magnitude (27-term float32 sums in another order). drpb sums dl_t over
    every voxel, and the terms cancel (sum_t dl_t = 0 at each voxel), so its
    rounding scales with sum_x |dl_t|, not with drpb: it is held within
    DRPB_TOL of the largest sum_x |dl_t| of the plain dl (K3 adds 256-row
    blocks in order, then torch adds the blocks; a dropped block would be off
    by ~256 |dl| and fail)."""
    import torch

    from smilecode_tpu_torch.kernels.modet_attn import (
        modet_attention_bwd_dk,
        modet_attention_bwd_dk_plain,
        modet_attention_bwd_dq,
        modet_attention_bwd_dq_plain,
    )

    rng = np.random.default_rng(5)
    res = {"K3": [0.0, 0.0, 0.0], "K4": [0.0, 0.0, 0.0]}
    for level, heads in specs:
        shape = (1, *level_shape(level, size), heads, HEAD_DIM)
        q, k = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)
                for _ in range(2))
        rpb = torch.from_numpy(rng.standard_normal((heads, 3, 3, 3), dtype=np.float32) * 0.5).to(
            device) if with_rpb else None
        g = torch.from_numpy(rng.standard_normal((*shape[:4], heads * 3), dtype=np.float32)).to(device)
        dq, dl, part = modet_attention_bwd_dq(q, k, rpb, 1.0, g)
        p_dq, p_dl, p_drpb = modet_attention_bwd_dq_plain(q, k, rpb, 1.0, g)
        dk = modet_attention_bwd_dk(q, p_dl, 1.0)
        p_dk = modet_attention_bwd_dk_plain(q, p_dl, 1.0)
        checks = [("dq", dq, p_dq, None), ("dl", dl, p_dl, None), ("dk", dk, p_dk, None)]
        if with_rpb:
            drpb = part.sum(0).reshape(heads, 3, 3, 3)
            drpb_tol = DRPB_TOL * float(p_dl.abs().sum(dim=(0, 1, 2, 3)).max())
            checks.insert(2, ("drpb", drpb, p_drpb, drpb_tol))
        else:
            require(part is None and p_drpb is None, "attention bwd without rpb returned a drpb")
        errs = {}
        for name, a, b, tol in checks:
            require(bool(torch.isfinite(a).all()), f"attention bwd level {level}: {name} not finite")
            err = float((a - b).abs().max())
            tol = tol if tol is not None else BWD_TOL * float(b.abs().max())
            require(err <= tol, f"attention bwd level {level} {shape}: {name} max abs err "
                                f"{err} > {tol}")
            errs[name] = (err, tol)
        t3 = event_ms(lambda: modet_attention_bwd_dq(q, k, rpb, 1.0, g), 10)
        t4 = event_ms(lambda: modet_attention_bwd_dk(q, p_dl, 1.0), 10)
        p3 = event_ms(lambda: modet_attention_bwd_dq_plain(q, k, rpb, 1.0, g), 3)
        p4 = event_ms(lambda: modet_attention_bwd_dk_plain(q, p_dl, 1.0), 3)
        k3_err = max(e for n, (e, _) in errs.items() if n != "dk")
        for key, err, t, tp in (("K3", k3_err, t3, p3), ("K4", errs["dk"][0], t4, p4)):
            res[key] = [max(res[key][0], err), res[key][1] + t, res[key][2] + tp]
        print(f"K3/K4 attention bwd level {level} q,k {shape}, rpb "
              f"{'yes' if with_rpb else 'none'}: max_abs_err "
              + ", ".join(f"{n} {e:.3e} (tol {t:.3e})" for n, (e, t) in errs.items())
              + f"; K3 {t3:.4f} ms (plain {p3:.4f}), K4 {t4:.4f} ms (plain {p4:.4f})", flush=True)
        del q, k, g, dq, dl, part, p_dq, p_dl, p_drpb, dk, p_dk, checks
        torch.cuda.empty_cache()
    return {key: tuple(v) for key, v in res.items()}


def check_warp_f(device):
    """K2 through kernel F's entries, ``ops.warp(impl="pallas" | "guarded")``,
    vs plain at `F_CASES`, smooth and wild flows; exactly one launch per
    call. Returns (max_err, ms, plain_ms), times summed over the smooth
    cases of "pallas", one call each."""
    import torch

    from smilecode_tpu_torch.kernels.warp3d import warp3d_trilinear, warp3d_trilinear_plain
    from smilecode_tpu_torch.ops.warp import warp

    rng = np.random.default_rng(8)
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for what, src_shape, flow_shape, c in F_CASES:
        src = torch.from_numpy(rng.standard_normal((1, *src_shape, c), dtype=np.float32)).to(device)
        flows = {"smooth +-5": smooth_flow(flow_shape, 5.0, device),
                 "wild +-20": torch.from_numpy(
                     rng.uniform(-20, 20, (1, *flow_shape, 3)).astype(np.float32)).to(device)}
        tol = WARP_TOL * float(src.abs().max())
        for name, flow in flows.items():
            ref = warp3d_trilinear_plain(src, flow)
            line = f"K2 via ops.warp {what} C={c} src {src_shape} flow {flow_shape} {name}:"
            for impl in ("pallas", "guarded"):
                before = warp3d_trilinear.launches
                out = warp(src, flow, impl=impl)
                require(warp3d_trilinear.launches == before + 1, f"warp(impl={impl!r}) did not "
                                                                 "launch K2 exactly once")
                err = float((out - ref).abs().max())
                require(bool(torch.isfinite(out).all()) and out.shape == (1, *flow_shape, c),
                        f"{line} impl={impl}: output not finite or of the wrong shape")
                require(err <= tol, f"{line} impl={impl}: max abs err {err} > {tol}")
                worst = max(worst, err)
                line += f" {impl} max_abs_err {err:.3e}"
            t = event_ms(lambda: warp(src, flow, impl="pallas"), 20)
            tp = event_ms(lambda: warp3d_trilinear_plain(src, flow), 5)
            if name.startswith("smooth"):
                ms, plain_ms = ms + t, plain_ms + tp
            print(f"{line} (tol {tol:.3e}), kernel {t:.4f} ms, plain {tp:.4f} ms", flush=True)
        del src, flows, ref, out
        torch.cuda.empty_cache()
    return worst, ms, plain_ms


def seeded_baseline(name, device, attn_impl="auto"):
    """Baseline ``name`` as `build_model` makes it (the reference's depth:
    RCN 10 cascades, RDN stages 4 and levels (4, 4, 4, 4)) from seed 0, with
    the flow heads perturbed from a numpy seed (`BASELINE_HEADS`): their
    N(0, 1e-5) or zero init would leave the flows near identity, where a
    warp bug hides."""
    import torch

    from smilecode_tpu_torch.config import InferConfig
    from smilecode_tpu_torch.models.registry import build_model

    model = build_model(name, InferConfig(model=name, attn_impl=attn_impl), device=device,
                        generator=torch.Generator().manual_seed(0))
    part, std = BASELINE_HEADS[name]
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if part in pname:
                p.add_(torch.from_numpy(rng.standard_normal(p.shape, dtype=np.float32) * std).to(device))
    return model.eval()


def check_warp_bwd(device, size=SIZE):
    """K5 vs its plain version at the pair's warp shapes, smooth and wild
    flows; d_flow within BWD_TOL of the plain version's largest |d_flow|,
    d_src (an atomic scatter, order-dependent) within BWD_TOL of its largest
    |d_src|. Returns (max_err, ms, plain_ms) per training step: eight warps
    with the scatter, the moved image's without (on the smooth flows)."""
    import torch

    from smilecode_tpu_torch.kernels.warp3d import warp3d_trilinear_bwd, warp3d_trilinear_bwd_plain

    rng = np.random.default_rng(6)
    worst, times = 0.0, {}
    for what, c, level in warp_calls():
        want_dsrc = what != "moved image"
        key = (c, level, want_dsrc)
        if key in times:
            continue
        shape = level_shape(level, size)
        src = torch.from_numpy(rng.standard_normal((1, *shape, c), dtype=np.float32)).to(device)
        g = torch.from_numpy(rng.standard_normal((1, *shape, c), dtype=np.float32)).to(device)
        flows = {"smooth +-5": smooth_flow(shape, 5.0, device),
                 "wild +-20": torch.from_numpy(
                     rng.uniform(-20, 20, (1, *shape, 3)).astype(np.float32)).to(device)}
        for name, flow in flows.items():
            d_src, d_flow = warp3d_trilinear_bwd(src, flow, g, True)
            p_src, p_flow = warp3d_trilinear_bwd_plain(src, flow, g, True)
            line = f"K5 warp bwd C={c} {shape} {name}:"
            for what_, a, b in (("d_flow", d_flow, p_flow), ("d_src", d_src, p_src)):
                require(bool(torch.isfinite(a).all()), f"warp bwd C={c} {shape} {name}: {what_}")
                err = float((a - b).abs().max())
                tol = BWD_TOL * float(b.abs().max())
                require(err <= tol, f"warp bwd C={c} {shape} {name}: {what_} max abs err "
                                    f"{err} > {tol}")
                worst = max(worst, err)
                line += f" {what_} max_abs_err {err:.3e} (tol {tol:.3e})"
            t = event_ms(lambda: warp3d_trilinear_bwd(src, flow, g, want_dsrc), 10)
            tp = event_ms(lambda: warp3d_trilinear_bwd_plain(src, flow, g, want_dsrc), 3)
            line += f"; {'with' if want_dsrc else 'without'} d_src {t:.4f} ms (plain {tp:.4f})"
            if name.startswith("smooth"):
                times[key] = (t, tp)
            print(line, flush=True)
        del src, g, flows, d_src, d_flow, p_src, p_flow
        torch.cuda.empty_cache()
    keys = [(c, level, what != "moved image") for what, c, level in warp_calls()]
    return worst, sum(times[k][0] for k in keys), sum(times[k][1] for k in keys)


def launch_counts():
    from smilecode_tpu_torch.kernels.modet_attn import (
        modet_attention,
        modet_attention_bwd_dk,
        modet_attention_bwd_dq,
    )
    from smilecode_tpu_torch.kernels.warp3d import warp3d_trilinear, warp3d_trilinear_bwd

    return {"K1": modet_attention.launches, "K2": warp3d_trilinear.launches,
            "K3": modet_attention_bwd_dq.launches, "K4": modet_attention_bwd_dk.launches,
            "K5": warp3d_trilinear_bwd.launches, "K5 d_src": warp3d_trilinear_bwd.scatters}


def reset_launch_counts():
    from smilecode_tpu_torch.kernels.modet_attn import (
        modet_attention,
        modet_attention_bwd_dk,
        modet_attention_bwd_dq,
    )
    from smilecode_tpu_torch.kernels.warp3d import warp3d_trilinear, warp3d_trilinear_bwd

    for fn in (modet_attention, modet_attention_bwd_dq, modet_attention_bwd_dk,
               warp3d_trilinear, warp3d_trilinear_bwd):
        fn.launches = 0
    warp3d_trilinear_bwd.scatters = 0


def run_train(train_dir, val_dir, root, attn_impl="auto"):
    """train.main for one epoch; returns (best_dsc, exp_dir, step losses,
    launch counts, seconds)."""
    import torch

    from smilecode_tpu_torch import train
    from smilecode_tpu_torch.config import TrainConfig

    cfg = TrainConfig(train_dir=train_dir, val_dir=val_dir, max_epoch=1, attn_impl=attn_impl,
                      save_root=os.path.join(root, "experiments"),
                      log_root=os.path.join(root, "logs"))
    reset_launch_counts()
    t0 = time.perf_counter()
    best = train.main(cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    with open(os.path.join(cfg.log_root, cfg.save_dir, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f if '"iter"' in line]
    return best, os.path.join(cfg.save_root, cfg.save_dir), losses, counts, seconds


def compare_step_grads(model, plain, x, y):
    """One loss-and-gradients pass of each model on (x, y); returns
    (loss, plain loss, worst gradient error over its tolerance)."""
    from smilecode_tpu_torch.models.registry import loss_plan
    from smilecode_tpu_torch.train import make_loss_and_grads

    plan = loss_plan("modet")
    loss, _ = make_loss_and_grads(model, plan, (1.0, 1.0))(x, y)
    p_loss, _ = make_loss_and_grads(plain, plan, (1.0, 1.0))(x, y)
    grads = dict(model.named_parameters())
    p_grads = dict(plain.named_parameters())
    gmax = max(float(p.grad.abs().max()) for p in p_grads.values())
    floor = STEP_GRAD_FLOOR * gmax
    worst, worst_name, worst_rel, rel_name = 0.0, "", 0.0, ""
    for name, p in p_grads.items():
        g = grads[name].grad
        require(g is not None and bool(g.isfinite().all()), f"step gradient {name} missing or not finite")
        err, scale = float((g - p.grad).abs().max()), float(p.grad.abs().max())
        ratio = err / (STEP_GRAD_TOL * scale + floor)
        if ratio > worst:
            worst, worst_name = ratio, name
        if scale > 1e-3 * gmax and err / scale > worst_rel:
            worst_rel, rel_name = err / scale, name  # parameters with a real gradient
        require(ratio <= 1.0, f"step gradient {name}: kernels vs plain max abs err over "
                              f"tolerance {ratio:.3f} > 1")
    print(f"kernel step vs plain step: loss {float(loss):.7f} vs {float(p_loss):.7f}; "
          f"worst gradient err/tol {worst:.4f} ({worst_name}); tolerance "
          f"{STEP_GRAD_TOL} x each parameter's max |grad| + {STEP_GRAD_FLOOR} x the model's; "
          f"worst err / max |grad| over parameters whose max |grad| is above 1e-3 of the "
          f"model's: {worst_rel:.3e} ({rel_name})")
    return float(loss), float(p_loss), worst


def time_steps(model, plain, x, y):
    """Median ms per training step and peak GiB, alternating kernels/plain."""
    import torch

    from smilecode_tpu_torch.models.registry import loss_plan
    from smilecode_tpu_torch.optim import AMSGrad
    from smilecode_tpu_torch.train import make_train_step

    steps = {name: make_train_step(m, loss_plan("modet"), AMSGrad(m.parameters(), lr=1e-4),
                                   (1.0, 1.0)) for name, m in (("kernels", model), ("plain", plain))}
    times = {"kernels": [], "plain": []}
    peak = {"kernels": 0.0, "plain": 0.0}
    for name in steps:  # warm-up
        steps[name](x, y)
    for i in range(N_TIMED_STEPS):
        for name in (("plain", "kernels") if i % 2 else ("kernels", "plain")):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, _ = steps[name](x, y)
            require(bool(torch.isfinite(loss)), f"{name} step loss not finite")
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            peak[name] = max(peak[name], torch.cuda.max_memory_allocated() / 2**30)
    return times, peak, steps["kernels"]


def profile_step(step, x, y, top=12, what="kernel step"):
    """Top device operations of one call of ``step``, and the device idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: user-annotated ranges (Optimizer.step) would count twice
    events = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
              and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"profile of one {what}: wall {wall_ms:.3f} ms, device kernels {busy_ms:.3f} ms "
          f"(idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}); top device operations:")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:top]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:100]}")


def write_subjects(test_dir, size=SIZE, device="cpu", n=N_SUBJECTS, seed=3):
    """Smooth random textures in [0, 1] with LPBA labels from a second field."""
    import torch
    import torch.nn.functional as F

    from smilecode_tpu_torch.data.trans import LPBA_SEG_TABLE

    rng = np.random.default_rng(seed)
    coarse = tuple(max(2, s // 16) for s in size)
    for i in range(n):
        fields = torch.from_numpy(rng.random((1, 2, *coarse), dtype=np.float32)).to(device)
        fields = F.interpolate(fields, size=size, mode="trilinear", align_corners=True)[0]
        img = fields[0].cpu().numpy()
        lab = fields[1].cpu().numpy()
        lab = (lab - lab.min()) / (lab.max() - lab.min() + 1e-6)
        seg = LPBA_SEG_TABLE[np.minimum((lab * 55).astype(np.int64), 54)].astype(np.uint16)
        with open(os.path.join(test_dir, f"subject_{i:02d}.pkl"), "wb") as f:
            pickle.dump((img, seg), f)


def seeded_model(device, attn_impl="auto"):
    """Full-width ModeT from seed 0, with a seeded random RPB so the bias
    path is live (the trained reference's RPB is not zero)."""
    import torch

    from smilecode_tpu_torch.models import ModeT

    model = ModeT(channels=4, head_dim=HEAD_DIM, num_heads=NUM_HEADS, qk_scale=1.0,
                  attn_impl=attn_impl, device=device, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("rpb"):
                p.copy_(torch.from_numpy(rng.standard_normal(p.shape, dtype=np.float32)))
    return model.eval()


def write_jax_checkpoint(model_dir, model):
    from smilecode_tpu_torch.convert import params_from_state_dict

    os.makedirs(model_dir, exist_ok=True)
    state = {"epoch": 0, "params": params_from_state_dict(model.state_dict(), model),
             "best_dsc": 0.0}
    with open(os.path.join(model_dir, "dsc0.000.ckpt"), "wb") as f:
        pickle.dump(state, f)


def run_infer(test_dir, model_dir, attn_impl="auto", model="modet"):
    """infer.main through its config; returns (dsc, fold, K1 launches, K2 launches, s)."""
    import torch

    from smilecode_tpu_torch import infer
    from smilecode_tpu_torch.config import InferConfig

    cfg = InferConfig(model=model, test_dir=test_dir, model_dir=model_dir, attn_impl=attn_impl)
    reset_launch_counts()
    t0 = time.perf_counter()
    dsc, fold = infer.main(cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    return dsc, fold, counts["K1"], counts["K2"], seconds


def forward_pair(test_dir, device):
    from smilecode_tpu_torch.data import Compose, Loader, LPBABrainInferDatasetS2S, NumpyType, Seg_norm

    paths = sorted(os.path.join(test_dir, p) for p in os.listdir(test_dir))
    ds = LPBABrainInferDatasetS2S(paths, Compose([Seg_norm(), NumpyType((np.float32, np.int16))]))
    x, y, _, _ = next(iter(Loader(ds, device=device)))
    return x, y


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this runs on the card")
    from smilecode_tpu_torch.kernels import _build

    card = card_line()
    device = torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    _build.library()
    print(f"kernel build: {_build.build_info['seconds']:.2f} s -> {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    print("== phase 1: K1 attention vs plain", flush=True)
    k1_err, k1_ms, k1_plain_ms = check_attention(device)
    print("== phase 2: K2 warp vs plain", flush=True)
    k2_err, k2_ms, k2_plain_ms = check_warp(device)

    print("== phase 3: infer.main on synthetic 160x192x160 pairs", flush=True)
    n_pairs = N_SUBJECTS * (N_SUBJECTS - 1)
    with tempfile.TemporaryDirectory(prefix="smilecode_smoke_") as tmp:
        test_dir, model_dir = os.path.join(tmp, "Test"), os.path.join(tmp, "exp")
        os.makedirs(test_dir)
        write_subjects(test_dir, device=device)
        model = seeded_model(device)
        write_jax_checkpoint(model_dir, model)
        dsc, fold, n_k1, n_k2, secs = run_infer(test_dir, model_dir)
        print(f"infer (kernels): {n_pairs} pairs in {secs:.2f} s, K1 launches {n_k1}, "
              f"K2 launches {n_k2}, dsc {dsc:.6f}, fold {fold:.6f}", flush=True)
        require(np.isfinite(dsc) and 0.0 <= dsc <= 1.0, f"Dice {dsc} outside [0, 1]")
        require(np.isfinite(fold) and 0.0 <= fold <= 1.0, f"fold {fold} outside [0, 1]")
        require(n_k1 == 5 * n_pairs, f"K1 launched {n_k1} times, expected {5 * n_pairs}")
        require(n_k2 == 9 * n_pairs, f"K2 launched {n_k2} times, expected {9 * n_pairs}")
        p_dsc, p_fold, p_k1, p_k2, p_secs = run_infer(test_dir, model_dir, attn_impl="plain")
        print(f"infer (plain): {n_pairs} pairs in {p_secs:.2f} s, K1 launches {p_k1}, "
              f"K2 launches {p_k2}, dsc {p_dsc:.6f}, fold {p_fold:.6f}", flush=True)
        require(p_k1 == 0 and p_k2 == 0, "the plain run launched a kernel")
        require(abs(dsc - p_dsc) <= 1e-3 and abs(fold - p_fold) <= 1e-3,
                f"kernels vs plain infer: dsc {dsc} vs {p_dsc}, fold {fold} vs {p_fold}")

        print("== phase 4: full forward, kernels vs plain", flush=True)
        x, y = forward_pair(test_dir, device)
        plain = seeded_model(device, attn_impl="plain")
        with torch.no_grad():
            moved, flow = model(x, y)
            p_moved, p_flow = plain(x, y)
        flow_err = float((flow - p_flow).abs().max())
        moved_err = float((moved - p_moved).abs().max())
        print(f"forward: flow max |.| {float(flow.abs().max()):.4f} voxel, "
              f"flow max abs diff {flow_err:.3e}, moved max abs diff {moved_err:.3e}")
        require(bool(torch.isfinite(flow).all() and torch.isfinite(moved).all()), "non-finite output")
        require(flow.shape == (1, *SIZE, 3) and moved.shape == (1, *SIZE, 1), "output shapes")
        require(flow_err <= FLOW_TOL, f"flow diff {flow_err} > {FLOW_TOL}")
        require(moved_err <= MOVED_TOL, f"moved diff {moved_err} > {MOVED_TOL}")

        print("== phase 5: ms per pair (forward only)", flush=True)
        times = {"kernels": [], "plain": []}
        with torch.no_grad():
            for m in (model, plain):  # warm-up
                m(x, y)
            for i in range(N_TIMED):
                order = (("plain", plain), ("kernels", model)) if i % 2 else (
                    ("kernels", model), ("plain", plain))
                for name, m in order:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m(x, y)
                    torch.cuda.synchronize()
                    times[name].append((time.perf_counter() - t0) * 1e3)
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"[{card}] ModeT 160x192x160 forward, median of {N_TIMED}: "
              f"kernels {med['kernels']:.3f} ms/pair, plain {med['plain']:.3f} ms/pair "
              f"(min {min(times['kernels']):.3f} / {min(times['plain']):.3f})")
        print(f"[{card}] per pair: K1 {k1_ms:.4f} ms (plain {k1_plain_ms:.4f}), "
              f"K2 {k2_ms:.4f} ms (plain {k2_plain_ms:.4f}); "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del moved, flow, p_moved, p_flow
        torch.cuda.empty_cache()

        print("== phase 6: K3/K4 attention backward vs plain", flush=True)
        bwd = check_attention_bwd(device)
        print("== phase 7: K5 warp adjoint vs plain", flush=True)
        k5_err, k5_ms, k5_plain_ms = check_warp_bwd(device)

        print("== phase 8: train.main on synthetic 160x192x160 subjects", flush=True)
        val_dir = os.path.join(tmp, "Val")
        os.makedirs(val_dir)
        write_subjects(val_dir, device=device, n=N_VAL_SUBJECTS, seed=7)
        n_steps, n_val = n_pairs, N_VAL_SUBJECTS * (N_VAL_SUBJECTS - 1)
        best, exp_dir, losses, train_counts, secs = run_train(test_dir, val_dir,
                                                               os.path.join(tmp, "kernels"))
        print(f"train (kernels): {n_steps} steps + {n_val} validation pairs in {secs:.2f} s, "
              f"losses {losses}, best dsc {best:.6f}, launches {train_counts}", flush=True)
        require(len(losses) == n_steps and bool(np.isfinite(losses).all()), f"losses {losses}")
        want = {"K1": 5 * (n_steps + n_val), "K2": 9 * (n_steps + n_val), "K3": 5 * n_steps,
                "K4": 5 * n_steps, "K5": 9 * n_steps, "K5 d_src": 8 * n_steps}
        require(train_counts == want, f"train launches {train_counts}, expected {want}")
        dsc, fold, n_k1, n_k2, secs = run_infer(val_dir, exp_dir)
        print(f"infer of the trained checkpoint: dsc {dsc:.6f}, fold {fold:.6f}, "
              f"K1 {n_k1}, K2 {n_k2} launches", flush=True)
        require(np.isfinite(dsc) and 0.0 <= dsc <= 1.0 and np.isfinite(fold),
                f"trained checkpoint: dsc {dsc}, fold {fold}")
        require(n_k1 == 5 * n_val and n_k2 == 9 * n_val, "infer launches after training")
        _, _, p_losses, p_counts, p_secs = run_train(test_dir, val_dir, os.path.join(tmp, "plain"),
                                                     attn_impl="plain")
        print(f"train (plain): {p_secs:.2f} s, losses {p_losses}, launches {p_counts}", flush=True)
        require(not any(p_counts.values()), "the plain training run launched a kernel")
        require(abs(losses[0] - p_losses[0]) <= STEP_LOSS_TOL * abs(p_losses[0]),
                f"first step loss, kernels vs plain: {losses[0]} vs {p_losses[0]}")
        torch.cuda.empty_cache()

        print("== phase 9: one training step, kernels vs plain", flush=True)
        loss, p_loss, _ = compare_step_grads(model, plain, x, y)
        require(abs(loss - p_loss) <= STEP_LOSS_TOL * abs(p_loss),
                f"step loss, kernels vs plain: {loss} vs {p_loss}")

        print("== phase 10: ms per training step", flush=True)
        times, peak, kernel_step = time_steps(model, plain, x, y)
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"[{card}] ModeT 160x192x160 training step (fwd + bwd + AMSGrad), median of "
              f"{N_TIMED_STEPS}: kernels {med['kernels']:.3f} ms, plain {med['plain']:.3f} ms "
              f"(min {min(times['kernels']):.3f} / {min(times['plain']):.3f}); peak memory "
              f"kernels {peak['kernels']:.2f} GiB, plain {peak['plain']:.2f} GiB")
        print(f"[{card}] backward kernels per step: K3 {bwd['K3'][1]:.4f} ms (plain "
              f"{bwd['K3'][2]:.4f}), K4 {bwd['K4'][1]:.4f} ms (plain {bwd['K4'][2]:.4f}), "
              f"K5 {k5_ms:.4f} ms (plain {k5_plain_ms:.4f})")
        profile_step(kernel_step, x, y)
        del model, plain, kernel_step, x, y
        torch.cuda.empty_cache()

        print("== phase 11: K1 as Im2grid runs it (1 head, no rpb); K3/K4 without rpb", flush=True)
        g_err, g_ms, g_plain_ms = check_attention(device, num_heads=(1,) * 5, with_rpb=False)
        check_attention_bwd(device, specs=((1, 1),), with_rpb=False)
        print("== phase 12: K2 through kernel F's entries at the baselines' shapes", flush=True)
        f_err, f_ms, f_plain_ms = check_warp_f(device)

        print("== phase 13: infer.main for the baselines", flush=True)
        rcn_dir = os.path.join(tmp, "TestRCN")
        os.makedirs(rcn_dir)
        write_subjects(rcn_dir, size=RCN_SIZE, device=device)
        base_counts = {"K1": 0, "K2": 0}
        for name, size, k1_pair, k2_pair in BASELINES:
            data_dir = test_dir if size == SIZE else rcn_dir
            model_dir = os.path.join(tmp, f"exp_{name}")
            write_jax_checkpoint(model_dir, seeded_baseline(name, device))
            dsc, fold, n_k1, n_k2, secs = run_infer(data_dir, model_dir, model=name)
            print(f"{name} {size} infer (kernels): {n_pairs} pairs in {secs:.2f} s, K1 launches "
                  f"{n_k1}, K2 launches {n_k2}, dsc {dsc:.6f}, fold {fold:.6f}", flush=True)
            require(np.isfinite(dsc) and 0.0 <= dsc <= 1.0, f"{name}: Dice {dsc} outside [0, 1]")
            require(np.isfinite(fold) and 0.0 <= fold <= 1.0, f"{name}: fold {fold} outside [0, 1]")
            require((n_k1, n_k2) == (k1_pair * n_pairs, k2_pair * n_pairs),
                    f"{name}: K1, K2 launched {n_k1}, {n_k2} times, expected "
                    f"{k1_pair * n_pairs}, {k2_pair * n_pairs}")
            base_counts["K1"] += n_k1
            base_counts["K2"] += n_k2
            p_dsc, p_fold, p_k1, p_k2, p_secs = run_infer(data_dir, model_dir, attn_impl="plain",
                                                          model=name)
            print(f"{name} {size} infer (plain): {p_secs:.2f} s, K1 launches {p_k1}, K2 launches "
                  f"{p_k2}, dsc {p_dsc:.6f}, fold {p_fold:.6f}", flush=True)
            require(p_k1 == 0 and p_k2 == 0, f"{name}: the plain run launched a kernel")
            require(abs(dsc - p_dsc) <= 1e-3 and abs(fold - p_fold) <= 1e-3,
                    f"{name} kernels vs plain infer: dsc {dsc} vs {p_dsc}, fold {fold} vs {p_fold}")
            torch.cuda.empty_cache()

        print("== phase 14: baseline forwards, kernels vs plain; ms per pair", flush=True)
        for name, size, _, _ in BASELINES:
            x, y = forward_pair(test_dir if size == SIZE else rcn_dir, device)
            model, plain = seeded_baseline(name, device), seeded_baseline(name, device, "plain")
            with torch.no_grad():
                outs, p_outs = model(x, y), plain(x, y)
            require(len(outs) == len(p_outs) and outs[0].shape == (1, *size, 1)
                    and outs[1].shape == (1, *size, 3), f"{name}: output shapes")
            require(all(bool(torch.isfinite(o).all()) for o in outs), f"{name}: non-finite output")
            moved_err = float((outs[0] - p_outs[0]).abs().max())
            flow_err = max(float((a - b).abs().max()) for a, b in zip(outs[1:], p_outs[1:]))
            mag = outs[1].norm(dim=-1)
            print(f"{name} {size} forward: {len(outs)} outputs, flow |.| max {float(mag.max()):.4f} "
                  f"mean {float(mag.mean()):.4f} voxel; kernels vs plain: flow and aux max abs "
                  f"diff {flow_err:.3e}, moved {moved_err:.3e}", flush=True)
            require(flow_err <= FLOW_TOL, f"{name}: flow diff {flow_err} > {FLOW_TOL}")
            require(moved_err <= MOVED_TOL, f"{name}: moved diff {moved_err} > {MOVED_TOL}")
            del outs, p_outs
            times = {"kernels": [], "plain": []}
            peak = {"kernels": 0.0, "plain": 0.0}
            with torch.no_grad():
                for i in range(N_TIMED_BASELINE):
                    order = (("plain", plain), ("kernels", model)) if i % 2 else (
                        ("kernels", model), ("plain", plain))
                    for path, m in order:
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                        t0 = time.perf_counter()
                        m(x, y)
                        torch.cuda.synchronize()
                        times[path].append((time.perf_counter() - t0) * 1e3)
                        peak[path] = max(peak[path], torch.cuda.max_memory_allocated() / 2**30)
            med = {k: statistics.median(v) for k, v in times.items()}
            print(f"[{card}] {name} {'x'.join(map(str, size))} forward, median of "
                  f"{N_TIMED_BASELINE}: kernels {med['kernels']:.3f} ms/pair, plain "
                  f"{med['plain']:.3f} ms/pair (min {min(times['kernels']):.3f} / "
                  f"{min(times['plain']):.3f}); peak memory kernels {peak['kernels']:.2f} GiB, "
                  f"plain {peak['plain']:.2f} GiB", flush=True)
            with torch.no_grad():
                profile_step(model, x, y, top=8, what=f"{name} kernel forward")
            del model, plain, x, y
            torch.cuda.empty_cache()
        print(f"[{card}] K1 as Im2grid runs it, per pair: {g_ms:.4f} ms (plain {g_plain_ms:.4f}); "
              f"K2 via ops.warp over the smooth cases of phase 12: {f_ms:.4f} ms (plain "
              f"{f_plain_ms:.4f})")

    def entry(name, source, line, key, err, ms, plain_ms, counts=None):
        return {"name": name, "route": "cuda", "source": f"smilecode_tpu_torch/csrc/{source}",
                "replaces": f"smilecode_tpu/kernels/{line}",
                "launches": (counts or train_counts)[key],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    record = {"kernels": [
        entry("modet_attn_fwd", "modet_attn.cu", "modet_attn.py:56", "K1", k1_err, k1_ms,
              k1_plain_ms),
        entry("warp3d_trilinear_fwd", "warp3d.cu", "warp3d_v4.py:104", "K2", k2_err, k2_ms,
              k2_plain_ms),
        entry("modet_attn_bwd_dq", "modet_attn_bwd.cu", "modet_attn.py:183", "K3", *bwd["K3"]),
        entry("modet_attn_bwd_dk", "modet_attn_bwd.cu", "modet_attn.py:256", "K4", *bwd["K4"]),
        entry("warp3d_trilinear_bwd", "warp3d_bwd.cu", "warp3d_v4.py:339", "K5", k5_err, k5_ms,
              k5_plain_ms),
        entry("modet_attn_fwd (Im2grid: 1 head, no rpb)", "modet_attn.cu", "modet_attn.py:56",
              "K1", g_err, g_ms, g_plain_ms, base_counts),
        entry("warp3d_trilinear_fwd (ops.warp impl=pallas|guarded, baselines)", "warp3d.cu",
              "warp3d.py:52", "K2", f_err, f_ms, f_plain_ms, base_counts),
    ]}
    print(card_line())
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
