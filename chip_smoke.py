#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`smilecode_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the Hopper kernels from `smilecode_tpu_torch/csrc/` and then:

1. K1 (neighborhood attention) vs its plain PyTorch version at ModeT's five
   level shapes of a 160x192x160 pair; max abs error <= 1e-5. Per shape:
   ms per call (CUDA events, the wrapper's host time included), device ms
   (`device_ms`, below) and the bound.
2. K2 (trilinear warp) vs its plain version at the nine warp shapes of a
   pair, each with a smooth +-5 voxel flow and a wild uniform +-20 voxel
   flow; max abs error <= 1e-5 * max|src|. Each call must take the vector
   path (a lane group per voxel, 16-byte loads) where a row of C values is a
   whole number of 16-byte vectors, else the scalar path (the wrappers'
   ``launches_vector``). Per shape: the kernel's ms per call (CUDA events,
   the wrapper's host time included), its device ms (the calls queued
   behind a spin kernel, so that the events time the kernels alone),
   `F.grid_sample`'s of both, the bound and the path.
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
   shapes: dq, dl, drpb (K3) and dk (K4, on the plain dl); per shape call ms,
   device ms and bound of each.
7. K5 (warp adjoint) vs its plain version at the nine warp shapes, smooth
   +-5 and wild +-20 voxel flows: d_flow and the d_src scatter; path and
   per-shape times as phase 2, and each scatter shape's time without the
   scatter.
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
   at level 1 vs plain; call and device ms per shape as phases 1 and 6.
12. K2 through kernel F's entries, ``ops.warp(impl="pallas")`` and
   ``"guarded"``, at the baselines' warp shapes (RDN features C=16..128,
   C=3 flows, RCN's 128x192x128 image and flow, one source/flow shape
   mismatch), smooth +-5 and wild +-20 voxel flows, vs plain; one launch
   per call; path and per-shape times as phase 2.
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

The bf16 feature path (ModeT's ``compute_dtype="bfloat16"``):

15. The bf16 instances of K1-K5 vs their bf16 plain versions at the five
   attention level shapes and the four feature-warp shapes, smooth +-5 and
   wild +-20 voxel flows: bf16 outputs within 2 bf16 ulps of the plain
   output's largest magnitude, float32 outputs (drpb, d_flow) as the
   float32 gates; CUDA-event ms of each beside its plain version, the f32
   kernel at the same shapes and, for K2 and K5, `F.grid_sample` and its
   backward; K2 and K5 on the path each row calls for; device ms of each
   kernel per shape.
16. `infer.main` with ``compute_dtype=bfloat16`` on the phase-3 subjects and
   checkpoint: exactly 5 bf16 K1 and 4 bf16 + 5 f32 K2 launches per pair;
   the plain run launches nothing; Dice and fold beside the f32 run's.
17. Forwards with excited seeded weights (tests/test_modet.py's recipe):
   bf16 kernels, bf16 plain and f32 kernels. At 160x192x160 the kernels add
   nothing beyond bf16's own noise (kernels vs plain no larger than plain vs
   f32, mean and p99 of the flow endpoint error) and the moved image's p99
   stays below 0.1; at 32^3, where tests/test_modet.py sets it, both bf16
   forwards also pass the bf16-vs-f32 gate (mean < 0.06, p99 < 0.3 voxel).
   Then ms per pair (median of 12, in turns) with peak memory, and a
   profile of one bf16 kernel forward.
18. `train.main` with ``compute_dtype=bfloat16`` (6 steps, 2 validation
   pairs): per step exactly K1 5, K3 5, K4 5 (bf16), K2 4 bf16 + 5 f32, K5
   4 bf16 + 5 f32 with 8 scatters (4 bf16), plus the validation forwards;
   the plain run launches nothing and its first loss is within 1e-2.
19. One bf16 training step, kernels vs plain: the loss within 1e-2, each
   gradient within 5e-2 of its largest magnitude plus 1e-6 of the model's,
   and no further from the plain bf16 gradient than that is from the f32
   one; ms per step (median of 5) for bf16 kernels, bf16 plain and f32
   kernels with peak memory, and a profile of one bf16 kernel step.

The baseline zoo (`ZOO`: Im2grid, PCNet, PRNet, PR++, RDN, rdn_diff_share
at 160x192x160, RCN at 128x192x128, each at its reference width and depth):

20. K2 and K5 (with the d_src scatter) vs their plain versions at the zoo's
   warp shapes (`zoo_warp_cases`: PCNet's features and flows, PRNet's and
   PR++'s features, PR++'s three compositions whose source is coarser than
   the flow, RDN's C=16..128 features), smooth +-5 and wild +-20 voxel
   flows, each on its path, gates and times as phases 2 and 7; K3 and K4
   without rpb at Im2grid's five level shapes, as phase 6.
21. `infer.main` for pcnet, prnet and prnetplusplus on 2 synthetic
   160x192x160 subjects with seeded, head-perturbed JAX-format checkpoints:
   exactly 33, 9 and 9 K2 launches per pair; the plain runs launch nothing
   and give the same Dice and fold.
22. Their forwards, kernels vs plain, as phase 14.
23. `train.main` for every family (2 steps on 2 subjects, validated on the
   same 2 pairs): exact K1, K3, K4, K2, K5 launches and scatters per step
   (`ZOO`) plus the validation forwards; losses finite; for Im2grid
   (`ZOO_PLAIN_TRAIN`) the plain run launches nothing and its first loss is
   within 1e-4 (phase 24 holds every family's step against plain).
24. One training step per family, kernels vs plain, same weights and batch
   (phase 9's gates; the biases whose exact gradient is zero, as a float64
   plain step on a 64^3 crop finds them, within twice the plain step's
   float32 rounding: `compare_step_grads`), ms per step (median of 2, in
   turns) and peak memory, and a profile of one kernel step for PCNet and
   PR++. rdn_diff_share runs here at stages 2 (`ZOO_STEP_KNOBS`; its plain
   step takes ~11 s at stages 4), the others at the reference's depth.

The last TPU kernels and driver paths:

25. The root probe scripts' checks through `smilecode_tpu_torch.probes.main`
   on the card: all 17 runs of their 14 kernels exact, P1-P4 launched
   exactly 6, 8, 2 and 1 times; each kernel vs its plain version, exactly,
   on the scripts' inputs and on the card tests' edge cases (amounts and
   bounds as int32 tensors on the card under
   ``torch.cuda.set_sync_debug_mode("error")``, one launch per call); call
   ms, device ms, the plain version's, the one PyTorch call that computes
   the same function (`torch.roll`, ``x + 1``, ``x * 2``; for P2's runs
   with bounds by value ``x.unfold(0, hi - lo, 1)[base + lo:][:n].sum(-1)``;
   for P4 the pair `torch.div` floor and `torch.remainder`) and the bound
   per kernel, each library call in turns with the kernel (library,
   kernel, kernel, library) on both clocks; the same at one 160x192x160
   volume's size (`sized_cases`: P2's zero-padded 9-row box sum along D of a
   (160, 30720) x against `F.avg_pool2d`, P4's row base and column of
   every flat voxel index, centred on 0, with m = 160, against the pair),
   each held bit for bit against its plain version first; the launch floor
   (device ms of an empty `torch.cuda._sleep(0)`, call ms of P3 on 4
   values); and the host ns per call of each stage of P1's and P2's launch
   paths over LAUNCH_STAGE_CALLS calls (P1's also as every wrapper ran it
   before `kernels/_build.py:launch`: entry looked up and typed per call,
   `torch.cuda.device` entered, a `torch.cuda.Stream` built).
26. RDN's MC-dropout uncertainty protocol: `infer.main(model=rdn,
   dropout_rate=0.3, mc_iter=8)` (stages 4, levels 4,4,4,4) on 2
   160x192x160 subjects with a seeded, head-perturbed checkpoint, twice
   with the kernels (the same MC samples and statistics bit for bit) and
   once plain from the same generator seed (per pair every sample's moved
   image within 1e-4, epi and err within 1e-3 relative, UCE within 1e-2);
   exactly 8 x 136 K2 launches per pair, none plain; a
   forward with the dropout head and no generator equals the dropout-free
   one bit for bit; ms per MC sample (kernels and plain in turns, median
   of 5) and the idle share of one kernel sample.
27. `train.main` (ModeT, f32, 2 steps and 2 validation pairs) and then
   `infer.main` of its checkpoint with ``dataset=half`` (80x96x80 pairs of
   the 160x192x160 subjects; K1-K5 at a shape no other phase launches)
   and ``dataset=atlas`` (each subject to a third subject as the atlas),
   kernels and plain: phase 8's launches per step and per validation pair
   and first-loss gate, phase 3's Dice and fold gate; on one half pair,
   one step's loss and every gradient, kernels vs plain (phase 9's gates).

The last single-device modules:

28. The extended losses (`losses/extended.py`: SSIM 3D and 2D, MIND-SSC,
   global and local MI, `grad2d` l1/l2, `grad3d_itv`, the three
   displacement energies) and the repaired `grad3d` l1 on a smooth
   160x192x160 subject (plane waves in an ellipsoid: exact 0 background,
   exact 1) and that subject
   warped by the seeded ModeT's flow (K1, K2), the flow feeding the
   regularizers, `ssim2d` and `grad2d` on a 192x160 slice: float32 value
   and every gradient against the same function in float64 on the card
   (phase 9's gates: 1e-4 relative, 1e-3 of the largest gradient), ms per
   value-and-gradient (median of 5, `utils.profiling.StepTimer`) and peak
   memory; SSIM and MIND give the same bits with cuDNN's TF32 on.
29. The data tools into the main path: 2 synthetic raw subjects written as
   Analyze ``.hdr``/``.img.gz`` (int16 image, uint8 labels, little- and
   big-endian) on a 181x217x175 grid; `data.preprocess.make_pkl_dataset`
   turns them into 160x192x160 pkls; `native` equals numpy exactly on
   those volumes (`seg_remap` uint16, `minmax_normalize` on a raw image,
   `halfres` f32/u16, `dice_counts`; host ms beside numpy's), and the
   OpenMP runtimes mapped are printed; `infer.main` (ModeT f32) on the pkls
   with phase 3's checkpoint: finite Dice, exactly 5 K1 and 9 K2 launches
   per pair; one `utils.profiling.trace` of a forward into
   ``chiprun_out/trace_forward/``.

Multi-GPU training (`train.main(dp=, spatial=)`, `parallel/`), two ranks on
the one card (gloo with CUDA tensors; all_gather, all_to_all and send/recv
staged through pinned host buffers, the sums on the card):

30. The kernel modes of the D-sharded step vs their plain versions at the
   spatial=2 slabs of ModeT at 160x192x160 (80x192x160 ... 5x12x10 per
   rank): K1, K3 and K4 in halo-k mode (k of D+2 slices, its border slices
   a real neighbour's, zeros at the volume's ends; K4's dk over all D+2),
   K2 and K5 in D-origin mode at the nine warps (the source gathered to the
   full depth, d0 = rank * slab depth; K5's d_src over the gathered depth),
   each shard, smooth and wild flows; the gates of phases 1, 2, 6 and 7, the
   bf16 instances within 2 bf16 ulps; call ms, device ms, the plain
   version's and, for K2 and K5, `F.grid_sample` (and its backward) on the
   gathered source, per step of rank 1's slabs.
31. `train.main(dp=2, batch_size=2)` at 160x192x160, float32, 2 epochs of
   1 step on 2 subjects: per rank exactly K1 5, K3 5, K4 5, K2 9, K5 9 (8
   scatters) per step and no mode launch, rank 0 also its validation
   forwards; the first step's loss and averaged gradients vs the
   single-process batch-2 step of the same seed and batch (phase 9's
   gates); the parameters after the two steps equal bit for bit on both
   ranks.
32. `train.main(spatial=2)` (1 epoch of 2 steps): per rank exactly K1/K3/K4
   5 each in halo-k mode and K2/K5 9 each in D-origin mode (8 scatters) per
   step and nothing else but rank 0's validation; its first loss vs the
   unsharded step's. Then the seeded ModeT's sharded forward and
   loss-and-gradients pass vs the unsharded ones: flow within 1e-3 voxel,
   moved image within 1e-4, the loss and every gradient at phase 9's gates,
   exactly one step's mode launches; ms per sharded step (median of 3) and
   each rank's peak GiB beside the unsharded step's.

Every failed check raises, so the exit code is non-zero; without a CUDA card
it exits non-zero before printing any result. Each phase's seconds and the
total print before the record. The kernels' JSON record lists
K1-K5 with their launches in the training run of phase 8, then K1 as
Im2grid runs it and K2 as kernel F's counterpart with their launches in the
kernel runs of phase 13, then the bf16 K1-K5 with their launches in the
training run of phase 18, then K3 and K4 as Im2grid's training runs them
(phase 20's times, the launches of phase 23's Im2grid run) and K2 and K5 at
the zoo's warp shapes (phase 20's times, the launches of every phase 23
kernel run), then P1-P4 (phase 25's times and launches; ``replaces`` the
first script kernel each serves, ``serves`` all of them; P2's
``library_ms`` over its by-value runs, ``library_runs``; P2 and P4 with
``sized``, the 160x192x160 case's times, bound and share), then the five
modes of the D-sharded step (phase 30's times, rank 0's launches in phase
32's `train.main(spatial=2)`); each with its
bound (bytes or float32 operations
at the card's published peaks) and, for K2 and K5, the time of
`F.grid_sample` (forward or backward) on the same inputs, and per distinct
shape (``ms_by_shape``, ``bound_ms_by_shape``, ``device_ms_by_shape``; for
K2 and K5 also ``library_ms_by_shape``, ``variant_by_shape``,
``library_device_ms_by_shape``; ms per call). ModeT's K1-K5 rows and the
modes' also carry ``device_ms``, their device time over the path's calls
(the five level shapes, or the nine warps). Device
ms: the calls queued behind a spin kernel, so that CUDA events time the
kernels alone, without the wrapper's host time; the host's us per call
while it queued them is each row's ``host_us`` (``host_us_by_shape``),
printed per row before the record. The `infer.main` and
`train.main` runs print how many K2 and K5 launches took the vector path. The last two lines are that
record and ``{"ok": true, "device": {...}}``.
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
# phase 24: a parameter whose exact gradient is zero (float64, at most
# ZERO_GRAD_REL of the model's largest) is held to ZERO_GRAD_NOISE times the
# plain float32 step's rounding there
ZERO_GRAD_REL, ZERO_GRAD_NOISE = 1e-9, 2.0
N_VAL_SUBJECTS = 2
N_TIMED_STEPS = 5
RCN_SIZE = (128, 192, 128)  # the largest crop of 160x192x160 whose axes are multiples of 64
N_TIMED_BASELINE = 5
SPIN_CYCLES = 40_000_000  # ~20 ms of `torch.cuda._sleep` at the H100's ~1.98 GHz
# the card's published peaks (H100 SXM, dense): HBM bytes/s and float32
# operations/s outside the tensor cores; every kernel computes in float32,
# its bf16 instances included, so float32 is their operations' type
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the bf16 feature path
BF16_TOL = 2.0 ** -7  # 2 bf16 ulps, times the plain output's largest magnitude
BF16_FLOW_MEAN, BF16_FLOW_P99, BF16_MOVED_P99 = 0.06, 0.3, 0.1  # voxel, bf16 vs f32 (bench.py)
BF16_STEP_LOSS_TOL = 1e-2  # relative, kernels vs plain bf16 step
BF16_STEP_GRAD_TOL = 5e-2  # times each parameter's largest |gradient|
EXCITE_STD, EXCITE_SEED = 0.1, 20  # tests/test_modet.py's excitation; tests/test_torch_bf16.py's seed
GATE_SHAPE = (32, 32, 32)  # where tests/test_modet.py sets the bf16-vs-f32 gate
# ModeT's feature warps on the bf16 path: (what, channels, level)
FEATURE_WARPS = [("level4 features", 64, 4), ("level3 features", 32, 3),
                 ("level2 features", 16, 2), ("level1 features", 8, 1)]
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
                  "rdn_diff_share": ("conv.4", 0.02), "rcn": ("Pred0", 0.1),
                  "pcnet": ("reg_conv", 0.02), "prnet": (".flow.", 0.1),
                  "prnetplusplus": (".flow.", 0.2)}
# The baseline zoo of phases 20-24: volume size, K1 and K2 launches per
# pair, and per training step the K1, K3, K4, K2 and K5 launches and the K5
# launches that scatter d_src (`STEP_KEYS`; every warp whose source needs a
# gradient: all but the moved image's, and RCN's re-warps of the moving
# image). Derived from the JAX modules: PCNet warps in 3 DFI vecints of 7
# steps, vecint(pred0), 3 feature warps, T(wf0, pred0) and the moved image
# (33); PRNet and PR++ in 4 feature warps, 4 compositions and the moved
# image (9); the others as `BASELINES`. CPU tests count the same calls
# (`tests/test_torch_baselines.py::test_kernel_wrapper_calls_per_pair`,
# `tests/test_torch_baselines_train.py::test_kernel_wrapper_calls_per_training_step`).
ZOO = {"im2grid": (SIZE, (5, 9), (5, 5, 5, 9, 9, 8)),
       "pcnet": (SIZE, (0, 33), (0, 0, 0, 33, 33, 32)),
       "prnet": (SIZE, (0, 9), (0, 0, 0, 9, 9, 8)),
       "prnetplusplus": (SIZE, (0, 9), (0, 0, 0, 9, 9, 8)),
       "rdn": (SIZE, (0, 136), (0, 0, 0, 136, 136, 135)),
       "rdn_diff_share": (SIZE, (0, 644), (0, 0, 0, 644, 644, 643)),
       "rcn": (RCN_SIZE, (0, 19), (0, 0, 0, 19, 19, 9))}
STEP_KEYS = ("K1", "K3", "K4", "K2", "K5", "K5 d_src")
ZOO_SERVED = ("pcnet", "prnet", "prnetplusplus")  # served by phases 21 and 22
ZOO_STEPS, ZOO_VAL_PAIRS = 2, 2  # train.main on 2 subjects, validated on the same 2
# phase 23's plain train.main runs (the families whose plain run is checked
# to launch nothing); phase 24 holds every family's step against plain
ZOO_PLAIN_TRAIN = ("im2grid",)
N_TIMED_ZOO_STEPS = 2
# phase 24 runs these families at a cut depth, to keep the script within its
# time budget: rdn_diff_share's plain step takes ~11 s at stages 4 on the
# H100 (PERF.md §6). Every kernel and shape of its step stays; phase 23
# trains it at the reference's depth.
ZOO_STEP_KNOBS = {"rdn_diff_share": {"stages": 2}}
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


PHASE_SECONDS: dict = {}  # phase number -> seconds, filled by `phase`
_phase_clock: list = []  # [the running phase's number, its start]


def _close_phase() -> None:
    if _phase_clock:
        PHASE_SECONDS[_phase_clock[0]] = time.perf_counter() - _phase_clock[1]
        _phase_clock.clear()


def phase(number: int, title: str) -> None:
    """Print the banner of phase ``number``, closing the running phase's
    clock, so that `phase_times` can say how long each phase took."""
    _close_phase()
    _phase_clock[:] = [number, time.perf_counter()]
    print(f"== phase {number}: {title}", flush=True)


def phase_times(start: float) -> str:
    """Each phase's seconds and the total since ``start``."""
    _close_phase()
    return (", ".join(f"phase {n} {t:.1f} s" for n, t in sorted(PHASE_SECONDS.items()))
            + f"; total {time.perf_counter() - start:.1f} s")


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


class DeviceMs(float):
    """A device ms per call (`device_ms`), carrying ``host_us``: the host's
    us per call while it queued those calls (the wrapper's Python and the
    launch)."""

    host_us: float


def device_ms(fn, iters: int = 20) -> DeviceMs:
    """Mean device ms per call of ``fn`` with the host's time left out: a
    spin kernel (`torch.cuda._sleep`, ~20 ms) holds the stream while the
    host queues the ``iters`` calls, so the events time their kernels back
    to back. `event_ms` includes the host's time between launches, which
    sets a call's pace when its kernels take less time than its Python
    side. Raises if the host took longer to queue the calls than the spin
    lasted."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin_start = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    spin_start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    spin_ms = spin_start.elapsed_time(start)
    require(host_ms < spin_ms, f"device_ms: queueing took {host_ms:.3f} ms, the spin {spin_ms:.3f}")
    res = DeviceMs(start.elapsed_time(end) / iters)
    res.host_us = host_ms * 1e3 / iters
    return res


def bound(nbytes: float, ops: float):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` (each input read once, each output written once) and do
    ``ops`` float32 operations, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_work(kernel: str, shape, isz: int, with_rpb=True):
    """(bytes, float32 operations) of one attention kernel call on q and k of
    ``shape`` (B, D, H, W, heads, hd) with ``isz``-byte values (K1 forward,
    K3 dq/dl/drpb partials, K4 dk). Operations per (voxel, head): 27 tokens
    of a head_dim dot product (2*hd), the bias add, exp and the online
    softmax (~10); K3 adds the dl arithmetic and the dq contraction (2*hd +
    6); K4 is the 27-token dk contraction alone."""
    from smilecode_tpu_torch.kernels.modet_attn import attn_geometry

    voxels, heads, hd = int(np.prod(shape[:4])), shape[4], shape[5]
    rows = voxels * heads
    rpb = heads * 27 * 4 if with_rpb else 0
    if kernel == "K1":
        return rows * (2 * hd + 3) * isz + rpb, rows * (27 * (2 * hd + 10) + 3)
    if kernel == "K3":
        # the drpb partials: one (heads, 27) float32 row per block of K3's grid
        blocks = attn_geometry(shape, isz)[3] if with_rpb else 0
        parts = blocks * heads * 27 * 4
        return (rows * (3 * hd + 3 + 27) * isz + rpb + parts,
                rows * 27 * (4 * hd + 16))
    return rows * (2 * hd + 27) * isz, rows * 27 * 2 * hd  # K4


def warp_work(kernel: str, src_voxels: int, voxels: int, c: int, isz: int, scatter=False):
    """(bytes, float32 operations) of one warp kernel call: K2 reads the
    source once, the float32 flow and writes C values per output voxel; K5
    also reads g and writes the float32 d_flow, and d_src when it scatters.
    Operations per output voxel: ~40 for coordinates and corner weights, 8
    corners x C multiply-adds (K2); K5 the same plus the derivative
    coefficients, and 8 x C more for the scatter."""
    if kernel == "K2":
        return src_voxels * c * isz + voxels * (12 + c * isz), voxels * (40 + 16 * c)
    nbytes = src_voxels * c * isz * (2 if scatter else 1) + voxels * (24 + c * isz)
    return nbytes, voxels * (60 + 16 * c * (2 if scatter else 1))


def grid_sample_args(src, flow, requires_grad=False, d0=None):
    """`F.grid_sample`'s input (N, C, D, H, W) and normalised (x, y, z) grid
    for the warp of ``src`` by ``flow`` (align_corners=True, zeros outside):
    the library call that computes K2's function, in src's dtype. ``d0``:
    K2's D-origin mode, coordinates (fd + d0, fh, fw) + flow into a source
    of its own depth."""
    import torch

    fd, fh, fw = flow.shape[1:4]
    axes = [torch.arange(n, dtype=torch.float32, device=flow.device) for n in (fd, fh, fw)]
    coords = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1) + flow
    extent = (fd, fh, fw)
    if d0 is not None:
        coords[..., 0] += d0
        extent = src.shape[1:4]
    size = torch.tensor([max(n - 1, 1) for n in extent], dtype=torch.float32,
                        device=flow.device)
    grid = (2 * coords / size - 1).flip(-1).to(src.dtype).contiguous()
    inp = src.permute(0, 4, 1, 2, 3).contiguous()
    return inp.requires_grad_(requires_grad), grid.requires_grad_(requires_grad)


def library_warp_ms(src, flow, g=None, want_dsrc=True, iters=10, timer=None, d0=None):
    """CUDA-event ms (or ``timer``'s, e.g. `device_ms`) of `F.grid_sample`
    on (src, flow), or with ``g`` of its backward (d_input only when
    ``want_dsrc``, and d_grid); a bf16 source takes a bf16 grid, which
    grid_sample requires. Timed here as a yardstick only: the port never
    calls it. None when this torch build has no such call for src's dtype."""
    try:
        return _library_warp_ms(src, flow, g, want_dsrc, iters, timer or event_ms, d0)
    except (RuntimeError, NotImplementedError) as e:
        print(f"  F.grid_sample on {src.dtype}: not available ({str(e).splitlines()[0]})")
        return None


def _library_warp_ms(src, flow, g, want_dsrc, iters, timer, d0=None):
    import torch
    import torch.nn.functional as F

    inp, grid = grid_sample_args(src, flow, d0=d0)
    if g is None:
        return timer(lambda: F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                                           align_corners=True), iters)
    inp.requires_grad_(want_dsrc)
    grid.requires_grad_()
    out = F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    gl = g.permute(0, 4, 1, 2, 3).contiguous()
    wrt = (inp, grid) if want_dsrc else (grid,)
    return timer(lambda: torch.autograd.grad(out, wrt, gl, retain_graph=True), iters)


def warp_path(fn, before, c, src, what):
    """The path that the last call of K2 or K5 (wrapper ``fn``, whose
    ``launches_vector`` was ``before``) took: "vector G=<lanes per voxel>"
    or "scalar". Every tensor here is a fresh, 16-byte aligned allocation, so
    the vector path is required exactly where a row of C values is a whole
    number of 16-byte vectors."""
    from smilecode_tpu_torch.kernels.warp3d import _lanes_per_voxel

    vector = (c * src.element_size()) % 16 == 0
    took = fn.launches_vector - before
    require(took == int(vector), f"{what}: {took} vector-path launches, expected {int(vector)}")
    return f"vector G={_lanes_per_voxel(c, src.element_size(), 0)}" if vector else "scalar"


def warp_path_device_ms(by_shape, bwd=False) -> float:
    """Device ms over a pair's (K2) or a step's (K5, the moved image's
    without the scatter) nine warps, from `check_warp`'s or
    `check_warp_bwd`'s per-shape device ms."""
    return sum(by_shape[shape_label(c, level_shape(level), " without d_src"
                                    if bwd and what == "moved image" else "")]["device_ms"]
               for what, c, level in warp_calls())


def shape_label(c, shape, extra=""):
    return f"C={c} {'x'.join(map(str, shape))}{extra}"


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


def attn_label(level, shape):
    return f"level {level} {'x'.join(map(str, shape[1:4]))} heads {shape[4]}"


def check_attention(device, size=SIZE, timed=True, num_heads=NUM_HEADS, with_rpb=True):
    """K1 vs plain at every level shape (heads per level 5..1, with or
    without rpb); returns (max_err, ms, plain_ms, (bytes, operations),
    device_ms) per pair and per level shape {label: dict(ms, device_ms,
    bound_ms)}, ms per call."""
    import torch

    from smilecode_tpu_torch.kernels.modet_attn import modet_attention, modet_attention_plain

    rng = np.random.default_rng(1)
    worst, ms, plain_ms, dev_ms, work, by_shape = 0.0, 0.0, 0.0, 0.0, np.zeros(2), {}
    for level, heads in zip((5, 4, 3, 2, 1), num_heads):
        shape = (1, *level_shape(level, size), heads, HEAD_DIM)
        shape_work = attn_work("K1", shape, 4, with_rpb)
        work += shape_work
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
            dev = device_ms(lambda: modet_attention(q, k, rpb, 1.0))
            bound_ms = bound(*shape_work)[0]
            ms, plain_ms, dev_ms = ms + t, plain_ms + tp, dev_ms + dev
            by_shape[attn_label(level, shape)] = {"ms": t, "device_ms": dev, "bound_ms": bound_ms}
            line += (f", kernel {t:.4f} ms, device {dev:.4f} ms, plain {tp:.4f} ms, bound "
                     f"{bound_ms:.4f} ms")
        print(line, flush=True)
    return worst, ms, plain_ms, tuple(work), dev_ms, by_shape


def check_warp(device, size=SIZE, timed=True):
    """K2 vs plain at the pair's warp shapes, smooth and wild flows, each
    on the path its row calls for; returns (max_err, ms, plain_ms,
    grid_sample ms, (bytes, operations)) summed over the nine calls of a pair
    (smooth flows), and per distinct shape {label: dict(ms, library_ms,
    bound_ms, variant)}, ms per call."""
    import torch

    from smilecode_tpu_torch.kernels.warp3d import warp3d_trilinear, warp3d_trilinear_plain

    rng = np.random.default_rng(2)
    worst, times, by_shape = 0.0, {}, {}
    for _, c, level in warp_calls():
        key = (c, level)
        if key in times:
            continue
        shape = level_shape(level, size)
        vox = int(np.prod(shape))
        bound_ms = bound(*warp_work("K2", vox, vox, c, 4))[0]
        src = torch.from_numpy(rng.standard_normal((1, *shape, c), dtype=np.float32)).to(device)
        flows = {"smooth +-5": smooth_flow(shape, 5.0, device),
                 "wild +-20": torch.from_numpy(
                     rng.uniform(-20, 20, (1, *shape, 3)).astype(np.float32)).to(device)}
        tol = WARP_TOL * float(src.abs().max())
        for name, flow in flows.items():
            before = warp3d_trilinear.launches_vector
            out = warp3d_trilinear(src, flow)
            variant = warp_path(warp3d_trilinear, before, c, src, f"warp C={c} {shape}")
            err = float((out - warp3d_trilinear_plain(src, flow)).abs().max())
            require(bool(torch.isfinite(out).all()), f"warp C={c} {shape} {name}: not finite")
            require(err <= tol, f"warp C={c} {shape} {name}: max abs err {err} > {tol}")
            worst = max(worst, err)
            line = f"K2 warp C={c} {shape} {name} ({variant}): max_abs_err {err:.3e} (tol {tol:.3e})"
            if timed:
                t = event_ms(lambda: warp3d_trilinear(src, flow), 20)
                tp = event_ms(lambda: warp3d_trilinear_plain(src, flow), 5)
                lib = library_warp_ms(src, flow)
                line += (f", kernel {t:.4f} ms, plain {tp:.4f} ms, F.grid_sample {lib:.4f} ms, "
                         f"bound {bound_ms:.4f} ms")
                if name.startswith("smooth"):
                    times[key] = (t, tp, lib)
                    dev = (device_ms(lambda: warp3d_trilinear(src, flow)),
                           library_warp_ms(src, flow, timer=device_ms))
                    line += f"; device ms kernel {dev[0]:.4f}, F.grid_sample {fmt_ms(dev[1])}"
                    by_shape[shape_label(c, shape)] = {
                        "ms": t, "library_ms": lib, "bound_ms": bound_ms, "variant": variant,
                        "device_ms": dev[0], "library_device_ms": dev[1]}
            print(line, flush=True)
        times.setdefault(key, (0.0, 0.0, 0.0))
    calls = [(c, level) for _, c, level in warp_calls()]
    ms, plain_ms, lib_ms = (sum(times[k][i] for k in calls) for i in range(3))
    work = np.zeros(2)
    for c, level in calls:
        vox = int(np.prod(level_shape(level, size)))
        work += warp_work("K2", vox, vox, c, 4)
    return worst, ms, plain_ms, lib_ms, tuple(work), by_shape


def check_attention_bwd(device, size=SIZE, specs=tuple(zip((5, 4, 3, 2, 1), NUM_HEADS)),
                        with_rpb=True):
    """K3, K4 vs their plain versions at every level shape; returns
    {kernel: (max_err, ms, plain_ms, (bytes, operations), device_ms,
    by_shape)} summed over the five calls of a training step, with per level
    shape {label: dict(ms, device_ms, bound_ms)}, ms per call.

    Tolerances: dq, dl and dk within BWD_TOL of the plain version's largest
    magnitude (27-term float32 sums in another order). drpb sums dl_t over
    every voxel, and the terms cancel (sum_t dl_t = 0 at each voxel), so its
    rounding scales with sum_x |dl_t|, not with drpb: it is held within
    DRPB_TOL of the largest sum_x |dl_t| of the plain dl (K3 adds each
    block's rows in a fixed order, then torch adds the blocks; a dropped
    block would be off by hundreds of |dl| and fail)."""
    import torch

    from smilecode_tpu_torch.kernels.modet_attn import (
        modet_attention_bwd_dk,
        modet_attention_bwd_dk_plain,
        modet_attention_bwd_dq,
        modet_attention_bwd_dq_plain,
    )

    rng = np.random.default_rng(5)
    res = {key: [0.0, 0.0, 0.0, np.zeros(2), 0.0, {}] for key in ("K3", "K4")}
    for level, heads in specs:
        shape = (1, *level_shape(level, size), heads, HEAD_DIM)
        works = {key: attn_work(key, shape, 4, with_rpb) for key in res}
        for key in res:
            res[key][3] += works[key]
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
        d3 = device_ms(lambda: modet_attention_bwd_dq(q, k, rpb, 1.0, g))
        d4 = device_ms(lambda: modet_attention_bwd_dk(q, p_dl, 1.0))
        k3_err = max(e for n, (e, _) in errs.items() if n != "dk")
        for key, err, t, tp, dev in (("K3", k3_err, t3, p3, d3), ("K4", errs["dk"][0], t4, p4, d4)):
            r = res[key]
            r[:3] = [max(r[0], err), r[1] + t, r[2] + tp]
            r[4] += dev
            r[5][attn_label(level, shape)] = {"ms": t, "device_ms": dev,
                                              "bound_ms": bound(*works[key])[0]}
        print(f"K3/K4 attention bwd level {level} q,k {shape}, rpb "
              f"{'yes' if with_rpb else 'none'}: max_abs_err "
              + ", ".join(f"{n} {e:.3e} (tol {t:.3e})" for n, (e, t) in errs.items())
              + f"; K3 {t3:.4f} ms, device {d3:.4f} (plain {p3:.4f}, bound "
              f"{bound(*works['K3'])[0]:.4f}), K4 {t4:.4f} ms, device {d4:.4f} (plain {p4:.4f}, "
              f"bound {bound(*works['K4'])[0]:.4f})", flush=True)
        del q, k, g, dq, dl, part, p_dq, p_dl, p_drpb, dk, p_dk, checks
        torch.cuda.empty_cache()
    return {key: (*v[:3], tuple(v[3]), *v[4:]) for key, v in res.items()}


def check_warp_f(device):
    """K2 through kernel F's entries, ``ops.warp(impl="pallas" | "guarded")``,
    vs plain at `F_CASES`, smooth and wild flows; exactly one launch per
    call, on the path its row calls for. Returns (max_err, ms, plain_ms,
    grid_sample ms, (bytes, operations)), summed over the smooth cases of
    "pallas", one call each, and per case {label: dict(ms, library_ms,
    bound_ms, variant)}."""
    import torch

    from smilecode_tpu_torch.kernels.warp3d import warp3d_trilinear, warp3d_trilinear_plain
    from smilecode_tpu_torch.ops.warp import warp

    rng = np.random.default_rng(8)
    worst, ms, plain_ms, lib_ms, work, by_shape = 0.0, 0.0, 0.0, 0.0, np.zeros(2), {}
    for what, src_shape, flow_shape, c in F_CASES:
        case_work = warp_work("K2", int(np.prod(src_shape)), int(np.prod(flow_shape)), c, 4)
        work += case_work
        bound_ms = bound(*case_work)[0]
        src = torch.from_numpy(rng.standard_normal((1, *src_shape, c), dtype=np.float32)).to(device)
        flows = {"smooth +-5": smooth_flow(flow_shape, 5.0, device),
                 "wild +-20": torch.from_numpy(
                     rng.uniform(-20, 20, (1, *flow_shape, 3)).astype(np.float32)).to(device)}
        tol = WARP_TOL * float(src.abs().max())
        for name, flow in flows.items():
            ref = warp3d_trilinear_plain(src, flow)
            line = f"K2 via ops.warp {what} C={c} src {src_shape} flow {flow_shape} {name}:"
            for impl in ("pallas", "guarded"):
                before, vectors = warp3d_trilinear.launches, warp3d_trilinear.launches_vector
                out = warp(src, flow, impl=impl)
                require(warp3d_trilinear.launches == before + 1, f"warp(impl={impl!r}) did not "
                                                                 "launch K2 exactly once")
                variant = warp_path(warp3d_trilinear, vectors, c, src, f"{line} impl={impl}")
                err = float((out - ref).abs().max())
                require(bool(torch.isfinite(out).all()) and out.shape == (1, *flow_shape, c),
                        f"{line} impl={impl}: output not finite or of the wrong shape")
                require(err <= tol, f"{line} impl={impl}: max abs err {err} > {tol}")
                worst = max(worst, err)
                line += f" {impl} max_abs_err {err:.3e}"
            t = event_ms(lambda: warp(src, flow, impl="pallas"), 20)
            tp = event_ms(lambda: warp3d_trilinear_plain(src, flow), 5)
            lib = library_warp_ms(src, flow)
            line = (f"{line} (tol {tol:.3e}; {variant}), kernel {t:.4f} ms, plain {tp:.4f} ms, "
                    f"F.grid_sample {lib:.4f} ms, bound {bound_ms:.4f} ms")
            if name.startswith("smooth"):
                ms, plain_ms, lib_ms = ms + t, plain_ms + tp, lib_ms + lib
                dev = (device_ms(lambda: warp(src, flow, impl="pallas")),
                       library_warp_ms(src, flow, timer=device_ms))
                line += f"; device ms kernel {dev[0]:.4f}, F.grid_sample {fmt_ms(dev[1])}"
                by_shape[f"{what} {shape_label(c, flow_shape)}"] = {
                    "ms": t, "library_ms": lib, "bound_ms": bound_ms, "variant": variant,
                    "device_ms": dev[0], "library_device_ms": dev[1]}
            print(line, flush=True)
        del src, flows, ref, out
        torch.cuda.empty_cache()
    return worst, ms, plain_ms, lib_ms, tuple(work), by_shape


def fmt_ms(t):
    return "n/a" if t is None else f"{t:.4f}"


def bf16_err(out, ref, what):
    """max |out - ref| of two bf16 (or float32) tensors, in float32, held to
    2 bf16 ulps of ref's largest magnitude; returns (err, tol)."""
    import torch

    out, ref = out.float(), ref.float()
    require(bool(torch.isfinite(out).all()), f"{what}: not finite")
    err, tol = float((out - ref).abs().max()), BF16_TOL * float(ref.abs().max())
    require(err <= tol, f"{what}: max abs err {err} > {tol}")
    return err, tol


def check_bf16_kernels(device):
    """Phase 15: the bf16 instances of K1-K5 against their bf16 plain
    versions, at the five attention level shapes (K1, K3, K4) and the four
    feature-warp shapes (K2, K5), smooth +-5 and wild +-20 voxel flows.
    bf16 outputs (K1 out, K2 out, K3 dq and dl, K4 dk, K5 d_src) within 2 bf16
    ulps of the plain output's largest magnitude; float32 outputs as the
    float32 gates (K5 d_flow BWD_TOL, drpb DRPB_TOL of the largest sum_x|dl_t|).
    Times per pair (K1, K2) or per training step (K3, K4, K5) over the bf16
    calls of the path, on the smooth flows: the kernel, its plain version,
    the float32 kernel at the same shapes and, for K2 and K5,
    `F.grid_sample` and its backward on the bf16 source; K2 and K5 on the
    path each row calls for, with per-shape times in ``by_shape`` (ms per
    call). Returns {kernel: dict(err, ms, plain_ms, f32_ms, library_ms,
    work, by_shape)}."""
    import torch

    from smilecode_tpu_torch.kernels.modet_attn import (
        modet_attention,
        modet_attention_bwd_dk,
        modet_attention_bwd_dk_plain,
        modet_attention_bwd_dq,
        modet_attention_bwd_dq_plain,
        modet_attention_plain,
    )
    from smilecode_tpu_torch.kernels.warp3d import (
        warp3d_trilinear,
        warp3d_trilinear_bwd,
        warp3d_trilinear_bwd_plain,
        warp3d_trilinear_plain,
    )

    bf16 = torch.bfloat16
    res = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "f32_ms": 0.0, "library_ms": None,
               "work": np.zeros(2), "by_shape": {}, "device_ms": None}
           for k in ("K1", "K2", "K3", "K4", "K5")}

    def add(key, err, t, tp, t32, lib=None):
        r = res[key]
        r["err"] = max(r["err"], err)
        r["ms"], r["plain_ms"], r["f32_ms"] = r["ms"] + t, r["plain_ms"] + tp, r["f32_ms"] + t32
        if lib is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib

    rng = np.random.default_rng(10)
    for level, heads in zip((5, 4, 3, 2, 1), NUM_HEADS):
        shape = (1, *level_shape(level), heads, HEAD_DIM)
        q32, k32 = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)
                    for _ in range(2))
        rpb = torch.from_numpy(rng.standard_normal((heads, 3, 3, 3), dtype=np.float32) * 0.5).to(device)
        g32 = torch.from_numpy(rng.standard_normal((*shape[:4], heads * 3),
                                                   dtype=np.float32)).to(device)
        q, k, g = q32.to(bf16), k32.to(bf16), g32.to(bf16)
        out = modet_attention(q, k, rpb, 1.0)
        require(out.dtype == bf16, f"K1 bf16 level {level}: output {out.dtype}")
        e1 = bf16_err(out, modet_attention_plain(q, k, rpb, 1.0), f"K1 bf16 level {level}")
        dq, dl, part = modet_attention_bwd_dq(q, k, rpb, 1.0, g)
        p_dq, p_dl, p_drpb = modet_attention_bwd_dq_plain(q, k, rpb, 1.0, g)
        require(dq.dtype == dl.dtype == bf16 and part.dtype == torch.float32,
                f"K3 bf16 level {level}: dtypes {dq.dtype}, {dl.dtype}, {part.dtype}")
        e_dq = bf16_err(dq, p_dq, f"K3 bf16 level {level} dq")
        e_dl = bf16_err(dl, p_dl, f"K3 bf16 level {level} dl")
        drpb = part.sum(0).reshape(heads, 3, 3, 3)
        e_drpb = float((drpb - p_drpb).abs().max())
        drpb_tol = DRPB_TOL * float(p_dl.float().abs().sum(dim=(0, 1, 2, 3)).max())
        require(e_drpb <= drpb_tol, f"K3 bf16 level {level} drpb: {e_drpb} > {drpb_tol}")
        e_dk = bf16_err(modet_attention_bwd_dk(q, p_dl, 1.0), modet_attention_bwd_dk_plain(q, p_dl, 1.0),
                        f"K4 bf16 level {level} dk")
        p_dl32 = p_dl.float()
        times = {
            "K1": (event_ms(lambda: modet_attention(q, k, rpb, 1.0), 20),
                   event_ms(lambda: modet_attention_plain(q, k, rpb, 1.0), 2),
                   event_ms(lambda: modet_attention(q32, k32, rpb, 1.0), 10)),
            "K3": (event_ms(lambda: modet_attention_bwd_dq(q, k, rpb, 1.0, g), 10),
                   event_ms(lambda: modet_attention_bwd_dq_plain(q, k, rpb, 1.0, g), 2),
                   event_ms(lambda: modet_attention_bwd_dq(q32, k32, rpb, 1.0, g32), 10)),
            "K4": (event_ms(lambda: modet_attention_bwd_dk(q, p_dl, 1.0), 10),
                   event_ms(lambda: modet_attention_bwd_dk_plain(q, p_dl, 1.0), 2),
                   event_ms(lambda: modet_attention_bwd_dk(q32, p_dl32, 1.0), 10)),
        }
        devs = {"K1": device_ms(lambda: modet_attention(q, k, rpb, 1.0)),
                "K3": device_ms(lambda: modet_attention_bwd_dq(q, k, rpb, 1.0, g)),
                "K4": device_ms(lambda: modet_attention_bwd_dk(q, p_dl, 1.0))}
        errs = {"K1": e1[0], "K3": max(e_dq[0], e_dl[0], e_drpb), "K4": e_dk[0]}
        for key, (t, tp, t32) in times.items():
            add(key, errs[key], t, tp, t32)
            work = attn_work(key, shape, 2)
            res[key]["work"] += work
            res[key]["device_ms"] = (res[key]["device_ms"] or 0.0) + devs[key]
            res[key]["by_shape"][attn_label(level, shape)] = {
                "ms": t, "device_ms": devs[key], "bound_ms": bound(*work)[0]}
        print(f"bf16 K1/K3/K4 level {level} q,k {shape}: max_abs_err out {e1[0]:.3e} (tol "
              f"{e1[1]:.3e}), dq {e_dq[0]:.3e} ({e_dq[1]:.3e}), dl {e_dl[0]:.3e} ({e_dl[1]:.3e}), "
              f"drpb {e_drpb:.3e} ({drpb_tol:.3e}), dk {e_dk[0]:.3e} ({e_dk[1]:.3e}); ms bf16 / "
              f"plain bf16 / f32 kernel: " + ", ".join(
                  f"{key} {t:.4f} / {tp:.4f} / {t32:.4f}" for key, (t, tp, t32) in times.items())
              + "; device ms bf16: " + ", ".join(f"{key} {v:.4f}" for key, v in devs.items()),
              flush=True)
        del q, k, g, q32, k32, g32, out, dq, dl, part, p_dq, p_dl, p_drpb, p_dl32
        torch.cuda.empty_cache()

    for what, c, level in FEATURE_WARPS:
        shape = level_shape(level)
        vox = int(np.prod(shape))
        src32 = torch.from_numpy(rng.standard_normal((1, *shape, c), dtype=np.float32)).to(device)
        g32 = torch.from_numpy(rng.standard_normal((1, *shape, c), dtype=np.float32)).to(device)
        src, g = src32.to(bf16), g32.to(bf16)
        flows = {"smooth +-5": smooth_flow(shape, 5.0, device),
                 "wild +-20": torch.from_numpy(
                     rng.uniform(-20, 20, (1, *shape, 3)).astype(np.float32)).to(device)}
        work = {"K2": warp_work("K2", vox, vox, c, 2), "K5": warp_work("K5", vox, vox, c, 2, True)}
        bound_ms = {key: bound(*w)[0] for key, w in work.items()}
        for name, flow in flows.items():
            line = f"bf16 K2/K5 {what} C={c} {shape} {name}:"
            before = warp3d_trilinear.launches_vector, warp3d_trilinear_bwd.launches_vector
            out = warp3d_trilinear(src, flow)
            variant = warp_path(warp3d_trilinear, before[0], c, src, f"{line} K2")
            require(out.dtype == bf16, f"{line} K2 output {out.dtype}")
            e2 = bf16_err(out, warp3d_trilinear_plain(src, flow), f"{line} K2")
            d_src, d_flow = warp3d_trilinear_bwd(src, flow, g, True)
            warp_path(warp3d_trilinear_bwd, before[1], c, src, f"{line} K5")
            p_src, p_flow = warp3d_trilinear_bwd_plain(src, flow, g, True)
            require(d_src.dtype == bf16 and d_flow.dtype == torch.float32,
                    f"{line} K5 dtypes {d_src.dtype}, {d_flow.dtype}")
            e_src = bf16_err(d_src, p_src, f"{line} K5 d_src")
            e_flow = float((d_flow - p_flow).abs().max())
            flow_tol = BWD_TOL * float(p_flow.abs().max())
            require(e_flow <= flow_tol, f"{line} K5 d_flow: {e_flow} > {flow_tol}")
            line += (f" max_abs_err out {e2[0]:.3e} (tol {e2[1]:.3e}), d_src {e_src[0]:.3e} "
                     f"({e_src[1]:.3e}), d_flow {e_flow:.3e} ({flow_tol:.3e})")
            t2 = (event_ms(lambda: warp3d_trilinear(src, flow), 20),
                  event_ms(lambda: warp3d_trilinear_plain(src, flow), 2),
                  event_ms(lambda: warp3d_trilinear(src32, flow), 10),
                  library_warp_ms(src, flow))
            t5 = (event_ms(lambda: warp3d_trilinear_bwd(src, flow, g, True), 10),
                  event_ms(lambda: warp3d_trilinear_bwd_plain(src, flow, g, True), 2),
                  event_ms(lambda: warp3d_trilinear_bwd(src32, flow, g32, True), 10),
                  library_warp_ms(src, flow, g, True))
            print(f"{line} {variant}; ms bf16 / plain bf16 / f32 kernel / F.grid_sample bf16: K2 "
                  + " / ".join(map(fmt_ms, t2)) + f" (bound {bound_ms['K2']:.4f}), K5 with d_src "
                  + " / ".join(map(fmt_ms, t5)) + f" (bound {bound_ms['K5']:.4f})", flush=True)
            if name.startswith("smooth"):
                add("K2", e2[0], *t2)
                add("K5", max(e_src[0], e_flow), *t5)
                dev = {"K2": (device_ms(lambda: warp3d_trilinear(src, flow)),
                              library_warp_ms(src, flow, timer=device_ms)),
                       "K5": (device_ms(lambda: warp3d_trilinear_bwd(src, flow, g, True)),
                              library_warp_ms(src, flow, g, True, timer=device_ms))}
                print(f"  device ms, kernel / F.grid_sample bf16: " + ", ".join(
                    f"{key} {v[0]:.4f} / {fmt_ms(v[1])}" for key, v in dev.items()), flush=True)
                for key, t in (("K2", t2), ("K5", t5)):
                    res[key]["by_shape"][shape_label(c, shape)] = {
                        "ms": t[0], "library_ms": t[3], "bound_ms": bound_ms[key],
                        "variant": variant, "device_ms": dev[key][0],
                        "library_device_ms": dev[key][1]}
            else:
                for key, err in (("K2", e2[0]), ("K5", max(e_src[0], e_flow))):
                    res[key]["err"] = max(res[key]["err"], err)
        for key, w in work.items():
            res[key]["work"] += w
        del src, g, src32, g32, flows, out, d_src, d_flow, p_src, p_flow
        torch.cuda.empty_cache()
    return res


def excited_model(device, attn_impl="auto", compute_dtype="", seed=EXCITE_SEED):
    """Full-width ModeT from ``seed`` with EXCITE_STD * N(0, 1) from numpy
    seed ``seed + 1`` added to the projection kernels and the rpb, so that
    the flows are not near zero and bf16's effect on them is measurable:
    tests/test_modet.py's recipe, and the weights of
    tests/test_torch_bf16.py's 32^3 forward."""
    import torch

    from smilecode_tpu_torch.models import ModeT

    model = ModeT(channels=4, head_dim=HEAD_DIM, num_heads=NUM_HEADS, qk_scale=1.0,
                  attn_impl=attn_impl, compute_dtype=compute_dtype, device=device,
                  generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("proj.weight", "rpb")):
                p.add_(torch.from_numpy(EXCITE_STD * rng.standard_normal(p.shape).astype(np.float32))
                       .to(device))
    return model.eval()


def blob_vol(shape, seed, device):
    """(1, D, H, W, 1) sum of 30 random Gaussian blobs in [0, 1]
    (tests/test_modet.py, tests/test_torch_bf16.py)."""
    import torch

    g = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    r = np.random.default_rng(seed)
    v = np.zeros(shape, np.float32)
    for _ in range(30):
        c, s, a = r.uniform(4, max(shape) - 4, 3), r.uniform(2, 6), r.uniform(0.3, 1.0)
        v += a * np.exp(-np.sum((g - c) ** 2, -1) / (2 * s * s))
    v = ((v - v.min()) / (v.max() - v.min())).astype(np.float32)
    return torch.from_numpy(v[None, ..., None]).to(device)


def flow_gap(a, b):
    """(mean, p99) of |a - b| over every flow component (bench.py's gate)."""
    err = (a - b).abs().flatten().cpu().numpy()
    return float(err.mean()), float(np.percentile(err, 99))


def seeded_baseline(name, device, attn_impl="auto", **knobs):
    """Baseline ``name`` as `build_model` makes it (the reference's depth:
    RCN 10 cascades, RDN stages 4 and levels (4, 4, 4, 4), unless ``knobs``
    say otherwise; ``dropout_rate`` adds no parameter) from seed 0, with
    the flow heads perturbed from a numpy seed (`BASELINE_HEADS`): their
    N(0, 1e-5) or zero init would leave the flows near identity, where a
    warp bug hides."""
    import torch

    from smilecode_tpu_torch.config import InferConfig
    from smilecode_tpu_torch.models.registry import build_model

    model = build_model(name, InferConfig(model=name, attn_impl=attn_impl, **knobs),
                        device=device, generator=torch.Generator().manual_seed(0))
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
    |d_src|; each on the path its row calls for. Returns (max_err, ms,
    plain_ms, grid_sample backward ms, (bytes, operations)) per training
    step: eight warps with the scatter, the moved image's without (on the
    smooth flows); and per distinct call {label: dict(ms, library_ms,
    bound_ms, variant)}, ms per call."""
    import torch

    from smilecode_tpu_torch.kernels.warp3d import warp3d_trilinear_bwd, warp3d_trilinear_bwd_plain

    rng = np.random.default_rng(6)
    worst, times, by_shape = 0.0, {}, {}
    for what, c, level in warp_calls():
        want_dsrc = what != "moved image"
        key = (c, level, want_dsrc)
        if key in times:
            continue
        shape = level_shape(level, size)
        vox = int(np.prod(shape))
        bound_ms = bound(*warp_work("K5", vox, vox, c, 4, want_dsrc))[0]
        src = torch.from_numpy(rng.standard_normal((1, *shape, c), dtype=np.float32)).to(device)
        g = torch.from_numpy(rng.standard_normal((1, *shape, c), dtype=np.float32)).to(device)
        flows = {"smooth +-5": smooth_flow(shape, 5.0, device),
                 "wild +-20": torch.from_numpy(
                     rng.uniform(-20, 20, (1, *shape, 3)).astype(np.float32)).to(device)}
        for name, flow in flows.items():
            before = warp3d_trilinear_bwd.launches_vector
            d_src, d_flow = warp3d_trilinear_bwd(src, flow, g, True)
            variant = warp_path(warp3d_trilinear_bwd, before, c, src, f"warp bwd C={c} {shape}")
            p_src, p_flow = warp3d_trilinear_bwd_plain(src, flow, g, True)
            line = f"K5 warp bwd C={c} {shape} {name} ({variant}):"
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
            lib = library_warp_ms(src, flow, g, want_dsrc)
            line += (f"; {'with' if want_dsrc else 'without'} d_src {t:.4f} ms (plain {tp:.4f}, "
                     f"F.grid_sample backward {lib:.4f}, bound {bound_ms:.4f})")
            if want_dsrc:  # the scatter's share of K5's time
                line += (f"; without d_src "
                         f"{event_ms(lambda: warp3d_trilinear_bwd(src, flow, g, False), 10):.4f} ms")
            if name.startswith("smooth"):
                times[key] = (t, tp, lib)
                dev = (device_ms(lambda: warp3d_trilinear_bwd(src, flow, g, want_dsrc)),
                       library_warp_ms(src, flow, g, want_dsrc, timer=device_ms))
                line += f"; device ms kernel {dev[0]:.4f}, F.grid_sample backward {fmt_ms(dev[1])}"
                label = shape_label(c, shape, "" if want_dsrc else " without d_src")
                by_shape[label] = {"ms": t, "library_ms": lib, "bound_ms": bound_ms,
                                   "variant": variant, "device_ms": dev[0],
                                   "library_device_ms": dev[1]}
            print(line, flush=True)
        del src, g, flows, d_src, d_flow, p_src, p_flow
        torch.cuda.empty_cache()
    keys = [(c, level, what != "moved image") for what, c, level in warp_calls()]
    work = np.zeros(2)
    for c, level, scatter in keys:
        vox = int(np.prod(level_shape(level, size)))
        work += warp_work("K5", vox, vox, c, 4, scatter)
    return (worst, *(sum(times[k][i] for k in keys) for i in range(3)), tuple(work), by_shape)


def launch_counts():
    """Each kernel's launches since the last reset, and those of its bf16
    instance ("K1 bf16", ...)."""
    from smilecode_tpu_torch.kernels.modet_attn import (
        modet_attention,
        modet_attention_bwd_dk,
        modet_attention_bwd_dq,
    )
    from smilecode_tpu_torch.kernels.warp3d import warp3d_trilinear, warp3d_trilinear_bwd

    counters = {"K1": (modet_attention, "launches"), "K2": (warp3d_trilinear, "launches"),
                "K3": (modet_attention_bwd_dq, "launches"),
                "K4": (modet_attention_bwd_dk, "launches"),
                "K5": (warp3d_trilinear_bwd, "launches"),
                "K5 d_src": (warp3d_trilinear_bwd, "scatters")}
    out = {k: getattr(fn, what) for k, (fn, what) in counters.items()}
    out.update({f"{k} bf16": getattr(fn, f"{what}_bf16") for k, (fn, what) in counters.items()})
    return out


def reset_launch_counts():
    from smilecode_tpu_torch.kernels.modet_attn import (
        modet_attention,
        modet_attention_bwd_dk,
        modet_attention_bwd_dq,
    )
    from smilecode_tpu_torch.kernels.warp3d import warp3d_trilinear, warp3d_trilinear_bwd

    for fn in (modet_attention, modet_attention_bwd_dq, modet_attention_bwd_dk,
               warp3d_trilinear, warp3d_trilinear_bwd):
        for name in list(vars(fn)):
            if name.startswith(("launches", "scatters")):
                setattr(fn, name, 0)


def vector_counts() -> str:
    """K2's and K5's vector-path launches since the last reset (the rest
    took the scalar path)."""
    from smilecode_tpu_torch.kernels.warp3d import warp3d_trilinear, warp3d_trilinear_bwd

    return (f"vector path: K2 {warp3d_trilinear.launches_vector}, "
            f"K5 {warp3d_trilinear_bwd.launches_vector}")


def run_train(train_dir, val_dir, root, attn_impl="auto", compute_dtype="", model="modet", **kw):
    """train.main of ``model`` for one epoch (``kw``: more TrainConfig
    fields, e.g. ``dataset``); returns (best_dsc, exp_dir, step losses,
    launch counts, seconds)."""
    import torch

    from smilecode_tpu_torch import train
    from smilecode_tpu_torch.config import TrainConfig

    cfg = TrainConfig(model=model, train_dir=train_dir, val_dir=val_dir, max_epoch=1,
                      attn_impl=attn_impl, save_root=os.path.join(root, "experiments"),
                      log_root=os.path.join(root, "logs"), compute_dtype=compute_dtype, **kw)
    reset_launch_counts()
    t0 = time.perf_counter()
    best = train.main(cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    print(f"train.main {model} ({attn_impl}, {compute_dtype or 'float32'}): {vector_counts()}",
          flush=True)
    with open(os.path.join(cfg.log_root, cfg.save_dir, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f if '"iter"' in line]
    return best, os.path.join(cfg.save_root, cfg.save_dir), losses, counts, seconds


def compare_step_grads(model, plain, x, y, plan=None, zero=()):
    """One loss-and-gradients pass of each model on (x, y) with ``plan``
    (ModeT's by default); returns (loss, plain loss, worst gradient error
    over its tolerance). Every gradient within STEP_GRAD_TOL of the plain
    gradient's largest magnitude plus STEP_GRAD_FLOOR of the model's largest
    (phase 9's gates), but for the parameters named in ``zero``, whose exact
    gradient is zero (`zero_gradient_params`: a conv bias ahead of an
    instance norm): what float32 gives there is rounding, summed over every
    voxel of a level, and can exceed that floor in the plain step alone; the
    kernels' is held to ZERO_GRAD_NOISE times the plain step's largest
    magnitude, plus the floor. Every number prints before any gate is
    applied."""
    from smilecode_tpu_torch.models.registry import loss_plan
    from smilecode_tpu_torch.train import make_loss_and_grads

    plan = plan or loss_plan("modet")
    loss, _ = make_loss_and_grads(model, plan, (1.0, 1.0))(x, y)
    p_loss, _ = make_loss_and_grads(plain, plan, (1.0, 1.0))(x, y)
    grads = dict(model.named_parameters())
    p_grads = dict(plain.named_parameters())
    gmax = max(float(p.grad.abs().max()) for p in p_grads.values())
    floor = STEP_GRAD_FLOOR * gmax
    worst = {"real": (0.0, ""), "zero": (0.0, "")}
    worst_rel, rel_name, noise = 0.0, "", ""
    for name, p in p_grads.items():
        g = grads[name].grad
        require(g is not None and bool(g.isfinite().all()), f"step gradient {name} missing or not finite")
        err, scale = float((g - p.grad).abs().max()), float(p.grad.abs().max())
        if name in zero:
            kind, err = "zero", float(g.abs().max())
            ratio = err / (ZERO_GRAD_NOISE * scale + floor)
            if ratio > worst["zero"][0]:
                noise = f"kernels {err:.3e}, plain {scale:.3e}"
        else:
            kind, ratio = "real", err / (STEP_GRAD_TOL * scale + floor)
            if scale > 1e-3 * gmax and err / scale > worst_rel:
                worst_rel, rel_name = err / scale, name  # parameters with a real gradient
        if ratio > worst[kind][0]:
            worst[kind] = (ratio, name)
    line = (f"kernel step vs plain step: loss {float(loss):.7f} vs {float(p_loss):.7f}; "
            f"worst gradient err/tol {worst['real'][0]:.4f} ({worst['real'][1]}); tolerance "
            f"{STEP_GRAD_TOL} x each parameter's max |grad| + {STEP_GRAD_FLOOR} x the model's; "
            f"worst err / max |grad| over parameters whose max |grad| is above 1e-3 of the "
            f"model's: {worst_rel:.3e} ({rel_name})")
    if zero:
        line += (f"; {len(zero)} parameters with a zero exact gradient (model's max |grad| "
                 f"{gmax:.3e}): worst max |grad| / tol {worst['zero'][0]:.4f} "
                 f"({worst['zero'][1]}: {noise}; tolerance {ZERO_GRAD_NOISE} x the plain "
                 f"step's + the floor)")
    print(line, flush=True)
    for ratio, name in worst.values():
        require(ratio <= 1.0, f"step gradient {name}: kernels vs plain max abs err over "
                              f"tolerance {ratio:.3f} > 1")
    return float(loss), float(p_loss), max(worst["real"][0], worst["zero"][0])


def zero_gradient_params(name, device, plan, x, y, knobs=None):
    """The biases of baseline ``name`` whose exact gradient is zero: at most
    ZERO_GRAD_REL of the model's largest in a float64 plain step on the
    leading 64^3 crop of (x, y) (every model takes 64^3). A conv bias ahead
    of an instance norm is one: the norm removes any constant its bias adds,
    at every volume size. Weights are not candidates: at 64^3 a level can
    shrink to one voxel, where a weight's gradient can vanish that does not
    vanish at full size."""
    from smilecode_tpu_torch.train import make_loss_and_grads

    model = seeded_baseline(name, device, "plain", **(knobs or {})).train().double()
    crop = (slice(None), slice(0, 64), slice(0, 64), slice(0, 64))
    make_loss_and_grads(model, plan, (1.0, 1.0))(x[crop].double(), y[crop].double())
    gmax = max(float(p.grad.abs().max()) for p in model.parameters())
    return {n for n, p in model.named_parameters()
            if n.endswith(".bias") and float(p.grad.abs().max()) <= ZERO_GRAD_REL * gmax}


def compare_bf16_step(models, x, y):
    """Phase 19: one loss-and-gradients pass of each of ``models`` ("kernels"
    and "plain", bf16; "f32", the float32 kernel model; same weights) on (x,
    y). Gates: the kernels' loss within BF16_STEP_LOSS_TOL of the plain
    one's; each gradient within BF16_STEP_GRAD_TOL of the plain gradient's
    largest magnitude plus STEP_GRAD_FLOOR of the model's. The conv biases
    ahead of an instance norm have a zero float32 gradient (below
    STEP_GRAD_FLOOR of the model's largest): in bf16 their gradient is
    rounding noise far above that floor, so they are held within
    BF16_STEP_GRAD_TOL of the model's largest gradient. And the kernels add nothing beyond bf16's own noise: over the
    parameters with a real float32 gradient, the relative L2 distance of the
    kernels' bf16 gradient to the plain bf16 one is at most that of the
    plain bf16 gradient to the float32 one. Every number is printed before
    any gate is applied."""
    import torch

    from smilecode_tpu_torch.models.registry import loss_plan
    from smilecode_tpu_torch.train import make_loss_and_grads

    plan = loss_plan("modet")
    losses, grads = {}, {}
    for name, m in models.items():
        loss, _ = make_loss_and_grads(m, plan, (1.0, 1.0))(x, y)
        losses[name] = float(loss)
        grads[name] = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
        require(all(bool(g.isfinite().all()) for g in grads[name].values()),
                f"{name} step: a gradient is not finite")
    gk, gp, g32 = grads["kernels"], grads["plain"], grads["f32"]
    gmax = max(float(g.abs().max()) for g in gp.values())
    floor32 = STEP_GRAD_FLOOR * max(float(g.abs().max()) for g in g32.values())
    real = [n for n, g in g32.items() if float(g.abs().max()) > floor32]
    worst = {"real": (0.0, ""), "zero": (0.0, "")}
    for n, g in gp.items():
        kind = "real" if n in real else "zero"
        tol = (BF16_STEP_GRAD_TOL * float(g.abs().max()) + STEP_GRAD_FLOOR * gmax
               if kind == "real" else BF16_STEP_GRAD_TOL * gmax)
        ratio = float((gk[n] - g).abs().max()) / tol
        if ratio > worst[kind][0]:
            worst[kind] = (ratio, n)

    def rel(a, b):
        a, b = (torch.cat([G[n].flatten() for n in real]) for G in (a, b))
        return float((a - b).norm() / b.norm())

    k_p, p_32, k_32 = rel(gk, gp), rel(gp, g32), rel(gk, g32)
    print(f"bf16 kernel step vs bf16 plain step: loss {losses['kernels']:.7f} vs "
          f"{losses['plain']:.7f} (f32 {losses['f32']:.7f}); worst gradient err/tol over the "
          f"{len(real)} parameters with a real gradient {worst['real'][0]:.4f} "
          f"({worst['real'][1]}; tolerance {BF16_STEP_GRAD_TOL} x each parameter's max |grad| + "
          f"{STEP_GRAD_FLOOR} x the model's), over the {len(gp) - len(real)} with a zero f32 "
          f"gradient {worst['zero'][0]:.4f} ({worst['zero'][1]}; tolerance {BF16_STEP_GRAD_TOL} x "
          f"the model's max |grad|); relative L2 over the parameters with a real gradient: "
          f"kernels vs plain {k_p:.4f}, plain bf16 vs f32 {p_32:.4f}, kernels bf16 vs f32 "
          f"{k_32:.4f}", flush=True)
    require(abs(losses["kernels"] - losses["plain"]) <= BF16_STEP_LOSS_TOL * abs(losses["plain"]),
            f"bf16 step loss, kernels vs plain: {losses['kernels']} vs {losses['plain']}")
    for kind, (ratio, name) in worst.items():
        require(ratio <= 1.0, f"bf16 step gradient {name}: kernels vs plain err/tol {ratio:.3f} > 1")
    require(k_p <= p_32, f"bf16 step: kernels vs plain {k_p} > plain bf16 vs f32 {p_32}")
    return losses, worst, (k_p, p_32, k_32)


def time_steps(models, x, y, plan=None, n=N_TIMED_STEPS):
    """ms per training step over ``n`` steps and peak GiB of each of
    ``models`` (with ``plan``, ModeT's by default), in turns (the order
    rotates every round); returns (times, peak, steps)."""
    import torch

    from smilecode_tpu_torch.models.registry import loss_plan
    from smilecode_tpu_torch.optim import AMSGrad
    from smilecode_tpu_torch.train import make_train_step

    plan = plan or loss_plan("modet")
    steps = {name: make_train_step(m, plan, AMSGrad(m.parameters(), lr=1e-4), (1.0, 1.0))
             for name, m in models.items()}
    names = list(steps)
    times = {name: [] for name in names}
    peak = {name: 0.0 for name in names}
    for name in names:  # warm-up
        steps[name](x, y)
    for i in range(n):
        for name in names[i % len(names):] + names[:i % len(names)]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, _ = steps[name](x, y)
            require(bool(torch.isfinite(loss)), f"{name} step loss not finite")
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            peak[name] = max(peak[name], torch.cuda.max_memory_allocated() / 2**30)
    return times, peak, steps


def time_forwards(models, x, y, n=N_TIMED):
    """Median ms per forward and peak GiB of each of ``models``, in turns
    (the order rotates every round), after one warm-up each."""
    import torch

    names = list(models)
    times = {name: [] for name in names}
    peak = {name: 0.0 for name in names}
    with torch.no_grad():
        for name in names:
            models[name](x, y)
        for i in range(n):
            for name in names[i % len(names):] + names[:i % len(names)]:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                models[name](x, y)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
                peak[name] = max(peak[name], torch.cuda.max_memory_allocated() / 2**30)
    return times, peak


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


def seeded_model(device, attn_impl="auto", compute_dtype=""):
    """Full-width ModeT from seed 0, with a seeded random RPB so the bias
    path is live (the trained reference's RPB is not zero)."""
    import torch

    from smilecode_tpu_torch.models import ModeT

    model = ModeT(channels=4, head_dim=HEAD_DIM, num_heads=NUM_HEADS, qk_scale=1.0,
                  attn_impl=attn_impl, compute_dtype=compute_dtype, device=device,
                  generator=torch.Generator().manual_seed(0))
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


def run_infer(test_dir, model_dir, attn_impl="auto", model="modet", compute_dtype="",
              mc_record=None, **kw):
    """infer.main through its config (``kw``: more InferConfig fields);
    returns its two results (dsc and fold, or with ``mc_iter`` the mean UCE
    and epi), the launch counts and the seconds. ``mc_record``: infer.main's
    list of each pair's MC stack and statistics."""
    import torch

    from smilecode_tpu_torch import infer
    from smilecode_tpu_torch.config import InferConfig

    cfg = InferConfig(model=model, test_dir=test_dir, model_dir=model_dir, attn_impl=attn_impl,
                      compute_dtype=compute_dtype, **kw)
    reset_launch_counts()
    t0 = time.perf_counter()
    dsc, fold = infer.main(cfg, mc_record=mc_record)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"infer.main {model} ({attn_impl}, {compute_dtype or 'float32'}): {vector_counts()}",
          flush=True)
    return dsc, fold, launch_counts(), seconds


def forward_pair(test_dir, device, dataset="s2s"):
    """The first (x, y) pair of ``test_dir`` that infer.main's ``dataset``
    gives."""
    from smilecode_tpu_torch.data import Compose, Loader, NumpyType, Seg_norm, pair_dataset

    paths = sorted(os.path.join(test_dir, p) for p in os.listdir(test_dir))
    ds = pair_dataset(dataset, paths, Compose([Seg_norm(), NumpyType((np.float32, np.int16))]),
                      True)
    x, y, _, _ = next(iter(Loader(ds, device=device)))
    return x, y


def zoo_warp_cases():
    """The baseline zoo's warps for phase 20: (what, source shape, flow
    shape, C). PCNet's feature and flow warps at 1/4, 1/2 and full size;
    PRNet's and PR++'s feature warps; PR++'s three compositions of a flow by
    a finer field, whose source is coarser than the flow; RDN's feature
    warps at C=16..128, whose K5 scatters d_src."""
    l2, l3, l4 = (level_shape(n) for n in (2, 3, 4))
    return [("PCNet 1/4 features", l3, l3, 64), ("PCNet 1/2 features", l2, l2, 32),
            ("PCNet full features", SIZE, SIZE, 16), ("PCNet 1/4 flow", l3, l3, 3),
            ("PCNet 1/2 flow", l2, l2, 3), ("PCNet full flow", SIZE, SIZE, 3),
            ("PRNet/PR++ 1/4 features", l3, l3, 32),
            ("PRNet/PR++ 1/2 features, RDN level-0 features", l2, l2, 16),
            ("PRNet/PR++ full features", SIZE, SIZE, 16),
            ("PRNet/PR++ full features, block 5", SIZE, SIZE, 8),
            ("PR++ 1/8 flow by a 1/4 field", l4, l3, 3), ("PR++ 1/4 flow by a 1/2 field", l3, l2, 3),
            ("PR++ 1/2 flow by a full field", l2, SIZE, 3),
            ("RDN level-1 features", l3, l3, 32), ("RDN level-2 features", l4, l4, 64),
            ("RDN level-3 features", level_shape(5), level_shape(5), 128)]


def check_zoo_warps(device):
    """Phase 20: K2 and K5 (with the d_src scatter) vs their plain versions
    at `zoo_warp_cases`, smooth +-5 and wild +-20 voxel flows, each on the
    path its row calls for. Gates as phases 2 and 7: K2 within WARP_TOL *
    max|src|, K5's d_flow and d_src within BWD_TOL of the plain version's
    largest magnitude. Returns {kernel: dict(err, ms, plain_ms, library_ms,
    work, by_shape)}: ms summed over one call of each case on its smooth
    flow, per case {label: dict(ms, library_ms, bound_ms, variant,
    device_ms, library_device_ms)}, ms per call."""
    import torch

    from smilecode_tpu_torch.kernels.warp3d import (
        warp3d_trilinear,
        warp3d_trilinear_bwd,
        warp3d_trilinear_bwd_plain,
        warp3d_trilinear_plain,
    )

    rng = np.random.default_rng(11)
    res = {key: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "work": np.zeros(2),
                 "by_shape": {}} for key in ("K2", "K5")}
    for what, src_shape, flow_shape, c in zoo_warp_cases():
        src_vox, vox = int(np.prod(src_shape)), int(np.prod(flow_shape))
        work = {"K2": warp_work("K2", src_vox, vox, c, 4),
                "K5": warp_work("K5", src_vox, vox, c, 4, True)}
        bound_ms = {key: bound(*w)[0] for key, w in work.items()}
        src = torch.from_numpy(rng.standard_normal((1, *src_shape, c), dtype=np.float32)).to(device)
        g = torch.from_numpy(rng.standard_normal((1, *flow_shape, c), dtype=np.float32)).to(device)
        flows = {"smooth +-5": smooth_flow(flow_shape, 5.0, device),
                 "wild +-20": torch.from_numpy(
                     rng.uniform(-20, 20, (1, *flow_shape, 3)).astype(np.float32)).to(device)}
        tol = WARP_TOL * float(src.abs().max())
        for name, flow in flows.items():
            line = f"K2/K5 {what} C={c} src {src_shape} flow {flow_shape} {name}:"
            before = warp3d_trilinear.launches_vector, warp3d_trilinear_bwd.launches_vector
            out = warp3d_trilinear(src, flow)
            variant = warp_path(warp3d_trilinear, before[0], c, src, f"{line} K2")
            e2 = float((out - warp3d_trilinear_plain(src, flow)).abs().max())
            require(bool(torch.isfinite(out).all()), f"{line} K2 output not finite")
            require(e2 <= tol, f"{line} K2 max abs err {e2} > {tol}")
            d_src, d_flow = warp3d_trilinear_bwd(src, flow, g, True)
            warp_path(warp3d_trilinear_bwd, before[1], c, src, f"{line} K5")
            p_src, p_flow = warp3d_trilinear_bwd_plain(src, flow, g, True)
            e5 = {}
            for what_, a, b in (("d_flow", d_flow, p_flow), ("d_src", d_src, p_src)):
                require(bool(torch.isfinite(a).all()), f"{line} K5 {what_} not finite")
                e5[what_] = (float((a - b).abs().max()), BWD_TOL * float(b.abs().max()))
                require(e5[what_][0] <= e5[what_][1], f"{line} K5 {what_} max abs err "
                                                      f"{e5[what_][0]} > {e5[what_][1]}")
            errs = {"K2": e2, "K5": max(e for e, _ in e5.values())}
            line += (f" ({variant}) K2 max_abs_err {e2:.3e} (tol {tol:.3e}); K5 "
                     + ", ".join(f"{n} {e:.3e} (tol {t:.3e})" for n, (e, t) in e5.items()))
            for key in res:
                res[key]["err"] = max(res[key]["err"], errs[key])
            if name.startswith("smooth"):
                t = {"K2": (event_ms(lambda: warp3d_trilinear(src, flow), 10),
                            event_ms(lambda: warp3d_trilinear_plain(src, flow), 2),
                            library_warp_ms(src, flow),
                            device_ms(lambda: warp3d_trilinear(src, flow)),
                            library_warp_ms(src, flow, timer=device_ms)),
                     "K5": (event_ms(lambda: warp3d_trilinear_bwd(src, flow, g, True), 10),
                            event_ms(lambda: warp3d_trilinear_bwd_plain(src, flow, g, True), 2),
                            library_warp_ms(src, flow, g, True),
                            device_ms(lambda: warp3d_trilinear_bwd(src, flow, g, True)),
                            library_warp_ms(src, flow, g, True, timer=device_ms))}
                for key, (ms, plain_ms, lib, dev, lib_dev) in t.items():
                    r = res[key]
                    r["ms"], r["plain_ms"] = r["ms"] + ms, r["plain_ms"] + plain_ms
                    r["library_ms"] += lib or 0.0
                    r["work"] += work[key]
                    r["by_shape"][f"{what} {shape_label(c, flow_shape)} src "
                                  f"{'x'.join(map(str, src_shape))}"] = {
                        "ms": ms, "library_ms": lib, "bound_ms": bound_ms[key], "variant": variant,
                        "device_ms": dev, "library_device_ms": lib_dev}
                line += "; ms call / device / plain / F.grid_sample call / device: " + ", ".join(
                    f"{key} {v[0]:.4f} / {v[3]:.4f} / {v[1]:.4f} / {fmt_ms(v[2])} / {fmt_ms(v[4])} "
                    f"(bound {bound_ms[key]:.4f})" for key, v in t.items())
            print(line, flush=True)
        del src, g, flows, out, d_src, d_flow, p_src, p_flow
        torch.cuda.empty_cache()
    return res


def train_baseline(name, data_dir, root, pair, step, plain=True):
    """Phase 23 for baseline ``name``: `train.main` on the 2 subjects of
    ``data_dir`` (2 steps, then 2 validation pairs) with the kernels: exact
    launches (``step`` per step, ``pair`` K1 and K2 per validation pair),
    finite losses; with ``plain``, the ``attn_impl="plain"`` run launches
    nothing and its first loss is within STEP_LOSS_TOL. Returns the kernel
    run's launch counts."""
    import torch

    best, _, losses, counts, secs = run_train(data_dir, data_dir, os.path.join(root, "kernels"),
                                              model=name)
    want = dict.fromkeys(counts, 0)
    for key, per_step in zip(STEP_KEYS, step):
        want[key] = per_step * ZOO_STEPS
    want["K1"] += pair[0] * ZOO_VAL_PAIRS
    want["K2"] += pair[1] * ZOO_VAL_PAIRS
    print(f"train {name} (kernels): {ZOO_STEPS} steps + {ZOO_VAL_PAIRS} validation pairs in "
          f"{secs:.2f} s, losses {losses}, best dsc {best:.6f}, launches {counts}", flush=True)
    require(len(losses) == ZOO_STEPS and bool(np.isfinite(losses).all()), f"{name}: losses {losses}")
    require(counts == want, f"{name}: train launches {counts}, expected {want}")
    torch.cuda.empty_cache()
    if not plain:
        return counts

    _, _, p_losses, p_counts, p_secs = run_train(data_dir, data_dir, os.path.join(root, "plain"),
                                                 attn_impl="plain", model=name)
    print(f"train {name} (plain): {p_secs:.2f} s, losses {p_losses}, launches {p_counts}",
          flush=True)
    require(not any(p_counts.values()), f"{name}: the plain training run launched a kernel")
    require(abs(losses[0] - p_losses[0]) <= STEP_LOSS_TOL * abs(p_losses[0]),
            f"{name}: first step loss, kernels vs plain: {losses[0]} vs {p_losses[0]}")
    torch.cuda.empty_cache()
    return counts


def step_baseline(card, name, data_dir, device, profile=False):
    """Phase 24 for baseline ``name``: one training step, kernels vs plain,
    same weights and batch (phase 9's gates, and the zero-gradient rule of
    `compare_step_grads`); ms per step (median of N_TIMED_ZOO_STEPS, in
    turns) and peak memory of each; with ``profile``, the top device
    operations of one kernel step. The kernel and plain models keep the
    reference's depth but for `ZOO_STEP_KNOBS` (rdn_diff_share at stages 2;
    at stages 4 its plain step peaks at ~48 GiB of the card's 80)."""
    import torch

    from smilecode_tpu_torch.config import TrainConfig
    from smilecode_tpu_torch.models.registry import loss_plan

    knobs = ZOO_STEP_KNOBS.get(name, {})
    x, y = forward_pair(data_dir, device)
    plan = loss_plan(name, TrainConfig(model=name, **knobs))
    zero = zero_gradient_params(name, device, plan, x, y, knobs)
    model = seeded_baseline(name, device, **knobs).train()
    plain = seeded_baseline(name, device, "plain", **knobs).train()
    loss, p_loss, _ = compare_step_grads(model, plain, x, y, plan, zero)
    require(abs(loss - p_loss) <= STEP_LOSS_TOL * abs(p_loss),
            f"{name} step loss, kernels vs plain: {loss} vs {p_loss}")
    times, peak, steps = time_steps({"kernels": model, "plain": plain}, x, y, plan,
                                    N_TIMED_ZOO_STEPS)
    print(f"[{card}] {name}{''.join(f' {k}={v}' for k, v in knobs.items())} "
          f"{'x'.join(map(str, x.shape[1:4]))} training step, median of "
          f"{N_TIMED_ZOO_STEPS}: " + "; ".join(
              f"{k} {statistics.median(t):.3f} ms (min {min(t):.3f}), peak {peak[k]:.2f} GiB"
              for k, t in times.items()), flush=True)
    if profile:
        profile_step(steps["kernels"], x, y, what=f"{name} kernel step")
    del model, plain, steps, x, y
    torch.cuda.empty_cache()


def run_zoo_phases(card, device, tmp, val_dir):
    """Phases 20-24, the baseline zoo (`ZOO`): the warp shapes of its
    models and Im2grid's attention backward, PCNet, PRNet and PR++ served at
    160x192x160, and every family trained. ``val_dir`` holds 2 subjects at
    160x192x160 (RCN's 2 at 128x192x128 are written here). Returns (phase
    20's K2/K5 results, its K3/K4 results, the launch counts of phase 23's
    kernel runs summed, and those of its Im2grid run)."""
    import torch

    phase(20, "K2/K5 at the baseline zoo's warp shapes; K3/K4 at Im2grid's five levels")
    warps = check_zoo_warps(device)
    attn_bwd = check_attention_bwd(device, specs=tuple(zip((5, 4, 3, 2, 1), (1,) * 5)),
                                   with_rpb=False)
    for key, r in warps.items():
        print(f"[{card}] {key} over phase 20's {len(r['by_shape'])} cases, one call each: "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, F.grid_sample{' backward' * (key == 'K5')} "
              f"{r['library_ms']:.4f}); bound {bound(*r['work'])[0]:.4f} ms; max_abs_err "
              f"{r['err']:.3e}", flush=True)
    for key, (err, ms, plain_ms, work, dev, _) in attn_bwd.items():
        print(f"[{card}] {key} without rpb per Im2grid step: {ms:.4f} ms, device {dev:.4f} (plain "
              f"{plain_ms:.4f}); bound {bound(*work)[0]:.4f} ms; max_abs_err {err:.3e}", flush=True)

    rcn_pair = os.path.join(tmp, "PairRCN")
    os.makedirs(rcn_pair)
    write_subjects(rcn_pair, size=RCN_SIZE, device=device, n=2, seed=17)
    data = {SIZE: val_dir, RCN_SIZE: rcn_pair}

    phase(21, "infer.main for PCNet, PRNet and PR++ at 160x192x160")
    for name in ZOO_SERVED:
        size, (k1, k2), _ = ZOO[name]
        serve_baseline(name, size, data[size], os.path.join(tmp, f"exp_{name}"), device, k1, k2,
                       ZOO_VAL_PAIRS)

    phase(22, "PCNet, PRNet and PR++ forwards, kernels vs plain; ms per pair")
    for name in ZOO_SERVED:
        compare_baseline_forward(card, name, ZOO[name][0], data[ZOO[name][0]], device)

    phase(23, "train.main for every baseline family")
    train_counts, im2grid_counts = None, None
    for name, (size, pair, step) in ZOO.items():
        counts = train_baseline(name, data[size], os.path.join(tmp, f"train_{name}"), pair, step,
                                plain=name in ZOO_PLAIN_TRAIN)
        train_counts = counts if train_counts is None else {
            k: v + counts[k] for k, v in train_counts.items()}
        if name == "im2grid":
            im2grid_counts = counts

    phase(24, "one training step per family, kernels vs plain; ms per step")
    for name, (size, _, _) in ZOO.items():
        step_baseline(card, name, data[size], device, profile=name in ("pcnet", "prnetplusplus"))
    torch.cuda.empty_cache()
    return warps, attn_bwd, train_counts, im2grid_counts


def serve_baseline(name, size, data_dir, model_dir, device, k1_pair, k2_pair, n_pairs):
    """`infer.main` of baseline ``name`` on the ``size`` subjects of
    ``data_dir`` with a seeded, head-perturbed JAX-format checkpoint written
    to ``model_dir``: exactly ``k1_pair`` K1 and ``k2_pair`` K2 launches per
    pair; the ``attn_impl="plain"`` run launches nothing and gives the same
    Dice and fold. Returns the kernel run's launch counts."""
    import torch

    write_jax_checkpoint(model_dir, seeded_baseline(name, device))
    dsc, fold, counts, secs = run_infer(data_dir, model_dir, model=name)
    n_k1, n_k2 = counts["K1"], counts["K2"]
    print(f"{name} {size} infer (kernels): {n_pairs} pairs in {secs:.2f} s, K1 launches "
          f"{n_k1}, K2 launches {n_k2}, dsc {dsc:.6f}, fold {fold:.6f}", flush=True)
    require(np.isfinite(dsc) and 0.0 <= dsc <= 1.0, f"{name}: Dice {dsc} outside [0, 1]")
    require(np.isfinite(fold) and 0.0 <= fold <= 1.0, f"{name}: fold {fold} outside [0, 1]")
    require((n_k1, n_k2) == (k1_pair * n_pairs, k2_pair * n_pairs),
            f"{name}: K1, K2 launched {n_k1}, {n_k2} times, expected "
            f"{k1_pair * n_pairs}, {k2_pair * n_pairs}")
    p_dsc, p_fold, p_counts, p_secs = run_infer(data_dir, model_dir, attn_impl="plain", model=name)
    p_k1, p_k2 = p_counts["K1"], p_counts["K2"]
    print(f"{name} {size} infer (plain): {p_secs:.2f} s, K1 launches {p_k1}, K2 launches "
          f"{p_k2}, dsc {p_dsc:.6f}, fold {p_fold:.6f}", flush=True)
    require(p_k1 == 0 and p_k2 == 0, f"{name}: the plain run launched a kernel")
    require(abs(dsc - p_dsc) <= 1e-3 and abs(fold - p_fold) <= 1e-3,
            f"{name} kernels vs plain infer: dsc {dsc} vs {p_dsc}, fold {fold} vs {p_fold}")
    torch.cuda.empty_cache()
    return counts


def compare_baseline_forward(card, name, size, data_dir, device, profile=True):
    """Baseline ``name``'s forward on a pair of ``data_dir``, kernels vs
    plain: flow and every aux field within FLOW_TOL, moved image within
    MOVED_TOL; ms per pair (median of N_TIMED_BASELINE, in turns), peak
    memory, and the top device operations of one kernel forward."""
    import torch

    x, y = forward_pair(data_dir, device)
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
    times, peak = time_forwards({"kernels": model, "plain": plain}, x, y, N_TIMED_BASELINE)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"[{card}] {name} {'x'.join(map(str, size))} forward, median of "
          f"{N_TIMED_BASELINE}: kernels {med['kernels']:.3f} ms/pair, plain "
          f"{med['plain']:.3f} ms/pair (min {min(times['kernels']):.3f} / "
          f"{min(times['plain']):.3f}); peak memory kernels {peak['kernels']:.2f} GiB, "
          f"plain {peak['plain']:.2f} GiB", flush=True)
    if profile:
        with torch.no_grad():
            profile_step(model, x, y, top=8, what=f"{name} kernel forward")
    del model, plain, x, y
    torch.cuda.empty_cache()


def run_bf16_phases(card, device, tmp, test_dir, val_dir, f32_infer):
    """Phases 15-19, the bf16 feature path (`compute_dtype="bfloat16"`) on
    the subjects of phases 3 and 8 and the checkpoint of phase 3. Returns
    (phase 15's results, the launch counts of phase 18's kernel run)."""
    import torch

    phase(15, "bf16 K1-K5 vs their bf16 plain versions")
    res = check_bf16_kernels(device)
    for key, r in res.items():
        lib = "" if r["library_ms"] is None else f", F.grid_sample bf16 {r['library_ms']:.4f}"
        dev = "" if r["device_ms"] is None else f", device {r['device_ms']:.4f}"
        print(f"[{card}] bf16 {key} per {'pair' if key in ('K1', 'K2') else 'step'} over its bf16 "
              f"calls: {r['ms']:.4f} ms{dev} (plain bf16 {r['plain_ms']:.4f}, f32 kernel "
              f"{r['f32_ms']:.4f}{lib}); bound {bound(*r['work'])[0]:.4f} ms "
              f"({bound(*r['work'])[1]}); max_abs_err {r['err']:.3e}", flush=True)

    phase(16, "infer.main with compute_dtype=bfloat16")
    n_pairs = N_SUBJECTS * (N_SUBJECTS - 1)
    model_dir = os.path.join(tmp, "exp")
    for impl in ("auto", "plain"):
        dsc, fold, counts, secs = run_infer(test_dir, model_dir, attn_impl=impl,
                                            compute_dtype="bfloat16")
        print(f"infer bf16 ({'kernels' if impl == 'auto' else 'plain'}): {n_pairs} pairs in "
              f"{secs:.2f} s, dsc {dsc:.6f}, fold {fold:.6f} (f32 kernels: dsc "
              f"{f32_infer[0]:.6f}, fold {f32_infer[1]:.6f}); launches {counts}", flush=True)
        require(np.isfinite(dsc) and 0.0 <= dsc <= 1.0 and np.isfinite(fold) and 0 <= fold <= 1,
                f"bf16 infer: dsc {dsc}, fold {fold}")
        if impl == "plain":
            require(not any(counts.values()), "the plain bf16 run launched a kernel")
        else:
            want = dict.fromkeys(counts, 0)
            want.update({"K1": 5 * n_pairs, "K1 bf16": 5 * n_pairs, "K2": 9 * n_pairs,
                         "K2 bf16": 4 * n_pairs})
            require(counts == want, f"bf16 infer launches {counts}, expected {want}")

    phase(17, "forwards with excited weights: bf16 kernels, bf16 plain, f32 kernels")
    x, y = forward_pair(test_dir, device)
    names = {"bf16 kernels": ("auto", "bfloat16"), "bf16 plain": ("plain", "bfloat16"),
             "f32 kernels": ("auto", "")}
    models = {name: excited_model(device, *how) for name, how in names.items()}
    pairs = {"160x192x160 subjects": (x, y),
             "32^3 blobs": (blob_vol(GATE_SHAPE, 1, device), blob_vol(GATE_SHAPE, 2, device))}
    gaps = {}
    for where, (xx, yy) in pairs.items():
        with torch.no_grad():
            outs = {name: m(xx, yy) for name, m in models.items()}
        for name, (moved, flow) in outs.items():
            require(moved.dtype == flow.dtype == torch.float32 and flow.shape[1:4] == xx.shape[1:4]
                    and bool(torch.isfinite(flow).all() and torch.isfinite(moved).all()),
                    f"{where} {name} forward: outputs not finite float32 of the right shape")
        ref_moved, ref_flow = outs["f32 kernels"]
        require(float(ref_flow.abs().max()) > 0.05, f"{where}: the excited f32 flow is degenerate")
        for name in ("bf16 kernels", "bf16 plain"):
            moved, flow = outs[name]
            gaps[where, name] = (*flow_gap(flow, ref_flow), flow_gap(moved, ref_moved)[1])
            print(f"{where}, {name} vs f32 kernels: flow endpoint error mean "
                  f"{gaps[where, name][0]:.5f}, p99 {gaps[where, name][1]:.5f} voxel; moved p99 "
                  f"{gaps[where, name][2]:.5f} (f32 flow max |.| {float(ref_flow.abs().max()):.4f})",
                  flush=True)
        k_vs_p = flow_gap(outs["bf16 kernels"][1], outs["bf16 plain"][1])
        print(f"{where}, bf16 kernels vs bf16 plain: flow endpoint error mean {k_vs_p[0]:.5f}, p99 "
              f"{k_vs_p[1]:.5f} voxel", flush=True)
        plain_gap = gaps[where, "bf16 plain"]
        require(k_vs_p[0] <= plain_gap[0] and k_vs_p[1] <= plain_gap[1],
                f"{where}: bf16 kernels vs plain {k_vs_p} exceeds bf16 plain vs f32 {plain_gap}")
        for name in ("bf16 kernels", "bf16 plain"):
            mean, p99, moved_p99 = gaps[where, name]
            require(moved_p99 < BF16_MOVED_P99, f"{where} {name}: moved p99 {moved_p99}")
            if where.startswith("32"):
                require(mean < BF16_FLOW_MEAN and p99 < BF16_FLOW_P99,
                        f"{where} {name} vs f32: flow mean {mean}, p99 {p99}")
        del outs, ref_moved, ref_flow
    torch.cuda.empty_cache()
    times, peak = time_forwards(models, x, y)
    print(f"[{card}] ModeT 160x192x160 forward, excited weights, median of {N_TIMED}: " + "; ".join(
        f"{name} {statistics.median(t):.3f} ms/pair (min {min(t):.3f}), peak {peak[name]:.2f} GiB"
        for name, t in times.items()), flush=True)
    with torch.no_grad():
        profile_step(models["bf16 kernels"], x, y, top=12, what="bf16 kernel forward")
    del models
    torch.cuda.empty_cache()

    phase(18, "train.main with compute_dtype=bfloat16")
    n_steps, n_val = n_pairs, N_VAL_SUBJECTS * (N_VAL_SUBJECTS - 1)
    best, _, losses, counts, secs = run_train(test_dir, val_dir, os.path.join(tmp, "bf16k"),
                                                    compute_dtype="bfloat16")
    print(f"train bf16 (kernels): {n_steps} steps + {n_val} validation pairs in {secs:.2f} s, "
          f"losses {losses}, best dsc {best:.6f}, launches {counts}", flush=True)
    require(len(losses) == n_steps and bool(np.isfinite(losses).all()), f"bf16 losses {losses}")
    fwd = n_steps + n_val
    want = {"K1": 5 * fwd, "K1 bf16": 5 * fwd, "K2": 9 * fwd, "K2 bf16": 4 * fwd,
            "K3": 5 * n_steps, "K3 bf16": 5 * n_steps, "K4": 5 * n_steps, "K4 bf16": 5 * n_steps,
            "K5": 9 * n_steps, "K5 bf16": 4 * n_steps, "K5 d_src": 8 * n_steps,
            "K5 d_src bf16": 4 * n_steps}
    require(counts == want, f"bf16 train launches {counts}, expected {want}")
    _, _, p_losses, p_counts, p_secs = run_train(test_dir, val_dir, os.path.join(tmp, "bf16p"),
                                                 attn_impl="plain", compute_dtype="bfloat16")
    print(f"train bf16 (plain): {p_secs:.2f} s, losses {p_losses}, launches {p_counts}", flush=True)
    require(not any(p_counts.values()), "the plain bf16 training run launched a kernel")
    require(abs(losses[0] - p_losses[0]) <= BF16_STEP_LOSS_TOL * abs(p_losses[0]),
            f"bf16 first step loss, kernels vs plain: {losses[0]} vs {p_losses[0]}")
    torch.cuda.empty_cache()

    phase(19, "one bf16 training step, kernels vs plain; ms per step")
    models = {"kernels": seeded_model(device, compute_dtype="bfloat16"),
              "plain": seeded_model(device, "plain", "bfloat16"), "f32": seeded_model(device)}
    compare_bf16_step(models, x, y)
    models = {"bf16 kernels": models["kernels"], "bf16 plain": models["plain"],
              "f32 kernels": models["f32"]}
    times, peak, steps = time_steps(models, x, y)
    print(f"[{card}] ModeT 160x192x160 training step (fwd + bwd + AMSGrad), median of "
          f"{N_TIMED_STEPS}: " + "; ".join(
              f"{name} {statistics.median(t):.3f} ms (min {min(t):.3f}), peak {peak[name]:.2f} GiB"
              for name, t in times.items()), flush=True)
    profile_step(steps["bf16 kernels"], x, y, what="bf16 kernel step")
    del models, steps, x, y
    torch.cuda.empty_cache()
    return res, counts


PROBE_LAUNCHES = {"P1": 6, "P2": 8, "P3": 2, "P4": 1}  # per run of the probe scripts' checks
LAUNCH_STAGE_CALLS = 10_000  # calls per stage of P1's launch path (phase 25)
PROBE_NAMES = {"P1": "probe_roll", "P2": "probe_row_window_sum", "P3": "probe_affine",
               "P4": "probe_floor_divmod"}
MC_ITER, MC_DROPOUT, MC_STAGES_K2 = 8, 0.3, 136  # phase 26; K2 per RDN forward (`BASELINES`)
MC_REL_TOL, MC_UCE_REL_TOL = 1e-3, 1e-2  # kernels vs plain: epi and err, UCE


def probe_work(probe, args, out):
    """(bytes, operations) of one probe call: its X rows that the function
    needs (P2: the rows its window reads on this run's bounds), its SMEM
    ints and its output, each moved once; P2's adds (and products when
    weighted), P3's product and sum per element; P1 and P4 do no float
    arithmetic (P4's integer operations are negligible beside its bytes)."""
    from smilecode_tpu_torch.probes import Smem

    out_bytes = out.numel() * out.element_size()
    smem = sum(4 * len(a) for a in probe.args if isinstance(a, Smem))
    if probe.kernel == "P2":
        x, n, base, stride, bounds = args[:5]
        lo, hi = (int(v) for v in (bounds.tolist() if hasattr(bounds, "tolist") else bounds))
        t = max(hi - lo, 0)
        rows = {base + stride * u + (0 if probe.kwargs.get("bcast") else r)
                for u in range(lo, hi) for r in range(n)}
        rows = {r for r in rows if 0 <= r < x.shape[0]}
        ops = n * x.shape[1] * t * (2 if probe.kwargs.get("weighted") else 1)
        return len(rows) * x.shape[1] * 4 + smem + out_bytes, ops
    x_bytes = args[0].numel() * args[0].element_size() if probe.x else 0  # P4: t is its Smem
    return x_bytes + smem + out_bytes, 2 * out.numel() if probe.kernel == "P3" else 0


def probe_library(probe, args):
    """The one PyTorch call that computes the probe's function, or None:
    `torch.roll` (P1), ``x + 1`` / ``x * 2`` (P3), and for P2's runs whose
    bounds come by value (k8a, k9, k10: stride 1, unweighted, every row
    inside x) the sum over ``x.unfold(0, hi - lo, 1)``'s windows. Bounds on
    the device would need a copy to the host and a sync to slice; P4's
    floor division and modulo take two calls (`floor_divmod_pair`)."""
    import torch

    if probe.kernel == "P1":
        shift = -probe.args[0][0] if isinstance(probe.args[0], tuple) else -probe.args[0]
        return lambda: torch.roll(args[0], shift, probe.args[1])
    if probe.kernel == "P3":
        alpha, beta = probe.args
        return (lambda: args[0] + beta) if alpha == 1.0 else (lambda: args[0] * alpha)
    if probe.kernel == "P2" and not isinstance(args[4], torch.Tensor):
        x, n, base, stride, (lo, hi) = args
        require(stride == 1 and not probe.kwargs and 0 <= base + lo and
                base + hi + n - 1 <= x.shape[0], f"{probe.name}: no unfold window")
        return lambda: x.unfold(0, hi - lo, 1)[base + lo:base + lo + n].sum(-1)
    return None


SIZED_VOLUME = (160, 192, 160)  # LPBA40's registered volume (D, H, W)


def sized_cases(device):
    """Phase 25's cases at one 160x192x160 volume's size: (label, kernel,
    wrapper arguments, library call, (bytes, operations)). P2: the 9-row
    zero-padded box sum along D of an f32 volume as x (160, 30720), bounds
    (-4, 5) by value, against `F.avg_pool2d` with ``divisor_override=1``;
    P4: the row base and column of each flat voxel index, t = arange(-N/2,
    N/2) int32, m = 160, against the pair `torch.div` floor, `torch.remainder`.
    Bytes: each input read and each output written once."""
    import torch
    import torch.nn.functional as F

    d, h, w = SIZED_VOLUME
    g = torch.Generator(device=device).manual_seed(25)
    x = torch.randn((d, h * w), generator=g, device=device)
    t = torch.arange(-(d * h * w) // 2, (d * h * w) // 2, dtype=torch.int32, device=device)
    return [
        (f"P2 9-row box sum along D, x {d}x{h * w}", "P2", (x, d, 0, 1, (-4, 5)),
         lambda: F.avg_pool2d(x[None, None], (9, 1), stride=1, padding=(4, 0),
                              divisor_override=1)[0, 0],
         (2 * x.numel() * 4, x.numel() * 9)),
        (f"P4 flat voxel index // {w}, {t.numel()} values", "P4", (t, w),
         lambda: floor_divmod_pair(t, w), (3 * t.numel() * 4, 0)),
    ]


def floor_divmod_pair(t, m):
    """P4's function as two PyTorch calls."""
    import torch

    return torch.div(t, m, rounding_mode="floor") * m, torch.remainder(t, m)


def time_in_turns(call, lib, iters=200):
    """(call ms, device ms, host us per call) of ``call`` and, where ``lib``
    is given, (ms, device ms) of ``lib``: in turns, lib, call, call, lib,
    on both clocks (`event_ms`, `device_ms`)."""
    order = (lib, call, call, lib) if lib is not None else (call,)
    ev = [event_ms(f, iters, warmup=5) for f in order]
    dev = [device_ms(f, iters) for f in order]
    mine = [i for i, f in enumerate(order) if f is call]
    res = (float(np.mean([ev[i] for i in mine])), float(np.mean([dev[i] for i in mine])),
           float(np.mean([dev[i].host_us for i in mine])))
    lib_res = ((ev[0] + ev[3]) / 2, (dev[0] + dev[3]) / 2) if lib is not None else None
    return res, lib_res


def check_probe_edges(device):
    """P1-P4 vs their plain versions on `probes.EDGE_CASES`, the card tests'
    edge cases (amounts negative or past the axis, empty windows, rows
    outside X, both weight modes, t in -20..20), the amounts and bounds as
    int32 tensors on the card under ``torch.cuda.set_sync_debug_mode
    ("error")`` (`probes.launch_edge_case`): exact, one launch per call and
    no sync in a wrapper. Returns the case count."""
    import torch

    from smilecode_tpu_torch.probes import EDGE_CASES, launch_edge_case

    for case in EDGE_CASES:
        out = launch_edge_case(case, device)
        require(out.shape == case.want.shape and torch.equal(out, case.want),
                f"{case.kernel} edge case {case.id}: kernel differs from the plain version")
    return len(EDGE_CASES)


def launch_stage_ns(card, device, kernel="P1", n=LAUNCH_STAGE_CALLS):
    """Host ns per call of each stage of a probe kernel's launch path, each
    stage alone over ``n`` calls (`time.perf_counter_ns`, in runs of 100
    with the card synchronised between runs, so that the launches never
    wait for a full queue): P1 (`kernels/probes.py:roll`) on k1's inputs,
    the amount an int32 tensor on the card, or P2 (`row_window_sum`) on
    k8a's, the bounds by value; the stages as `kernels/_build.py:launch`
    runs them ("after") and, for P1, as every wrapper ran them before it
    ("before": the checks with a device walk per amount tensor, the entry
    point looked up and its argtypes assigned per call, `torch.cuda.device`
    entered, a `torch.cuda.Stream` object built); the allocation and the
    ctypes call with its launch are the same in both. Also the whole call
    and the library call's (`torch.roll`; P2's unfold sum). Returns
    {stage: {"before": ns or None, "after": ns}}."""
    import ctypes

    import torch

    from smilecode_tpu_torch import probes
    from smilecode_tpu_torch.kernels import _build
    from smilecode_tpu_torch.kernels import probes as kp

    lib = _build.library()
    if kernel == "P1":
        x = torch.from_numpy(probes.X32).to(device)
        ints = torch.tensor([3], dtype=torch.int32, device=device)
        out = torch.empty_like(x)
        name, types = "smilecode_probe_roll", kp._ROLL_ARGTYPES
        args = (x.data_ptr(), out.data_ptr(), 32, 128, 0, ints.data_ptr(), 0)
        whole, library = (lambda: kp.roll(x, ints, 0)), (lambda: torch.roll(x, -3, 0))
        check_after = lambda: (kp._kernel_ints("roll", x, torch.float32, 2, ints, 1),  # noqa: E731
                               kp._c_ints("roll", "rows cols amount", 32, 128, 0))
        alloc = lambda: torch.empty_like(x.contiguous())  # noqa: E731
    else:
        (probe,) = [p for p in probes.PROBES if p.name == "k8a"]
        x, nrows, base, stride, ints = probes.probe_args(probe, device)
        out = torch.empty((nrows, 128), device=device)
        name, types = "smilecode_probe_row_window", kp._WINDOW_ARGTYPES
        flags = stride  # k8a: stride 1, unweighted, no bcast
        args = (x.data_ptr(), out.data_ptr(), 64, 128, nrows, base, flags, None, *ints)
        whole, library = (lambda: kp.row_window_sum(x, nrows, base, stride, ints),
                          probe_library(probe, (x, nrows, base, stride, ints)))
        check_after = lambda: (  # noqa: E731
            kp._kernel_ints("row_window_sum", x, torch.float32, 2, ints, 2),
            kp._c_ints("row_window_sum", "rows cols n base lo hi", 64, 128, nrows, base, 1, 3))
        alloc = lambda: x.new_empty((nrows, x.shape[1]))  # noqa: E731
    fn = _build._bound.get(name) or _build._bind(name, types)
    index, raw = x.get_device(), torch._C._cuda_getCurrentRawStream

    def checks_before():  # each amount tensor's device compared, then its values checked
        if x.dtype != torch.float32 or x.dim() != 2:
            raise TypeError
        for a in (ints,):
            if isinstance(a, torch.Tensor) and (a.dtype != torch.int32 or a.device != x.device):
                raise TypeError
        if x.device.type == "cpu" or x.device.type != "cuda":
            raise ValueError
        if isinstance(ints, torch.Tensor):
            if ints.numel() != 1 or not ints.is_contiguous():
                raise ValueError
            return ints.data_ptr(), (0,)

    def bind_before():
        f = getattr(lib, name)
        f.argtypes = types
        f.restype = ctypes.c_int

    def guard_before():
        with torch.cuda.device(x.device):
            pass

    p1 = kernel == "P1"
    stages = {
        "checks": (checks_before if p1 else None, check_after),
        "bind": (bind_before if p1 else None, lambda: _build._bound.get(name)),
        "device guard": (guard_before if p1 else None,
                         lambda: x.get_device() == torch._C._cuda_getDevice()),
        "stream": ((lambda: torch.cuda.current_stream(x.device).cuda_stream) if p1 else None,
                   lambda: raw(index)),
        "allocate": (alloc if p1 else None, alloc),
        "ctypes call and launch": ((lambda: fn(*args, raw(index))) if p1 else None,
                                   lambda: fn(*args, raw(index))),
        "whole call": (None, whole),
        "library call": (None, library),
        "empty loop": ((lambda: None) if p1 else None, lambda: None),
    }

    def per_call_ns(f):
        total = 0
        for _ in range(n // 100):
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(100):
                f()
            total += time.perf_counter_ns() - t0
        torch.cuda.synchronize()
        return total / (n // 100 * 100)

    res = {}
    for stage, (before, after) in stages.items():
        res[stage] = {"before": per_call_ns(before) if before else None,
                      "after": per_call_ns(after)}
    print(f"[{card}] {kernel} launch path, host ns per call over {n} calls a stage"
          + (" (before / after the bound launcher)" if p1 else "") + ": " + "; ".join(
              f"{k} " + ("" if v["before"] is None else f"{round(v['before'])} / ")
              + f"{round(v['after'])}" for k, v in res.items()), flush=True)
    return res


def launch_floor(card, device):
    """The launch floor beside the P rows: device ms of an empty kernel
    (`torch.cuda._sleep(0)`), its call ms, and P3's call and device ms on 4
    values (its smallest launch)."""
    import torch

    from smilecode_tpu_torch.kernels import probes as kp

    x4 = torch.arange(4, dtype=torch.float32, device=device).reshape(1, 4)
    empty = lambda: torch.cuda._sleep(0)  # noqa: E731
    small = lambda: kp.affine(x4, 2.0, 0.0)  # noqa: E731
    floor = {"empty_device_ms": device_ms(empty, 200), "empty_ms": event_ms(empty, 200, 5),
             "p3_4_ms": event_ms(small, 200, 5), "p3_4_device_ms": device_ms(small, 200)}
    print(f"[{card}] launch floor: empty kernel device {floor['empty_device_ms']:.4f} ms, call "
          f"{floor['empty_ms']:.4f} ms; P3 on 4 values call {floor['p3_4_ms']:.4f} ms, device "
          f"{floor['p3_4_device_ms']:.4f} ms", flush=True)
    return floor


def run_probe_phase(card, device):
    """Phase 25: `probes.main` on the card (every probe run exact, P1-P4
    launched exactly `PROBE_LAUNCHES` times), then each kernel against its
    plain version on the card, on the scripts' inputs and the edge cases,
    with call ms, device ms, the host us per call, the plain version's, the
    library call's and the bound per kernel (means per call over the
    scripts' runs; a kernel with a library call timed in turns with it,
    library, kernel, kernel, library, on both clocks), the launch floor and
    the host ns of each stage of P1's launch path. Returns {kernel:
    record}."""
    import torch

    from smilecode_tpu_torch import probes
    from smilecode_tpu_torch.kernels import probes as kp

    for fn in kp.KERNELS.values():
        fn.launches = 0
    results = probes.main(device="cuda")
    counts = {k: fn.launches for k, fn in kp.KERNELS.items()}
    print(f"probes.main on the card: {len(results)} runs, launches {counts}", flush=True)
    require(len(results) == len(probes.PROBES) and all(err == 0 for _, _, err in results),
            f"probe errors {results}")
    require(counts == PROBE_LAUNCHES, f"probe launches {counts}, expected {PROBE_LAUNCHES}")
    n_edge = check_probe_edges(device)

    recs = {}
    for kernel in PROBE_LAUNCHES:
        runs = [p for p in probes.PROBES if p.kernel == kernel]
        r = {key: [] for key in ("ms", "device_ms", "host_us", "plain_ms", "library_ms",
                                 "library_device_ms", "ms_library_runs", "library_runs", "work")}
        r.update(err=0.0, serves=sorted({p.where for p in runs}, key=[p.where for p in runs].index))
        for p in runs:
            args = probes.probe_args(p, device)
            out = kp.KERNELS[kernel](*args, **p.kwargs)
            ref = kp.PLAIN[kernel](*args, **p.kwargs)
            r["err"] = max(r["err"], float((out.double() - ref.double()).abs().max()))
            require(torch.equal(out, ref), f"{p.name}: kernel differs from the plain version")
            lib = probe_library(p, args)
            (ms, dev_ms, host_us), lib_ms = time_in_turns(
                lambda: kp.KERNELS[kernel](*args, **p.kwargs), lib)
            r["ms"].append(ms)
            r["device_ms"].append(dev_ms)
            r["host_us"].append(host_us)
            if lib_ms is not None:
                r["library_ms"].append(lib_ms[0])
                r["library_device_ms"].append(lib_ms[1])
                r["ms_library_runs"].append(ms)
                r["library_runs"].append(p.name)
            r["plain_ms"].append(event_ms(lambda: kp.PLAIN[kernel](*args, **p.kwargs), 20))
            r["work"].append(probe_work(p, args, out))
        if kernel == "P4":  # floor division and modulo: two PyTorch calls
            t, m = probes.probe_args(runs[0], device)
            r["library_pair_ms"] = event_ms(lambda: floor_divmod_pair(t, m), 200, 5)
        rec = {k: float(np.mean(r[k])) for k in ("ms", "device_ms", "host_us", "plain_ms")}
        rec.update(err=r["err"], work=tuple(np.mean(r["work"], axis=0)), serves=r["serves"],
                   library_ms=float(np.mean(r["library_ms"])) if r["library_ms"] else None,
                   library_device_ms=(float(np.mean(r["library_device_ms"]))
                                      if r["library_device_ms"] else None),
                   library_pair_ms=r.get("library_pair_ms"), launches=counts[kernel])
        if r["library_runs"] and len(r["library_runs"]) < len(runs):  # P2: its by-value runs
            rec.update(library_runs=r["library_runs"],
                       ms_library_runs=float(np.mean(r["ms_library_runs"])))
        bound_ms, by = bound(*rec["work"])
        lib = "none"
        if rec["library_ms"] is not None:
            lib = f"{rec['library_ms']:.4f}, device {rec['library_device_ms']:.4f}, in turns"
        if "library_runs" in rec:
            lib += (f" over {', '.join(rec['library_runs'])}, kernel there "
                    f"{rec['ms_library_runs']:.4f}")
        if rec["library_pair_ms"] is not None:
            lib += f" (torch.div floor + torch.remainder {rec['library_pair_ms']:.4f})"
        print(f"[{card}] {kernel} {PROBE_NAMES[kernel]} over its {len(runs)} probe runs "
              f"({', '.join(r['serves'])}), per call: {rec['ms']:.4f} ms, device "
              f"{rec['device_ms']:.4f}, host {rec['host_us']:.2f} us (plain {rec['plain_ms']:.4f}, "
              f"library {lib}); bound {bound_ms:.6f} ms ({by}): launch-bound; max_abs_err "
              f"{rec['err']:.1e}", flush=True)
        recs[kernel] = rec
    print(f"P1-P4 vs plain on {n_edge} edge cases: exact, one launch each, no host sync",
          flush=True)
    for label, kernel, args, lib, work in sized_cases(device):
        recs[kernel]["sized"] = run_sized_case(card, label, kernel, args, lib, work)
    floor = launch_floor(card, device)
    stages = {k: launch_stage_ns(card, device, k) for k in ("P1", "P2")}
    for rec in recs.values():
        rec["launch_floor"] = floor
    for k, st in stages.items():
        recs[k]["launch_stages_ns"] = st
    return recs


def run_sized_case(card, label, kernel, args, lib, work):
    """One of `sized_cases`: the kernel held bit for bit against its plain
    version (one launch), then its call ms, device ms and host us per call
    in turns with the library call, the plain version's ms, the bound and
    the share of it. Returns the record."""
    import torch

    from smilecode_tpu_torch.kernels import probes as kp

    fn = kp.KERNELS[kernel]
    before = fn.launches
    out = fn(*args)
    torch.cuda.synchronize()
    require(fn.launches == before + 1, f"{label}: {fn.launches - before} launches for one call")
    ref = kp.PLAIN[kernel](*args)
    require(out.shape == ref.shape and torch.equal(out, ref),
            f"{label}: kernel differs from the plain version")
    lib_out = lib()
    lib_equal = bool(torch.equal(torch.stack(lib_out) if isinstance(lib_out, tuple) else lib_out,
                                 ref))
    (ms, dev_ms, host_us), (lib_ms, lib_dev_ms) = time_in_turns(lambda: fn(*args), lib, 100)
    plain_ms = event_ms(lambda: kp.PLAIN[kernel](*args), 5)
    bound_ms, by = bound(*work)
    rec = {"case": label, "ms": ms, "device_ms": dev_ms, "host_us": host_us, "plain_ms": plain_ms,
           "library_ms": lib_ms, "library_device_ms": lib_dev_ms, "library_equal": lib_equal,
           "library_calls": 2 if kernel == "P4" else 1, "bound_ms": bound_ms, "bound_by": by,
           "share": bound_ms / dev_ms, "max_abs_err": 0.0}
    print(f"[{card}] {kernel} sized, {label}: {ms:.4f} ms, device {dev_ms:.4f}, host "
          f"{host_us:.2f} us (plain {plain_ms:.4f}; library {lib_ms:.4f}, device {lib_dev_ms:.4f}, "
          f"in turns, {rec['library_calls']} call(s), equal to plain: {lib_equal}); bound "
          f"{bound_ms:.4f} ms ({by}), share {rec['share']:.3f}; exact, one launch", flush=True)
    return rec


def run_mc_phase(card, device, tmp, data_dir):
    """Phase 26: RDN's MC-dropout uncertainty protocol through `infer.main`
    (rdn, stages 4, levels 4,4,4,4, dropout_rate MC_DROPOUT, MC_ITER
    samples) on the 2 subjects of ``data_dir`` (2 ordered pairs) with a
    seeded, head-perturbed JAX-format checkpoint: twice with the kernels
    (bit for bit the same MC samples and statistics), once plain, whose
    masks are the same draws of the generator seeded 24 (every sample's
    moved image within MOVED_TOL, phase 14's gate; epi and err within
    MC_REL_TOL, UCE within MC_UCE_REL_TOL, per pair); exactly MC_ITER x
    MC_STAGES_K2 K2 launches per pair, none plain; a forward with the dropout head but no
    generator equals the dropout-free forward, bit for bit. Then ms per MC
    sample, kernels and plain in turns, and the idle share of one kernel
    sample. Returns the kernel run's launch counts."""
    import torch

    model_dir = os.path.join(tmp, "exp_rdn_mc")
    write_jax_checkpoint(model_dir, seeded_baseline("rdn", device))
    n_pairs = N_VAL_SUBJECTS * (N_VAL_SUBJECTS - 1)
    runs = {}
    for what, impl in (("kernels", "auto"), ("kernels again", "auto"), ("plain", "plain")):
        record = []
        uce, epi, counts, secs = run_infer(data_dir, model_dir, attn_impl=impl, model="rdn",
                                           mc_record=record, dropout_rate=MC_DROPOUT,
                                           mc_iter=MC_ITER)
        runs[what] = (uce, epi, counts, record)
        print(f"MC uncertainty rdn ({what}): {n_pairs} pairs x {MC_ITER} samples in "
              f"{secs:.2f} s, mean UCE {uce:.6f}, mean epi {epi:.6e}, K2 launches "
              f"{counts['K2']}", flush=True)
    k_counts = runs["kernels"][2]
    want = dict.fromkeys(k_counts, 0)
    want["K2"] = MC_ITER * MC_STAGES_K2 * n_pairs
    require(k_counts == want, f"MC launches {k_counts}, expected {want}")
    require(not any(runs["plain"][2].values()), "the plain MC run launched a kernel")
    require(all(len(runs[w][3]) == n_pairs for w in runs), "MC: pairs recorded per run")
    for i, (k, again, p) in enumerate(zip(*(runs[w][3] for w in ("kernels", "kernels again",
                                                                  "plain")))):
        (k_preds, k), (a_preds, again), (p_preds, p) = k, again, p
        require(np.array_equal(k_preds, a_preds) and all(np.array_equal(a, b)
                                                         for a, b in zip(k, again)),
                f"MC pair {i}: the repeated kernel run differs")
        require(k_preds.shape == p_preds.shape == (MC_ITER, 1, *SIZE, 1)
                and bool(np.isfinite(k_preds).all()), f"MC pair {i}: stack {k_preds.shape}")
        moved = np.abs(k_preds - p_preds).reshape(MC_ITER, -1)
        moved_max, moved_p99 = float(moved.max()), float(np.percentile(moved, 99))
        rel = {name: abs(float(np.mean(k[j])) - float(np.mean(p[j]))) / abs(float(np.mean(p[j])))
               for j, name in ((1, "epi"), (3, "err"))}
        rel["uce"] = abs(k[4] - p[4]) / abs(p[4])
        print(f"MC pair {i}: moved images, kernels vs plain over the {MC_ITER} samples: max abs "
              f"diff {moved_max:.3e} (worst sample {int(moved.max(axis=1).argmax())}), p99 "
              f"{moved_p99:.3e}; epi {float(np.mean(k[1])):.6e} vs plain "
              f"{float(np.mean(p[1])):.6e}, err {float(np.mean(k[3])):.6e} vs "
              f"{float(np.mean(p[3])):.6e}, UCE {k[4]:.6e} vs {p[4]:.6e}; relative differences "
              f"epi {rel['epi']:.3e}, err {rel['err']:.3e}, UCE {rel['uce']:.3e}; repeated kernel "
              f"run: bit for bit", flush=True)
        require(np.isfinite(k[4]) and float(np.mean(k[1])) > 0, f"MC pair {i}: epi or UCE")
        require(moved_max <= MOVED_TOL, f"MC pair {i}: moved diff {moved_max} > {MOVED_TOL}")
        require(rel["epi"] <= MC_REL_TOL and rel["err"] <= MC_REL_TOL
                and rel["uce"] <= MC_UCE_REL_TOL, f"MC pair {i}: kernels vs plain {rel}")
    del runs

    x, y = forward_pair(data_dir, device)
    models = {"kernels": seeded_baseline("rdn", device, dropout_rate=MC_DROPOUT),
              "plain": seeded_baseline("rdn", device, "plain", dropout_rate=MC_DROPOUT)}
    with torch.no_grad():
        off = seeded_baseline("rdn", device)(x, y)
        no_gen = models["kernels"](x, y)
    require(all(torch.equal(a, b) for a, b in zip(off, no_gen)),
            "RDN with a dropout head and no generator differs from the dropout-free forward")
    del off, no_gen
    gens = {k: torch.Generator(device=device).manual_seed(24) for k in models}
    samples = {k: (lambda m, g: lambda a, b: m(a, b, generator=g))(m, gens[k])
               for k, m in models.items()}
    times, peak = time_forwards(samples, x, y, N_TIMED_BASELINE)
    print(f"[{card}] rdn MC sample (dropout {MC_DROPOUT}, {'x'.join(map(str, SIZE))}), median of "
          f"{N_TIMED_BASELINE}: " + "; ".join(
              f"{k} {statistics.median(t):.3f} ms (min {min(t):.3f}), peak {peak[k]:.2f} GiB"
              for k, t in times.items()), flush=True)
    with torch.no_grad():
        profile_step(samples["kernels"], x, y, top=6, what="rdn MC sample (kernels)")
    del models, samples, x, y
    torch.cuda.empty_cache()
    return k_counts


def modet_train_launches(n_steps, n_val):
    want = {"K1": 5 * (n_steps + n_val), "K2": 9 * (n_steps + n_val), "K3": 5 * n_steps,
            "K4": 5 * n_steps, "K5": 9 * n_steps, "K5 d_src": 8 * n_steps}
    want.update({f"{k} bf16": 0 for k in want})
    return want


def step_times(root, exp_dir):
    """The ms per step that `train.main` logged under ``root`` (its
    ``metrics.jsonl``, beside the checkpoints of ``exp_dir``)."""
    save_dir = os.path.basename(os.path.normpath(exp_dir))
    with open(os.path.join(root, "logs", save_dir, "metrics.jsonl")) as f:
        return [round(json.loads(line)["step_ms"], 3) for line in f if '"iter"' in line]


def run_dataset_phase(card, device, tmp, data_dir):
    """Phase 27: `train.main` (ModeT, f32) for 2 steps and its validation,
    then `infer.main` of the trained checkpoint, with ``dataset=half`` (the
    2 subjects of ``data_dir`` at stride 2: 80x96x80 pairs) and
    ``dataset=atlas`` (each subject to a third 160x192x160 subject as the
    atlas), kernels and plain: exact launches (phase 8's per step and per
    validation pair), the plain runs launch nothing, first losses within
    STEP_LOSS_TOL (phase 8's gate), Dice and fold within 1e-3 (phase 3's);
    for ``half``, also the loss and every gradient of one step on a half
    pair, kernels vs plain (`half_step`, phase 9's gates). Returns the launch counts of the kernel runs, summed."""
    import torch

    atlas_dir = os.path.join(tmp, "Atlas")
    os.makedirs(atlas_dir)
    write_subjects(atlas_dir, size=SIZE, device=device, n=1, seed=27)
    atlas = os.path.join(atlas_dir, "subject_00.pkl")
    total = None
    for dataset, shape in (("half", tuple(s // 2 for s in SIZE)), ("atlas", SIZE)):
        kw = {"dataset": dataset, "atlas_path": atlas}
        n_steps = n_val = N_VAL_SUBJECTS * (N_VAL_SUBJECTS - 1) if dataset == "half" \
            else N_VAL_SUBJECTS
        root = os.path.join(tmp, f"train_{dataset}")
        best, exp_dir, losses, counts, secs = run_train(data_dir, data_dir,
                                                        os.path.join(root, "kernels"), **kw)
        print(f"train {dataset} {'x'.join(map(str, shape))} (kernels): {n_steps} steps + {n_val} "
              f"validation pairs in {secs:.2f} s, losses {losses}, best dsc {best:.6f}, "
              f"launches {counts}", flush=True)
        require(len(losses) == n_steps and bool(np.isfinite(losses).all()),
                f"{dataset}: losses {losses}")
        want = modet_train_launches(n_steps, n_val)
        require(counts == want, f"{dataset}: train launches {counts}, expected {want}")
        _, _, p_losses, p_counts, p_secs = run_train(data_dir, data_dir,
                                                     os.path.join(root, "plain"),
                                                     attn_impl="plain", **kw)
        step_ms = {impl: step_times(os.path.join(root, impl), exp_dir)
                   for impl in ("kernels", "plain")}
        print(f"train {dataset} (plain): {p_secs:.2f} s, losses {p_losses}; ms per step (host "
              f"clock, the first with warm-up): kernels {step_ms['kernels']}, plain "
              f"{step_ms['plain']}", flush=True)
        require(not any(p_counts.values()), f"{dataset}: the plain training run launched a kernel")
        require(abs(losses[0] - p_losses[0]) <= STEP_LOSS_TOL * abs(p_losses[0]),
                f"{dataset}: first step loss, kernels vs plain: {losses[0]} vs {p_losses[0]}")
        dsc, fold, i_counts, i_secs = run_infer(data_dir, exp_dir, **kw)
        p_dsc, p_fold, ip_counts, _ = run_infer(data_dir, exp_dir, attn_impl="plain", **kw)
        print(f"infer {dataset} of the trained checkpoint: {n_val} pairs in {i_secs:.2f} s, "
              f"dsc {dsc:.6f} (plain {p_dsc:.6f}), fold {fold:.6f} (plain {p_fold:.6f}), "
              f"K1 {i_counts['K1']}, K2 {i_counts['K2']} launches", flush=True)
        require(np.isfinite(dsc) and 0.0 <= dsc <= 1.0 and np.isfinite(fold) and 0 <= fold <= 1,
                f"{dataset}: dsc {dsc}, fold {fold}")
        require(i_counts == {**dict.fromkeys(i_counts, 0), "K1": 5 * n_val, "K2": 9 * n_val},
                f"{dataset}: infer launches {i_counts}")
        require(not any(ip_counts.values()), f"{dataset}: the plain infer run launched a kernel")
        require(abs(dsc - p_dsc) <= 1e-3 and abs(fold - p_fold) <= 1e-3,
                f"{dataset}: kernels vs plain infer: dsc {dsc} vs {p_dsc}, fold {fold} vs {p_fold}")
        for c in (counts, i_counts):
            total = c if total is None else {k: v + c[k] for k, v in total.items()}
        if dataset == "half":
            half_step(device, data_dir, shape)
        torch.cuda.empty_cache()
    return total


def half_step(device, data_dir, shape):
    """Phase 27's gradient gate at the half shapes: one loss-and-gradients
    pass of the seeded ModeT, kernels vs plain, on the first ``dataset=half``
    pair of ``data_dir`` (phase 9's gates, `compare_step_grads`), K1-K5 at
    the five levels 80x96x80 .. 5x6x5, which no other phase launches; the
    kernel pass launches each kernel exactly as one training step does."""
    import torch

    x, y = forward_pair(data_dir, device, "half")
    require(tuple(x.shape) == (1, *shape, 1), f"half pair {tuple(x.shape)}")
    model, plain = seeded_model(device), seeded_model(device, attn_impl="plain")
    reset_launch_counts()
    loss, p_loss, _ = compare_step_grads(model, plain, x, y)
    counts = launch_counts()
    want = modet_train_launches(1, 0)
    print(f"half step {'x'.join(map(str, shape))}: launches {counts}", flush=True)
    require(counts == want, f"half step launches {counts}, expected {want}")
    require(abs(loss - p_loss) <= STEP_LOSS_TOL * abs(p_loss),
            f"half step loss, kernels vs plain: {loss} vs {p_loss}")
    del model, plain, x, y
    torch.cuda.empty_cache()

# --------------------------------------------------------------- phases 28-29

LOSS_VALUE_TOL, LOSS_GRAD_TOL = STEP_LOSS_TOL, STEP_GRAD_TOL  # phase 9's gates, f32 vs f64
N_TIMED_LOSS = 5
# phase 29: the raw Analyze grid (z, y, x) of the synthetic subjects, larger
# than the 160x192x160 crop on every axis, as LPBA40's raw volumes are
RAW_GRID = (181, 217, 175)
N_RAW_SUBJECTS = 2


def smooth_subject(size, seed, device):
    """A smooth texture inside an ellipsoid, zero outside, divided by its
    maximum: an exact 0 background and an exact 1; (1, D, H, W, 1). The
    texture is a sum of six random plane waves, not a trilinear upsampling:
    a trilinear cell is exactly multilinear, and there each of MIND-SSC's
    six symmetric pairs of shift channels ties exactly, so that float32
    and float64 rounding pick different minima (a point where the loss has
    no gradient, held against the JAX package's choice on the CPU)."""
    import torch

    rng = np.random.default_rng(seed)
    grids = torch.meshgrid(*(torch.linspace(-1, 1, s, device=device, dtype=torch.float64)
                             for s in size), indexing="ij")
    f = torch.zeros(size, device=device, dtype=torch.float64)
    for _ in range(6):
        k, shift = rng.uniform(2.0, 8.0, 3) * rng.choice([-1, 1], 3), rng.uniform(0, 2 * np.pi)
        f += torch.cos(sum(float(ki) * g for ki, g in zip(k, grids)) + shift)
    f = (f - f.min()) / (f.max() - f.min()) + 0.25
    img = torch.where(sum(g * g for g in grids) <= 0.8, f, torch.zeros_like(f)).float()
    return (img / img.max())[None, ..., None].contiguous()


def loss_cases():
    """Phase 28's losses: (name, function, inputs), the inputs being "images"
    (the subject and its warp), "flow" (ModeT's flow), "slice images" and
    "slice flow" (the H x W slice at the middle of D)."""
    from smilecode_tpu_torch.losses import core, extended as ext

    return (
        ("ssim3d", ext.ssim3d, "images"),
        ("ssim3d_loss", ext.ssim3d_loss, "images"),
        ("ssim2d", ext.ssim2d, "slice images"),
        ("mind_loss", ext.mind_loss, "images"),
        ("mutual_information", ext.mutual_information, "images"),
        ("local_mutual_information", ext.local_mutual_information, "images"),
        ("grad2d l1", lambda f: ext.grad2d(f, "l1"), "slice flow"),
        ("grad2d l2", lambda f: ext.grad2d(f, "l2"), "slice flow"),
        ("grad3d_itv", ext.grad3d_itv, "flow"),
        ("displacement gradient-l1", lambda f: ext.displacement_regularizer(f, "gradient-l1"),
         "flow"),
        ("displacement gradient-l2", lambda f: ext.displacement_regularizer(f, "gradient-l2"),
         "flow"),
        ("displacement bending", lambda f: ext.displacement_regularizer(f, "bending"), "flow"),
        ("grad3d l1 (core)", lambda f: core.grad3d(f, "l1"), "flow"),
    )


def loss_inputs(device, size=SIZE):
    """Phase 28's float32 inputs: a smooth subject, the subject warped by
    the flow of the seeded ModeT's forward that registers it to a second
    subject (K1 and K2), and that flow."""
    import torch

    subject = smooth_subject(size, 28, device)
    other = smooth_subject(size, 29, device)
    model = seeded_model(device)
    with torch.no_grad():
        moved, flow = model(subject, other)
    del model
    images = (subject, moved.contiguous())
    flow = flow.contiguous()
    mid = size[0] // 2
    return {"images": images, "flow": (flow,),
            "slice images": tuple(t[:, mid].contiguous() for t in images),
            "slice flow": (flow[:, mid].contiguous(),)}


def value_and_grads(fn, inputs):
    """``fn``'s value and its gradient with respect to each input."""
    import torch

    leaves = [t.detach().requires_grad_() for t in inputs]
    val = fn(*leaves)
    return val, torch.autograd.grad(val, leaves)


def run_loss_phase(card, device, size=SIZE, n=N_TIMED_LOSS):
    """Phase 28: each extended loss (and the repaired `grad3d` l1) at
    ``size``, value and gradients in float32 against the same function in
    float64 on the same inputs (phase 9's gates: value within 1e-4
    relative, each gradient within 1e-3 of its largest float64 magnitude);
    ms per value-and-gradient (median of ``n`` by the port's `StepTimer`)
    and its peak memory above the inputs'; SSIM and MIND give the same bits
    with cuDNN's TF32 on. Returns {name: record}."""
    import torch

    from smilecode_tpu_torch.utils.profiling import StepTimer, memory_stats

    device = torch.device(device)
    groups = loss_inputs(device, size)
    flow = groups["flow"][0]
    print(f"phase 28 inputs: subject and moved {tuple(groups['images'][0].shape)}, "
          f"moved in [{float(groups['images'][1].min()):.4f}, "
          f"{float(groups['images'][1].max()):.4f}], flow max |.| {float(flow.abs().max()):.4f} "
          f"voxel, background share {float((groups['images'][0] == 0).float().mean()):.4f}",
          flush=True)
    records = {}
    for name, fn, kind in loss_cases():
        ins = groups[kind]
        ins64 = [t.double() for t in ins]
        timer = StepTimer()
        value_and_grads(fn, ins)  # warm-up
        peak = 0.0
        for _ in range(n):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            base = memory_stats(device).get("allocated_bytes.all.current", 0)
            timer.start()
            val, grads = value_and_grads(fn, ins)
            timer.stop([val, grads])
            peak = max(peak, (memory_stats(device).get("allocated_bytes.all.peak", 0) - base)
                       / 2**30)
        val64, grads64 = value_and_grads(fn, ins64)
        v, v64 = float(val.detach()), float(val64.detach())
        rel = abs(v - v64) / abs(v64)
        errs = [float((g.double() - g64).abs().max() / g64.abs().max()) for g, g64 in
                zip(grads, grads64)]
        records[name] = {"value": v, "value_f64": v64, "value_rel_err": rel,
                         "grad_err": max(errs), "ms": timer.median_ms, "peak_gib": peak}
        print(f"[{card}] {name:26s} {'x'.join(map(str, ins[0].shape[1:-1]))}: value {v:.8g} "
              f"(f64 {v64:.10g}, rel err {rel:.2e}), gradient err {max(errs):.2e} of its "
              f"largest; {timer.median_ms:.3f} ms per value-and-gradient (median of {n}), "
              f"peak {peak:.3f} GiB", flush=True)
        require(np.isfinite(v) and all(bool(torch.isfinite(g).all()) for g in grads),
                f"{name}: non-finite value or gradient")
        require(rel <= LOSS_VALUE_TOL, f"{name}: f32 value {v} vs f64 {v64}")
        require(max(errs) <= LOSS_GRAD_TOL, f"{name}: f32 gradient err {max(errs)} of its largest")
        del val, grads, val64, grads64, ins64
    if device.type == "cuda":  # the shifted-slice sums use no cuDNN: TF32 cannot touch them
        from smilecode_tpu_torch.losses import extended as ext

        before = torch.backends.cudnn.allow_tf32
        try:
            for name, fn in (("ssim3d", ext.ssim3d), ("mind_loss", ext.mind_loss)):
                torch.backends.cudnn.allow_tf32 = False
                off = value_and_grads(fn, groups["images"])
                torch.backends.cudnn.allow_tf32 = True
                on = value_and_grads(fn, groups["images"])
                require(bool(torch.equal(off[0], on[0])) and
                        all(torch.equal(a, b) for a, b in zip(off[1], on[1])),
                        f"{name} changed with cuDNN's TF32 on")
        finally:
            torch.backends.cudnn.allow_tf32 = before
        print("ssim3d and mind_loss: the same value and gradient bits with cuDNN's TF32 on",
              flush=True)
    del groups, flow
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return records


def write_analyze(path_stem, vol, endian):
    """An Analyze 7.5 ``.hdr`` and gzipped ``.img`` of ``vol`` (z, y, x),
    x fastest, in byte order ``endian``."""
    import gzip
    import struct

    dz, dy, dx = vol.shape
    hdr = bytearray(348)
    struct.pack_into(endian + "i", hdr, 0, 348)
    struct.pack_into(endian + "4h", hdr, 40, 3, dx, dy, dz)
    struct.pack_into(endian + "h", hdr, 70, {np.dtype("int16"): 4, np.dtype("uint8"): 2}[vol.dtype])
    with open(path_stem + ".hdr", "wb") as f:
        f.write(bytes(hdr))
    with gzip.open(path_stem + ".img.gz", "wb", compresslevel=1) as f:
        f.write(vol.astype(vol.dtype.newbyteorder(endian)).tobytes())


def write_raw_subjects(raw_dir, device, n=N_RAW_SUBJECTS, grid=RAW_GRID, size=SIZE):
    """``n`` LPBA40-like raw subjects on ``grid``: an int16 skull-stripped
    image (a smooth texture in an ellipsoid of ``size``, 0 outside, off the
    grid's centre) and uint8 raw LPBA labels, little-endian for the first,
    big-endian for the next, as ``S<k>/S<k>.skullstripped`` and
    ``S<k>/S<k>.label``."""
    from smilecode_tpu_torch.data.trans import LPBA_SEG_TABLE

    for k in range(1, n + 1):
        img = smooth_subject(size, 40 + k, device)[0, ..., 0].cpu().numpy()
        lab = smooth_subject(size, 50 + k, device)[0, ..., 0].cpu().numpy()
        vol = np.zeros(grid, np.int16)
        lbl = np.zeros(grid, np.uint8)
        o = [(g - s - 2 * k * (i != 1)) // 2 for i, (g, s) in enumerate(zip(grid, size))]
        box = tuple(slice(a, a + s) for a, s in zip(o, size))
        vol[box] = np.round(img * 900).astype(np.int16)
        ids = LPBA_SEG_TABLE[1:][np.minimum((lab * 54).astype(np.int64), 53)]
        lbl[box] = np.where(img > 0, ids, 0).astype(np.uint8)
        sub = os.path.join(raw_dir, f"S{k}")
        os.makedirs(sub)
        endian = "<" if k % 2 else ">"
        write_analyze(os.path.join(sub, f"S{k}.skullstripped"), vol, endian)
        write_analyze(os.path.join(sub, f"S{k}.label"), lbl, endian)


def host_ms(fn, *args, n=3):
    """Median host ms of ``fn(*args)`` over ``n`` calls, and its result."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn(*args)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def openmp_runtimes():
    """The OpenMP runtime files mapped into this process."""
    with open("/proc/self/maps") as f:
        return sorted({line.split()[-1] for line in f
                       if "gomp" in line or "libiomp" in line or "libomp" in line})


def run_data_tools_phase(card, device, tmp, model_dir, trace_dir="chiprun_out/trace_forward",
                         size=SIZE, grid=RAW_GRID):
    """Phase 29: raw Analyze subjects -> the port's `make_pkl_dataset` ->
    `native` equal to numpy exactly on those full-size volumes (host ms of
    each beside numpy's) -> `infer.main` (ModeT f32, phase 3's checkpoint in
    ``model_dir``) on the pkls, exactly phase 3's launches per pair; one
    `utils.profiling.trace` of a forward into ``trace_dir``."""
    import torch

    from smilecode_tpu_torch import native
    from smilecode_tpu_torch.data import datasets, preprocess, trans
    from smilecode_tpu_torch.metrics import dice_val_voi_np
    from smilecode_tpu_torch.utils.profiling import trace

    raw_dir, pkl_dir = os.path.join(tmp, "Raw"), os.path.join(tmp, "Pkl")
    t0 = time.perf_counter()
    write_raw_subjects(raw_dir, device, grid=grid, size=size)
    t1 = time.perf_counter()
    preprocess.make_pkl_dataset(raw_dir, pkl_dir, shape=size, verbose=True)
    t2 = time.perf_counter()
    names = sorted(os.listdir(pkl_dir))
    print(f"{N_RAW_SUBJECTS} raw {'x'.join(map(str, grid))} Analyze subjects written in "
          f"{t1 - t0:.2f} s; make_pkl_dataset {t2 - t1:.2f} s -> {names}", flush=True)
    require(names == [f"subject_{k:02d}.pkl" for k in range(1, N_RAW_SUBJECTS + 1)],
            f"pkls {names}")
    subjects = [datasets.pkload(os.path.join(pkl_dir, name)) for name in names]
    for img, lbl in subjects:
        require(img.shape == lbl.shape == size and img.dtype == np.float32
                and lbl.dtype == np.uint16, f"pkl {img.shape} {img.dtype}, {lbl.shape} {lbl.dtype}")
        require(img.min() == 0.0 and img.max() == 1.0, "pkl image not min-max normalised")

    t0 = time.perf_counter()
    native.library()
    print(f"native build and load: {time.perf_counter() - t0:.2f} s -> {native.library_path()}; "
          f"OpenMP runtimes mapped: {openmp_runtimes()}; torch threads {torch.get_num_threads()}",
          flush=True)
    (img0, lbl0), (_, lbl1) = subjects[0], subjects[1]
    raw = preprocess._read_analyze_img_gz(
        os.path.join(raw_dir, "S1", "S1.skullstripped.img.gz")).astype(np.float32)
    table = trans.LPBA_SEG_TABLE
    seg0, seg1 = trans.seg_remap(lbl0, table), trans.seg_remap(lbl1, table)

    def np_counts(p, t, nlabels=55):
        p, t = p.reshape(-1).astype(np.int64), t.reshape(-1).astype(np.int64)
        inter = np.bincount(np.where(p == t, p, nlabels), minlength=nlabels + 1)[:nlabels]
        return inter, np.bincount(p, minlength=nlabels)[:nlabels], \
            np.bincount(t, minlength=nlabels)[:nlabels]

    checks = (("seg_remap u16", native.seg_remap, trans.seg_remap, (lbl0, table)),
              ("minmax_normalize f32", native.minmax_normalize, native.minmax_normalize_np,
               (raw,)),
              ("halfres f32", native.halfres, datasets.halfres, (img0,)),
              ("halfres u16", native.halfres, datasets.halfres, (lbl0,)),
              ("dice_counts", lambda p, t: native.dice_counts(p, t, 55), np_counts, (seg0, seg1)))
    for name, fast, plain, args in checks:
        ms, got = host_ms(fast, *args)
        p_ms, want = host_ms(plain, *args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        same = all(g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
                   for g, w in zip(got, want))
        print(f"[{card}] native {name:20s} {'x'.join(map(str, args[0].shape))}: {ms:.3f} host ms "
              f"(numpy {p_ms:.3f}), equal: {same}", flush=True)
        require(same, f"native {name} differs from numpy")
    ms, fast = host_ms(native.dice_val_voi_native, seg0, seg1)
    p_ms, slow = host_ms(dice_val_voi_np, seg0, seg1)
    print(f"[{card}] dice_val_voi_native {ms:.3f} host ms (numpy loop {p_ms:.3f}): "
          f"{fast:.12f} vs {slow:.12f}", flush=True)
    require(abs(fast - slow) <= 1e-12, f"dice_val_voi_native {fast} vs numpy {slow}")

    n_pairs = N_RAW_SUBJECTS * (N_RAW_SUBJECTS - 1)
    dsc, fold, counts, secs = run_infer(pkl_dir, model_dir)
    print(f"infer.main on the preprocessed pkls: {n_pairs} pairs in {secs:.2f} s, dsc {dsc:.6f}, "
          f"fold {fold:.6f}, launches {counts}", flush=True)
    require(np.isfinite(dsc) and 0.0 <= dsc <= 1.0 and np.isfinite(fold),
            f"preprocessed pkls: dsc {dsc}, fold {fold}")
    require(counts == {**dict.fromkeys(counts, 0), "K1": 5 * n_pairs, "K2": 9 * n_pairs},
            f"infer launches on the preprocessed pkls {counts}")

    x, y = forward_pair(pkl_dir, device)
    model = seeded_model(device)
    before = set(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else set()
    with torch.no_grad():
        model(x, y)  # warm-up
        torch.cuda.synchronize()
        with trace(trace_dir) as prof:
            model(x, y)
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
              and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    files = sorted(set(os.listdir(trace_dir)) - before)
    mib = sum(os.path.getsize(os.path.join(trace_dir, f)) for f in files) / 2**20
    print(f"utils.profiling.trace of one forward: {len(events)} device operations, "
          f"{sum(e.device_time_total for e in events) / 1e3:.3f} device ms; {trace_dir}: "
          f"{files} ({mib:.2f} MiB)", flush=True)
    require(events and files, "the trace holds no device operation or wrote no file")
    del model, x, y
    torch.cuda.empty_cache()



# ---- the multi-GPU slice (phases 30-32) ------------------------------------

SP_SHARDS = 2  # spatial=2: the D-sharded step's shards
N_TIMED_SP = 3  # timed sharded steps per rank (phase 32)


def shard_shape(level: int, size=SIZE, shards=SP_SHARDS):
    """A rank's D slab of level ``level``'s shape under ``shards`` D shards."""
    d, h, w = level_shape(level, size)
    return (d // shards, h, w)


def halo_k(k, rank, dl):
    """Rank ``rank``'s k slab of the global (B, D, ...) ``k`` with its 1-slice
    D halo: the neighbours' slices, zeros at the volume's ends (what
    `parallel.spatial.halo_exchange` gives it)."""
    import torch

    zero = torch.zeros_like(k[:, :1])
    lo = k[:, rank * dl - 1:rank * dl] if rank > 0 else zero
    hi = k[:, (rank + 1) * dl:(rank + 1) * dl + 1] if (rank + 1) * dl < k.shape[1] else zero
    return torch.cat([lo, k[:, rank * dl:(rank + 1) * dl], hi], 1).contiguous()


def halo_work(kernel: str, shape, isz: int):
    """`attn_work` of a halo-k call on q of ``shape``: K1 and K3 read two more
    k slices, K4 writes two more dk slices."""
    nbytes, ops = attn_work(kernel, shape, isz)
    return nbytes + 2 * int(np.prod(shape[2:])) * isz, ops


def check_halo_attention(device, size=SIZE):
    """Phase 30, attention: K1, K3 and K4 in halo-k mode vs their plain
    versions at the spatial=2 slabs of the five levels, each shard (rank 0's
    halo from its next neighbour, rank 1's from its previous one, zeros at
    the volume's ends), the gates of phases 1 and 6; the bf16 instances at
    the same shapes within 2 bf16 ulps (drpb DRPB_TOL). Times on rank 1's
    slabs. Returns {"K1 halo" | "K3 halo" | "K4 halo": dict(err, ms,
    plain_ms, device_ms, work, by_shape)}, ms summed over a step's five
    calls."""
    import torch

    from smilecode_tpu_torch.kernels.modet_attn import (
        modet_attention,
        modet_attention_bwd_dk,
        modet_attention_bwd_dk_plain,
        modet_attention_bwd_dq,
        modet_attention_bwd_dq_plain,
        modet_attention_plain,
    )

    rng = np.random.default_rng(30)
    res = {key: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0, "work": np.zeros(2),
                 "by_shape": {}} for key in ("K1 halo", "K3 halo", "K4 halo")}
    for level, heads in zip((5, 4, 3, 2, 1), NUM_HEADS):
        dl = shard_shape(level, size)[0]
        full = (1, *level_shape(level, size), heads, HEAD_DIM)
        q_all, k_all = (torch.from_numpy(rng.standard_normal(full, dtype=np.float32)).to(device)
                        for _ in range(2))
        rpb = torch.from_numpy(rng.standard_normal((heads, 3, 3, 3), dtype=np.float32) * 0.5).to(
            device)
        g_all = torch.from_numpy(rng.standard_normal((*full[:4], heads * 3),
                                                     dtype=np.float32)).to(device)
        for rank in range(SP_SHARDS):
            q = q_all[:, rank * dl:(rank + 1) * dl].contiguous()
            g = g_all[:, rank * dl:(rank + 1) * dl].contiguous()
            k = halo_k(k_all, rank, dl)
            shape = tuple(q.shape)
            what = f"halo-k level {level} rank {rank} q {shape}"
            out = modet_attention(q, k, rpb, 1.0, k_halo=True)
            err1 = float((out - modet_attention_plain(q, k, rpb, 1.0, k_halo=True)).abs().max())
            require(bool(torch.isfinite(out).all()) and err1 <= ATTN_TOL,
                    f"K1 {what}: max abs err {err1} > {ATTN_TOL}")
            dq, dl_, part = modet_attention_bwd_dq(q, k, rpb, 1.0, g, k_halo=True)
            p_dq, p_dl, p_drpb = modet_attention_bwd_dq_plain(q, k, rpb, 1.0, g, k_halo=True)
            dk = modet_attention_bwd_dk(q, p_dl, 1.0, k_halo=True)
            p_dk = modet_attention_bwd_dk_plain(q, p_dl, 1.0, k_halo=True)
            require(dk.shape == k.shape, f"K4 {what}: dk {tuple(dk.shape)}, k {tuple(k.shape)}")
            drpb = part.sum(0).reshape(heads, 3, 3, 3)
            errs = {}
            for name, a, b, tol in (
                    ("dq", dq, p_dq, BWD_TOL * float(p_dq.abs().max())),
                    ("dl", dl_, p_dl, BWD_TOL * float(p_dl.abs().max())),
                    ("drpb", drpb, p_drpb, DRPB_TOL * float(p_dl.abs().sum(dim=(0, 1, 2, 3)).max())),
                    ("dk", dk, p_dk, BWD_TOL * float(p_dk.abs().max()))):
                err = float((a - b).abs().max())
                require(bool(torch.isfinite(a).all()) and err <= tol,
                        f"{what}: {name} max abs err {err} > {tol}")
                errs[name] = err
            # the border slices of dk are the neighbours' cotangents: data, not zeros
            require(rank == 0 or float(p_dk[:, 0].abs().max()) > 0, f"{what}: dk border is zero")
            res["K1 halo"]["err"] = max(res["K1 halo"]["err"], err1)
            res["K3 halo"]["err"] = max(res["K3 halo"]["err"], errs["dq"], errs["dl"], errs["drpb"])
            res["K4 halo"]["err"] = max(res["K4 halo"]["err"], errs["dk"])
            line = (f"{what}, k {tuple(k.shape)}: K1 {err1:.3e}, K3 dq {errs['dq']:.3e} dl "
                    f"{errs['dl']:.3e} drpb {errs['drpb']:.3e}, K4 dk {errs['dk']:.3e}")
            # the bf16 instances, on the same inputs rounded
            qb, kb, gb = q.bfloat16(), k.bfloat16(), g.bfloat16()
            bf16_err(modet_attention(qb, kb, rpb, 1.0, k_halo=True),
                     modet_attention_plain(qb, kb, rpb, 1.0, k_halo=True), f"bf16 K1 {what}")
            b_dq, b_dl, b_part = modet_attention_bwd_dq(qb, kb, rpb, 1.0, gb, k_halo=True)
            pb_dq, pb_dl, pb_drpb = modet_attention_bwd_dq_plain(qb, kb, rpb, 1.0, gb, k_halo=True)
            bf16_err(b_dq, pb_dq, f"bf16 K3 dq {what}")
            bf16_err(b_dl, pb_dl, f"bf16 K3 dl {what}")
            b_err = float((b_part.sum(0).reshape(heads, 3, 3, 3) - pb_drpb).abs().max())
            b_tol = DRPB_TOL * float(pb_dl.float().abs().sum(dim=(0, 1, 2, 3)).max())
            require(b_err <= b_tol, f"bf16 K3 drpb {what}: {b_err} > {b_tol}")
            bf16_err(modet_attention_bwd_dk(qb, pb_dl, 1.0, k_halo=True),
                     modet_attention_bwd_dk_plain(qb, pb_dl, 1.0, k_halo=True), f"bf16 K4 {what}")
            line += "; bf16 K1, K3, K4 within 2 ulps"
            if rank == SP_SHARDS - 1:
                calls = {"K1 halo": (lambda: modet_attention(q, k, rpb, 1.0, k_halo=True),
                                     lambda: modet_attention_plain(q, k, rpb, 1.0, k_halo=True),
                                     "K1"),
                         "K3 halo": (lambda: modet_attention_bwd_dq(q, k, rpb, 1.0, g, k_halo=True),
                                     lambda: modet_attention_bwd_dq_plain(q, k, rpb, 1.0, g,
                                                                          k_halo=True), "K3"),
                         "K4 halo": (lambda: modet_attention_bwd_dk(q, p_dl, 1.0, k_halo=True),
                                     lambda: modet_attention_bwd_dk_plain(q, p_dl, 1.0,
                                                                          k_halo=True), "K4")}
                for key, (fn, plain_fn, kernel) in calls.items():
                    t, tp, dev = event_ms(fn, 10), event_ms(plain_fn, 3), device_ms(fn)
                    work = halo_work(kernel, shape, 4)
                    r = res[key]
                    r["ms"] += t
                    r["plain_ms"] += tp
                    r["device_ms"] += dev
                    r["work"] += work
                    r["by_shape"][attn_label(level, shape)] = {
                        "ms": t, "device_ms": dev, "bound_ms": bound(*work)[0]}
                    line += (f"; {key} {t:.4f} ms, device {dev:.4f} (plain {tp:.4f}, bound "
                             f"{bound(*work)[0]:.4f})")
            print(line, flush=True)
        del q_all, k_all, g_all
        torch.cuda.empty_cache()
    return res


def reach_slices(flow, d0: int, src_depth: int) -> int:
    """The source slices a D-origin warp by ``flow`` (B, FD, H, W, 3) at
    origin ``d0`` can touch: from the lower corner of the smallest sample
    depth d + d0 + flow_d to the upper corner of the largest, within the
    source's ``src_depth`` slices. The bound counts these, read by K2 and
    K5 and scattered into by K5; a rank reads only them of the gathered
    source."""
    import torch

    depth = (torch.arange(flow.shape[1], dtype=torch.float32, device=flow.device)
             .reshape(1, -1, 1, 1) + d0 + flow[..., 0])
    lo = max(int(np.floor(float(depth.min()))), 0)
    hi = min(int(np.floor(float(depth.max()))) + 1, src_depth - 1)
    return max(hi - lo + 1, 0)


def check_origin_warps(device, size=SIZE):
    """Phase 30, warps: K2 and K5 in D-origin mode vs their plain versions
    at the nine warps of a spatial=2 step (local flow slab, source gathered
    to the full depth, d0 = rank * slab depth), each shard, smooth +-5 and
    wild +-20 voxel flows: K2 within WARP_TOL of max|src|, K5 d_flow and
    d_src (over the gathered depth) within BWD_TOL of the plain version's
    largest; the bf16 instances at the four feature warps within 2 bf16
    ulps (d_flow BWD_TOL). Times on rank 1's smooth flows, beside
    `F.grid_sample` (and its backward) on the gathered source; the bounds
    count only the source slices the flow reaches (`reach_slices`). Returns
    {"K2 origin" | "K5 origin": dict(err, ms, plain_ms, library_ms,
    device_ms, work, by_shape)}, ms summed over a step's nine calls."""
    import torch

    from smilecode_tpu_torch.kernels.warp3d import (
        warp3d_trilinear,
        warp3d_trilinear_bwd,
        warp3d_trilinear_bwd_plain,
        warp3d_trilinear_plain,
    )

    rng = np.random.default_rng(31)
    res = {key: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "device_ms": 0.0,
                 "library_device_ms": 0.0, "work": np.zeros(2), "by_shape": {}}
           for key in ("K2 origin", "K5 origin")}
    for what, c, level in warp_calls():
        want_dsrc = what != "moved image"
        full, local = level_shape(level, size), shard_shape(level, size)
        src = torch.from_numpy(rng.standard_normal((1, *full, c), dtype=np.float32)).to(device)
        for rank in range(SP_SHARDS):
            d0 = rank * local[0]
            g = torch.from_numpy(rng.standard_normal((1, *local, c), dtype=np.float32)).to(device)
            flows = {"smooth +-5": smooth_flow(local, 5.0, device),
                     "wild +-20": torch.from_numpy(
                         rng.uniform(-20, 20, (1, *local, 3)).astype(np.float32)).to(device)}
            for fname, flow in flows.items():
                label = f"D-origin {what} C={c} src {full} flow {local} d0={d0} {fname}"
                out = warp3d_trilinear(src, flow, d0)
                err2 = float((out - warp3d_trilinear_plain(src, flow, d0)).abs().max())
                tol2 = WARP_TOL * float(src.abs().max())
                require(bool(torch.isfinite(out).all()) and err2 <= tol2,
                        f"K2 {label}: max abs err {err2} > {tol2}")
                d_src, d_flow = warp3d_trilinear_bwd(src, flow, g, want_dsrc, d0)
                p_src, p_flow = warp3d_trilinear_bwd_plain(src, flow, g, want_dsrc, d0)
                pairs = [("d_flow", d_flow, p_flow)] + ([("d_src", d_src, p_src)] if want_dsrc
                                                        else [])
                line = f"{label}: K2 {err2:.3e} (tol {tol2:.3e})"
                for name, a, b in pairs:
                    err, tol = float((a - b).abs().max()), BWD_TOL * float(b.abs().max())
                    require(bool(torch.isfinite(a).all()) and err <= tol,
                            f"K5 {label}: {name} max abs err {err} > {tol}")
                    res["K5 origin"]["err"] = max(res["K5 origin"]["err"], err)
                    line += f", K5 {name} {err:.3e} (tol {tol:.3e})"
                res["K2 origin"]["err"] = max(res["K2 origin"]["err"], err2)
                if want_dsrc and c > 3 and fname.startswith("smooth") and rank == 1:
                    sb, gb = src.bfloat16(), g.bfloat16()
                    bf16_err(warp3d_trilinear(sb, flow, d0), warp3d_trilinear_plain(sb, flow, d0),
                             f"bf16 K2 {label}")
                    b_src, b_flow = warp3d_trilinear_bwd(sb, flow, gb, True, d0)
                    pb_src, pb_flow = warp3d_trilinear_bwd_plain(sb, flow, gb, True, d0)
                    bf16_err(b_src, pb_src, f"bf16 K5 d_src {label}")
                    e, t = float((b_flow - pb_flow).abs().max()), BWD_TOL * float(pb_flow.abs().max())
                    require(e <= t, f"bf16 K5 d_flow {label}: {e} > {t}")
                    line += "; bf16 K2, K5 within 2 ulps"
                if rank == SP_SHARDS - 1 and fname.startswith("smooth"):
                    vox = int(np.prod(local))
                    src_vox = reach_slices(flow, d0, full[0]) * int(np.prod(full[1:]))
                    for key, fn, plain_fn, lib_g, work in (
                            ("K2 origin", lambda: warp3d_trilinear(src, flow, d0),
                             lambda: warp3d_trilinear_plain(src, flow, d0), None,
                             warp_work("K2", src_vox, vox, c, 4)),
                            ("K5 origin", lambda: warp3d_trilinear_bwd(src, flow, g, want_dsrc, d0),
                             lambda: warp3d_trilinear_bwd_plain(src, flow, g, want_dsrc, d0), g,
                             warp_work("K5", src_vox, vox, c, 4, want_dsrc))):
                        t, tp, dev = event_ms(fn, 10), event_ms(plain_fn, 3), device_ms(fn)
                        lib = library_warp_ms(src, flow, lib_g, want_dsrc, d0=d0)
                        lib_dev = library_warp_ms(src, flow, lib_g, want_dsrc, timer=device_ms,
                                                  d0=d0)
                        r = res[key]
                        r["ms"] += t
                        r["plain_ms"] += tp
                        r["device_ms"] += dev
                        r["library_ms"] += lib or 0.0
                        r["library_device_ms"] += lib_dev or 0.0
                        r["work"] += work
                        r["by_shape"][shape_label(c, local, f" src {full[0]}" + (
                            "" if want_dsrc or key == "K2 origin" else " without d_src"))] = {
                            "ms": t, "device_ms": dev, "library_ms": lib,
                            "library_device_ms": lib_dev, "bound_ms": bound(*work)[0]}
                        line += (f"; {key} {t:.4f} ms, device {dev:.4f} (plain {tp:.4f}, "
                                 f"F.grid_sample{' backward' * (key == 'K5 origin')} "
                                 f"{fmt_ms(lib)}, device {fmt_ms(lib_dev)}, bound "
                                 f"{bound(*work)[0]:.4f})")
                print(line, flush=True)
        del src
        torch.cuda.empty_cache()
    return res


def mode_counts() -> dict:
    """The halo-k and D-origin launches since the last reset."""
    from smilecode_tpu_torch.kernels.modet_attn import (
        modet_attention,
        modet_attention_bwd_dk,
        modet_attention_bwd_dq,
    )
    from smilecode_tpu_torch.kernels.warp3d import warp3d_trilinear, warp3d_trilinear_bwd

    return {"K1 halo": modet_attention.launches_halo, "K3 halo": modet_attention_bwd_dq.launches_halo,
            "K4 halo": modet_attention_bwd_dk.launches_halo,
            "K2 origin": warp3d_trilinear.launches_origin,
            "K5 origin": warp3d_trilinear_bwd.launches_origin,
            "K5 origin d_src": warp3d_trilinear_bwd.scatters_origin}


def rank_counts(record) -> dict:
    """A rank record's (`train.main(rank_record=)`) counters under the names
    of `launch_counts` and `mode_counts`."""
    lc = record["launches"]
    names = {"K1": "K1", "K2": "K2", "K3": "K3", "K4": "K4", "K5": "K5"}
    out = {k: lc[f"{v} launches"] for k, v in names.items()}
    out["K5 d_src"] = lc["K5 scatters"]
    out.update({f"{k} halo": lc[f"{k} launches_halo"] for k in ("K1", "K3", "K4")})
    out.update({"K2 origin": lc["K2 launches_origin"], "K5 origin": lc["K5 launches_origin"],
                "K5 origin d_src": lc["K5 scatters_origin"]})
    return out


def compare_grads(what, grads, ref):
    """Phase 9's gates between two gradient dicts {name: array}: each within
    STEP_GRAD_TOL of the reference's largest magnitude plus STEP_GRAD_FLOOR
    of the model's largest. Returns the worst err/tol."""
    gmax = max(float(np.abs(v).max()) for v in ref.values())
    worst, where = 0.0, ""
    for name, r in ref.items():
        g = np.asarray(grads[name])
        require(bool(np.isfinite(g).all()), f"{what}: gradient {name} not finite")
        ratio = float(np.abs(g - r).max()) / (STEP_GRAD_TOL * float(np.abs(r).max())
                                               + STEP_GRAD_FLOOR * gmax)
        if ratio > worst:
            worst, where = ratio, name
    print(f"{what}: worst gradient err/tol {worst:.4f} ({where})", flush=True)
    require(worst <= 1.0, f"{what}: gradient {where} err/tol {worst:.3f} > 1")
    return worst


def reference_step(cfg, device, batch_size):
    """The single-process loss and gradients of `train.main`'s model for
    ``cfg`` (same seed) on its first training batch of ``batch_size`` pairs
    (same Loader order)."""
    import torch

    from smilecode_tpu_torch import train
    from smilecode_tpu_torch.data import Loader
    from smilecode_tpu_torch.models.registry import build_model, loss_plan

    model = build_model(cfg.model, cfg, device=device,
                        generator=torch.Generator().manual_seed(cfg.seed))
    train_set, _ = train._datasets(cfg)
    x, y = next(iter(Loader(train_set, batch_size=batch_size, shuffle=True, seed=cfg.seed,
                            num_workers=0, device=device)))
    loss, _ = train.make_loss_and_grads(model, loss_plan(cfg.model, cfg), list(cfg.weights))(x, y)
    return float(loss), {n: p.grad.cpu().numpy() for n, p in model.named_parameters()}


def run_multi_rank_train(card, device, data_dir, root, **kw):
    """`train.main` with ``kw`` (dp, spatial, batch_size, max_epoch) on the
    2 subjects of ``data_dir`` (validated on the same 2 pairs); returns the
    config, the rank records and the seconds."""
    import torch

    from smilecode_tpu_torch import train
    from smilecode_tpu_torch.config import TrainConfig

    cfg = TrainConfig(train_dir=data_dir, val_dir=data_dir, save_root=os.path.join(root, "exp"),
                      log_root=os.path.join(root, "logs"), num_workers=0, **kw)
    records = []
    t0 = time.perf_counter()
    best = train.main(cfg, rank_record=records)
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    require(len(records) == cfg.dp * cfg.spatial and records[0]["best_dsc"] == best,
            f"train.main returned {len(records)} rank records")
    for r, rec in enumerate(records):
        print(f"[{card}] rank {r}: losses {rec['losses']}, host ms per step "
              f"{[round(t, 3) for t in rec['step_ms']]} (the first with warm-up), peak "
              f"{rec['peak_gib']:.2f} GiB, launches {rank_counts(rec)}", flush=True)
        require(bool(np.isfinite(rec["losses"]).all()), f"rank {r}: losses {rec['losses']}")
    return cfg, records, seconds


def run_dp_phase(card, device, tmp, data_dir):
    """Phase 31: `train.main(dp=2)` at 160x192x160, batch 2, float32, two
    ranks on the one card (gloo, CUDA tensors): 2 epochs of 1 step (2
    subjects, 2 ordered pairs), rank 0 validating 2 pairs per epoch. Every
    rank launches exactly K1 5, K3 5, K4 5, K2 9, K5 9 (8 scatters) per step
    and no halo-k or D-origin kernel, rank 0 also 5 K1 and 9 K2 per
    validation pair; the first step's loss and averaged gradients equal the
    single-process batch-2 step's (phase 9's gates); the parameters after
    the two steps are the same bits on both ranks."""
    from smilecode_tpu_torch.config import TrainConfig

    n_steps, n_val = 2, 2 * 2
    cfg, records, secs = run_multi_rank_train(card, device, data_dir, os.path.join(tmp, "dp"),
                                              dp=2, batch_size=2, max_epoch=2)
    per_step = {"K1": 5, "K3": 5, "K4": 5, "K2": 9, "K5": 9, "K5 d_src": 8}
    for r, rec in enumerate(records):
        want = {k: v * n_steps for k, v in per_step.items()}
        if r == 0:
            want["K1"] += 5 * n_val
            want["K2"] += 9 * n_val
        want.update({k: 0 for k in ("K1 halo", "K3 halo", "K4 halo", "K2 origin", "K5 origin",
                                    "K5 origin d_src")})
        require(rank_counts(rec) == want, f"dp rank {r}: launches {rank_counts(rec)}, expected {want}")
    for name, p in records[0]["params"].items():
        require(np.array_equal(p, records[1]["params"][name]),
                f"dp: parameter {name} differs between the ranks after {n_steps} steps")
    loss, grads = reference_step(TrainConfig(**{**cfg.__dict__, "dp": 1}), device, 2)
    print(f"[{card}] train.main(dp=2) in {secs:.2f} s: first loss {records[0]['losses'][0]:.7f}, "
          f"single-process batch-2 step {loss:.7f}", flush=True)
    require(abs(records[0]["losses"][0] - loss) <= STEP_LOSS_TOL * abs(loss),
            f"dp first loss {records[0]['losses'][0]} vs single-process {loss}")
    compare_grads("dp=2 step vs the single-process batch-2 step", records[0]["first_grads"], grads)
    return records


def spatial_rank(mesh, data_dir, n_timed):
    """One rank of phase 32's sharded forward and steps: the seeded ModeT on
    the first pair of ``data_dir``, this rank's D slab. Returns the slabs of
    the forward's flow and moved image, the launches of one sharded
    loss-and-gradients pass, its loss and gradients, host ms of
    ``n_timed`` sharded training steps and the peak GiB; rank 0 prints a
    profile of one step (the device's idle share: the collectives' host
    staging)."""
    import torch

    from smilecode_tpu_torch.optim import AMSGrad
    from smilecode_tpu_torch.parallel.losses_sp import (
        make_spatial_loss_and_grads,
        make_train_step_spatial,
    )
    from smilecode_tpu_torch.parallel.mesh import shard_batch
    from smilecode_tpu_torch.parallel.modet_sp import modet_forward_spatial

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = seeded_model(mesh.device).train()
    x, y = shard_batch(mesh, forward_pair(data_dir, mesh.device))
    with torch.no_grad():
        moved, flow = modet_forward_spatial(model, x, y, mesh)
    reset_launch_counts()
    loss, _ = make_spatial_loss_and_grads(model, mesh)(x, y)
    torch.cuda.synchronize()
    counts = {**launch_counts(), **mode_counts()}
    grads = {n: p.grad.cpu().numpy() for n, p in model.named_parameters()}
    step = make_train_step_spatial(model, AMSGrad(model.parameters(), lr=1e-4), (1.0, 1.0), mesh)
    step(x, y)  # warm-up
    if mesh.rank == 0:  # both ranks step: the collectives pair them
        profile_step(step, x, y, what=f"spatial={mesh.spatial} step (rank 0)")
    else:
        step(x, y)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"moved": moved.cpu(), "flow": flow.cpu(), "counts": counts, "loss": float(loss),
            "grads": grads, "ms": times, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def run_spatial_phase(card, device, tmp, data_dir):
    """Phase 32: the spatial=2 ModeT step at 160x192x160, float32, two ranks
    on the card. (a) `train.main(spatial=2)`, 1 epoch of 2 steps: every rank
    launches exactly K1/K3/K4 5 each in halo-k mode and K2/K5 9 each in
    D-origin mode (8 scatters) per step, and no other kernel but rank 0's
    validation forwards (5 K1, 9 K2 per pair); its first loss within
    STEP_LOSS_TOL of the unsharded step's. (b) The seeded model's sharded
    forward and loss-and-gradients pass against the unsharded ones: flow
    within FLOW_TOL voxel, moved image within MOVED_TOL, the loss and every
    gradient at phase 9's gates, exactly one step's launches, all in the
    two modes; ms per sharded step and per-rank peak GiB beside the
    unsharded step's. Returns the rank records of (a)."""
    import torch

    from smilecode_tpu_torch.config import TrainConfig
    from smilecode_tpu_torch.models.registry import loss_plan
    from smilecode_tpu_torch.parallel.mesh import run_ranks
    from smilecode_tpu_torch.train import make_loss_and_grads

    n_steps, n_val = 2, 2
    cfg, records, secs = run_multi_rank_train(card, device, data_dir, os.path.join(tmp, "sp"),
                                              spatial=2, max_epoch=1)
    sp_step = {"K1": 5, "K3": 5, "K4": 5, "K2": 9, "K5": 9, "K5 d_src": 8, "K1 halo": 5,
               "K3 halo": 5, "K4 halo": 5, "K2 origin": 9, "K5 origin": 9, "K5 origin d_src": 8}
    for r, rec in enumerate(records):
        want = {k: v * n_steps for k, v in sp_step.items()}
        if r == 0:
            want["K1"] += 5 * n_val
            want["K2"] += 9 * n_val
        require(rank_counts(rec) == want,
                f"spatial rank {r}: launches {rank_counts(rec)}, expected {want}")
    loss, _ = reference_step(TrainConfig(**{**cfg.__dict__, "spatial": 1}), device, 1)
    print(f"[{card}] train.main(spatial=2) in {secs:.2f} s: first loss "
          f"{records[0]['losses'][0]:.7f}, unsharded {loss:.7f}", flush=True)
    require(abs(records[0]["losses"][0] - loss) <= STEP_LOSS_TOL * abs(loss),
            f"spatial first loss {records[0]['losses'][0]} vs unsharded {loss}")
    torch.cuda.empty_cache()

    ranks = run_ranks(spatial_rank, 1, SP_SHARDS, "cuda", args=(data_dir, N_TIMED_SP))
    model = seeded_model(device).train()
    x, y = forward_pair(data_dir, device)
    with torch.no_grad():
        moved, flow = model(x, y)
    s_flow = torch.cat([r["flow"] for r in ranks], 1).to(device)
    s_moved = torch.cat([r["moved"] for r in ranks], 1).to(device)
    flow_err = float((s_flow - flow).abs().max())
    moved_err = float((s_moved - moved).abs().max())
    print(f"[{card}] spatial=2 forward vs unsharded: flow max |.| {float(flow.abs().max()):.4f} "
          f"voxel, flow max abs diff {flow_err:.3e}, moved {moved_err:.3e}", flush=True)
    require(flow_err <= FLOW_TOL and moved_err <= MOVED_TOL,
            f"spatial forward: flow {flow_err} > {FLOW_TOL} or moved {moved_err} > {MOVED_TOL}")
    want = {k: 0 for k in launch_counts()}
    want.update(sp_step)
    for r, rank in enumerate(ranks):
        require(rank["counts"] == want, f"spatial pass rank {r}: {rank['counts']}, expected {want}")
    del moved, flow, s_flow, s_moved
    u_loss, _ = make_loss_and_grads(model, loss_plan("modet"), (1.0, 1.0))(x, y)
    u_grads = {n: p.grad.cpu().numpy() for n, p in model.named_parameters()}
    times, peak, _ = time_steps({"unsharded": model}, x, y, n=N_TIMED_SP)
    print(f"[{card}] spatial=2 loss {ranks[0]['loss']:.7f}, unsharded {float(u_loss):.7f}",
          flush=True)
    require(ranks[0]["loss"] == ranks[1]["loss"], "spatial ranks disagree on the loss")
    require(abs(ranks[0]["loss"] - float(u_loss)) <= STEP_LOSS_TOL * abs(float(u_loss)),
            f"spatial loss {ranks[0]['loss']} vs unsharded {float(u_loss)}")
    compare_grads("spatial=2 step vs the unsharded step", ranks[0]["grads"], u_grads)
    print(f"[{card}] ModeT 160x192x160 training step, spatial=2 on one card (2 ranks, gloo), "
          f"median of {N_TIMED_SP}: " + ", ".join(
              f"rank {r} {statistics.median(rk['ms']):.3f} ms (peak {rk['peak_gib']:.2f} GiB)"
              for r, rk in enumerate(ranks))
          + f"; unsharded {statistics.median(times['unsharded']):.3f} ms (peak "
            f"{peak['unsharded']:.2f} GiB)", flush=True)
    del model, x, y
    torch.cuda.empty_cache()
    return records


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this runs on the card")
    from smilecode_tpu_torch.kernels import _build

    t_start = time.perf_counter()
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

    phase(1, "K1 attention vs plain")
    k1_err, k1_ms, k1_plain_ms, k1_work, k1_dev, k1_shapes = check_attention(device)
    phase(2, "K2 warp vs plain")
    k2_err, k2_ms, k2_plain_ms, k2_lib_ms, k2_work, k2_shapes = check_warp(device)

    phase(3, "infer.main on synthetic 160x192x160 pairs")
    n_pairs = N_SUBJECTS * (N_SUBJECTS - 1)
    with tempfile.TemporaryDirectory(prefix="smilecode_smoke_") as tmp:
        test_dir, model_dir = os.path.join(tmp, "Test"), os.path.join(tmp, "exp")
        os.makedirs(test_dir)
        write_subjects(test_dir, device=device)
        model = seeded_model(device)
        write_jax_checkpoint(model_dir, model)
        dsc, fold, counts, secs = run_infer(test_dir, model_dir)
        n_k1, n_k2 = counts["K1"], counts["K2"]
        print(f"infer (kernels): {n_pairs} pairs in {secs:.2f} s, K1 launches {n_k1}, "
              f"K2 launches {n_k2}, dsc {dsc:.6f}, fold {fold:.6f}", flush=True)
        require(np.isfinite(dsc) and 0.0 <= dsc <= 1.0, f"Dice {dsc} outside [0, 1]")
        require(np.isfinite(fold) and 0.0 <= fold <= 1.0, f"fold {fold} outside [0, 1]")
        require(n_k1 == 5 * n_pairs, f"K1 launched {n_k1} times, expected {5 * n_pairs}")
        require(n_k2 == 9 * n_pairs, f"K2 launched {n_k2} times, expected {9 * n_pairs}")
        p_dsc, p_fold, counts, p_secs = run_infer(test_dir, model_dir, attn_impl="plain")
        p_k1, p_k2 = counts["K1"], counts["K2"]
        print(f"infer (plain): {n_pairs} pairs in {p_secs:.2f} s, K1 launches {p_k1}, "
              f"K2 launches {p_k2}, dsc {p_dsc:.6f}, fold {p_fold:.6f}", flush=True)
        require(p_k1 == 0 and p_k2 == 0, "the plain run launched a kernel")
        require(abs(dsc - p_dsc) <= 1e-3 and abs(fold - p_fold) <= 1e-3,
                f"kernels vs plain infer: dsc {dsc} vs {p_dsc}, fold {fold} vs {p_fold}")
        f32_infer = (dsc, fold)

        phase(4, "full forward, kernels vs plain")
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

        phase(5, "ms per pair (forward only)")
        times, peak = time_forwards({"kernels": model, "plain": plain}, x, y)
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"[{card}] ModeT 160x192x160 forward, median of {N_TIMED}: "
              f"kernels {med['kernels']:.3f} ms/pair, plain {med['plain']:.3f} ms/pair "
              f"(min {min(times['kernels']):.3f} / {min(times['plain']):.3f})")
        print(f"[{card}] per pair: K1 {k1_ms:.4f} ms, device {k1_dev:.4f} (plain {k1_plain_ms:.4f}), "
              f"K2 {k2_ms:.4f} ms (plain {k2_plain_ms:.4f}); "
              f"peak memory kernels {peak['kernels']:.2f} GiB, plain {peak['plain']:.2f} GiB")
        del moved, flow, p_moved, p_flow
        torch.cuda.empty_cache()

        phase(6, "K3/K4 attention backward vs plain")
        bwd = check_attention_bwd(device)
        phase(7, "K5 warp adjoint vs plain")
        k5_err, k5_ms, k5_plain_ms, k5_lib_ms, k5_work, k5_shapes = check_warp_bwd(device)

        phase(8, "train.main on synthetic 160x192x160 subjects")
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
        want.update({f"{k} bf16": 0 for k in want})
        require(train_counts == want, f"train launches {train_counts}, expected {want}")
        dsc, fold, counts, secs = run_infer(val_dir, exp_dir)
        n_k1, n_k2 = counts["K1"], counts["K2"]
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

        phase(9, "one training step, kernels vs plain")
        loss, p_loss, _ = compare_step_grads(model, plain, x, y)
        require(abs(loss - p_loss) <= STEP_LOSS_TOL * abs(p_loss),
                f"step loss, kernels vs plain: {loss} vs {p_loss}")

        phase(10, "ms per training step")
        times, peak, steps = time_steps({"kernels": model, "plain": plain}, x, y)
        kernel_step = steps["kernels"]
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"[{card}] ModeT 160x192x160 training step (fwd + bwd + AMSGrad), median of "
              f"{N_TIMED_STEPS}: kernels {med['kernels']:.3f} ms, plain {med['plain']:.3f} ms "
              f"(min {min(times['kernels']):.3f} / {min(times['plain']):.3f}); peak memory "
              f"kernels {peak['kernels']:.2f} GiB, plain {peak['plain']:.2f} GiB")
        print(f"[{card}] backward kernels per step: K3 {bwd['K3'][1]:.4f} ms, device "
              f"{bwd['K3'][4]:.4f} (plain {bwd['K3'][2]:.4f}), K4 {bwd['K4'][1]:.4f} ms, device "
              f"{bwd['K4'][4]:.4f} (plain {bwd['K4'][2]:.4f}), "
              f"K5 {k5_ms:.4f} ms (plain {k5_plain_ms:.4f})")
        profile_step(kernel_step, x, y)
        del model, plain, kernel_step, steps, x, y
        torch.cuda.empty_cache()

        phase(11, "K1 as Im2grid runs it (1 head, no rpb); K3/K4 without rpb")
        g_err, g_ms, g_plain_ms, g_work, g_dev, g_shapes = check_attention(
            device, num_heads=(1,) * 5, with_rpb=False)
        check_attention_bwd(device, specs=((1, 1),), with_rpb=False)
        phase(12, "K2 through kernel F's entries at the baselines' shapes")
        f_err, f_ms, f_plain_ms, f_lib_ms, f_work, f_shapes = check_warp_f(device)

        phase(13, "infer.main for the baselines")
        rcn_dir = os.path.join(tmp, "TestRCN")
        os.makedirs(rcn_dir)
        write_subjects(rcn_dir, size=RCN_SIZE, device=device)
        base_counts = {"K1": 0, "K2": 0}
        for name, size, k1_pair, k2_pair in BASELINES:
            counts = serve_baseline(name, size, test_dir if size == SIZE else rcn_dir,
                                    os.path.join(tmp, f"exp_{name}"), device, k1_pair, k2_pair,
                                    n_pairs)
            base_counts["K1"] += counts["K1"]
            base_counts["K2"] += counts["K2"]

        phase(14, "baseline forwards, kernels vs plain; ms per pair")
        for name, size, _, _ in BASELINES:
            compare_baseline_forward(card, name, size, test_dir if size == SIZE else rcn_dir,
                                     device)
        print(f"[{card}] K1 as Im2grid runs it, per pair: {g_ms:.4f} ms, device {g_dev:.4f} "
              f"(plain {g_plain_ms:.4f}); "
              f"K2 via ops.warp over the smooth cases of phase 12: {f_ms:.4f} ms (plain "
              f"{f_plain_ms:.4f})")

        bf16, bf16_train_counts = run_bf16_phases(card, device, tmp, test_dir, val_dir, f32_infer)
        zoo_warps, zoo_bwd, zoo_counts, im2grid_counts = run_zoo_phases(card, device, tmp, val_dir)

        phase(25, "P1-P4: the probe scripts' checks, edge cases and one volume's size, vs plain")
        probe_recs = run_probe_phase(card, device)
        phase(26, "RDN's MC-dropout uncertainty protocol through infer.main")
        run_mc_phase(card, device, tmp, val_dir)
        phase(27, "train.main and infer.main with dataset=half and dataset=atlas")
        run_dataset_phase(card, device, tmp, val_dir)

        phase(28, "the extended losses at 160x192x160: float32 value and gradient vs float64")
        run_loss_phase(card, device)
        phase(29, "Analyze subjects -> make_pkl_dataset -> native vs numpy -> infer.main; a trace")
        run_data_tools_phase(card, device, tmp, model_dir)

        phase(30, "halo-k K1/K3/K4 and D-origin K2/K5 vs plain at the spatial=2 slabs")
        modes = {**check_halo_attention(device), **check_origin_warps(device)}
        for key, r in modes.items():
            print(f"[{card}] {key} per spatial=2 step (rank 1's slabs): {r['ms']:.4f} ms, device "
                  f"{r['device_ms']:.4f} (plain {r['plain_ms']:.4f}"
                  + (f", F.grid_sample{' backward' * key.startswith('K5')} {r['library_ms']:.4f}"
                     f", device {r['library_device_ms']:.4f}" if "library_ms" in r else "")
                  + f"); bound {bound(*r['work'])[0]:.4f} ms; max_abs_err {r['err']:.3e}",
                  flush=True)
        phase(31, "train.main(dp=2): two ranks on the card vs the single-process batch-2 step")
        run_dp_phase(card, device, tmp, val_dir)
        phase(32, "the spatial=2 ModeT step: train.main(spatial=2), the sharded step vs unsharded")
        sp_counts = rank_counts(run_spatial_phase(card, device, tmp, val_dir)[0])

    def entry(name, source, line, key, err, ms, plain_ms, work, library_ms=None, counts=None,
              by_shape=None, device=None):
        bound_ms, bound_by = bound(*work)
        rec = {"name": name, "route": "cuda", "source": f"smilecode_tpu_torch/csrc/{source}",
               "replaces": f"smilecode_tpu/kernels/{line}",
               "launches": (counts or train_counts)[key],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms}
        if device is not None:  # device ms over the path's calls
            rec["device_ms"] = device
        if by_shape:  # per distinct shape, ms per call; K2, K5 also the path it took
            fields = dict.fromkeys(f for v in by_shape.values() for f in v)
            for field in fields:
                rec[f"{field}_by_shape"] = {k: v[field] for k, v in by_shape.items()}
            host = {k: v["device_ms"].host_us for k, v in by_shape.items()
                    if isinstance(v.get("device_ms"), DeviceMs)}
            if host:  # the host's us per call while device_ms queued the kernel's calls
                rec["host_us_by_shape"] = host
                rec["host_us"] = float(np.mean(list(host.values())))
        return rec

    def bf16_entry(name, source, line, key):
        r = bf16[key]
        return entry(f"{name} (bf16)", source, line, f"{key} bf16", r["err"], r["ms"],
                     r["plain_ms"], tuple(r["work"]), r["library_ms"], bf16_train_counts,
                     r["by_shape"], r["device_ms"])

    def bwd_entry(name, line, key, res=None, counts=None):
        err, ms, plain_ms, work, device, by_shape = (res or bwd)[key]
        return entry(name, "modet_attn_bwd.cu", line, key, err, ms, plain_ms, work,
                     counts=counts, by_shape=by_shape, device=device)

    def zoo_entry(name, source, line, key):
        r = zoo_warps[key]
        return entry(name, source, line, key, r["err"], r["ms"], r["plain_ms"], tuple(r["work"]),
                     r["library_ms"], zoo_counts, r["by_shape"])

    def mode_entry(name, source, line, key):
        """The five kernel modes of the D-sharded step: phase 30's times,
        rank 0's launches in phase 32's train.main(spatial=2)."""
        r = modes[key]
        rec = entry(name, source, line, key, r["err"], r["ms"], r["plain_ms"], tuple(r["work"]),
                    r.get("library_ms"), sp_counts, r["by_shape"], r["device_ms"])
        if "library_device_ms" in r:  # over the path's calls, as device_ms
            rec["library_device_ms"] = r["library_device_ms"]
        return rec

    def probe_entry(kernel, r):
        """P1-P4: ms per call over the scripts' runs (P2's library call over
        its by-value runs, ``library_runs``; P2 and P4 also ``sized``, the
        160x192x160 case); they replace the root probe scripts' kernels
        (``serves``), not the package's."""
        bound_ms, bound_by = bound(*r["work"])
        rec = {"name": f"{PROBE_NAMES[kernel]} ({kernel})", "route": "cuda",
               "source": "smilecode_tpu_torch/csrc/probes.cu", "replaces": r["serves"][0],
               "launches": r["launches"], "max_abs_err": r["err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": r["library_ms"], "device_ms": r["device_ms"], "host_us": r["host_us"],
               "serves": r["serves"], "launch_floor": r["launch_floor"]}
        for key in ("library_device_ms", "library_pair_ms", "library_runs", "ms_library_runs",
                    "sized", "launch_stages_ns"):
            if r.get(key) is not None:
                rec[key] = r[key]
        return rec

    record = {"kernels": [
        entry("modet_attn_fwd", "modet_attn.cu", "modet_attn.py:56", "K1", k1_err, k1_ms,
              k1_plain_ms, k1_work, by_shape=k1_shapes, device=k1_dev),
        entry("warp3d_trilinear_fwd", "warp3d.cu", "warp3d_v4.py:104", "K2", k2_err, k2_ms,
              k2_plain_ms, k2_work, k2_lib_ms, by_shape=k2_shapes,
              device=warp_path_device_ms(k2_shapes)),
        bwd_entry("modet_attn_bwd_dq", "modet_attn.py:183", "K3"),
        bwd_entry("modet_attn_bwd_dk", "modet_attn.py:256", "K4"),
        entry("warp3d_trilinear_bwd", "warp3d_bwd.cu", "warp3d_v4.py:339", "K5", k5_err, k5_ms,
              k5_plain_ms, k5_work, k5_lib_ms, by_shape=k5_shapes,
              device=warp_path_device_ms(k5_shapes, bwd=True)),
        entry("modet_attn_fwd (Im2grid: 1 head, no rpb)", "modet_attn.cu", "modet_attn.py:56",
              "K1", g_err, g_ms, g_plain_ms, g_work, None, base_counts, g_shapes, g_dev),
        entry("warp3d_trilinear_fwd (ops.warp impl=pallas|guarded, baselines)", "warp3d.cu",
              "warp3d.py:52", "K2", f_err, f_ms, f_plain_ms, f_work, f_lib_ms, base_counts,
              f_shapes),
        bf16_entry("modet_attn_fwd", "modet_attn.cu", "modet_attn.py:56", "K1"),
        bf16_entry("warp3d_trilinear_fwd", "warp3d.cu", "warp3d_v4.py:104", "K2"),
        bf16_entry("modet_attn_bwd_dq", "modet_attn_bwd.cu", "modet_attn.py:183", "K3"),
        bf16_entry("modet_attn_bwd_dk", "modet_attn_bwd.cu", "modet_attn.py:256", "K4"),
        bf16_entry("warp3d_trilinear_bwd", "warp3d_bwd.cu", "warp3d_v4.py:339", "K5"),
        bwd_entry("modet_attn_bwd_dq (Im2grid training: 1 head, no rpb)", "modet_attn.py:183",
                  "K3", zoo_bwd, im2grid_counts),
        bwd_entry("modet_attn_bwd_dk (Im2grid training: 1 head, no rpb)", "modet_attn.py:256",
                  "K4", zoo_bwd, im2grid_counts),
        zoo_entry("warp3d_trilinear_fwd (baseline zoo: phase 20 shapes, phase 23 training)",
                  "warp3d.cu", "warp3d.py:52", "K2"),
        zoo_entry("warp3d_trilinear_bwd (baseline zoo: phase 20 shapes, phase 23 training)",
                  "warp3d_bwd.cu", "warp3d_v4.py:339", "K5"),
        *(probe_entry(kernel, r) for kernel, r in probe_recs.items()),
        mode_entry("modet_attn_fwd (halo-k, spatial=2)", "modet_attn.cu", "modet_attn.py:56",
                   "K1 halo"),
        mode_entry("modet_attn_bwd_dq (halo-k, spatial=2)", "modet_attn_bwd.cu",
                   "modet_attn.py:183", "K3 halo"),
        mode_entry("modet_attn_bwd_dk (halo-k, dk of D+2 slices, spatial=2)", "modet_attn_bwd.cu",
                   "modet_attn.py:256", "K4 halo"),
        mode_entry("warp3d_trilinear_fwd (D origin, gathered source, spatial=2)", "warp3d.cu",
                   "warp3d_v4.py:104", "K2 origin"),
        mode_entry("warp3d_trilinear_bwd (D origin, gathered source, spatial=2)",
                   "warp3d_bwd.cu", "warp3d_v4.py:339", "K5 origin"),
    ]}
    for rec in record["kernels"]:
        print(f"[{card}] host us per call while its calls queued: {rec['name']} "
              + (f"{rec['host_us']:.2f}" if "host_us" in rec else "not measured"))
    print(f"phase seconds: {phase_times(t_start)}")
    print(card_line())
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
