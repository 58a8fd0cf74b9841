#!/usr/bin/env python3
"""Multi-GPU smoke test of the port on four cards with NCCL.

Run from the root of a checkout on a machine with four NVIDIA cards:

    python3 multi_gpu_smoke.py

`chip_smoke.py` runs the multi-GPU paths with two ranks sharing one card
(gloo); this script gives each rank a card of its own, so the ranks use
NCCL (`smilecode_tpu_torch/parallel/mesh.py`). On 2 synthetic
160x192x160 subjects (`chip_smoke.write_subjects`), float32, full-width
ModeT:

1. `train.main(dp=2, spatial=2, batch_size=2)`, 2 epochs of 1 step, on 4
   cards: per rank exactly K1/K3/K4 5 each in halo-k mode and K2/K5 9 each
   in D-origin mode (8 scatters) per step, rank 0 also its validation
   forwards; the parameters after both steps equal bit for bit on the 4
   ranks; the first loss and averaged gradients against the
   single-process batch-2 step at `chip_smoke.py` phase 9's gates.
2. `train.main(dp=2, batch_size=2)` on 2 cards: the same loss and gradient
   gates, parameters equal on both ranks.
3. The seeded ModeT's spatial=2 step on 2 cards (`chip_smoke.spatial_rank`):
   ms per step (median of 3) and peak GiB per rank beside the unsharded
   step's on one card, and rank 0's profile of one step.

Every failed check makes the exit code non-zero; without four cards it
exits non-zero before running anything.
"""

from __future__ import annotations

import os
import statistics
import sys
import tempfile

import numpy as np

import chip_smoke as cs

CARDS = 4
HALO_STEP = {"K1": 5, "K3": 5, "K4": 5, "K2": 9, "K5": 9, "K5 d_src": 8, "K1 halo": 5,
             "K3 halo": 5, "K4 halo": 5, "K2 origin": 9, "K5 origin": 9, "K5 origin d_src": 8}


def check_train(card, device, data_dir, root, **kw):
    """`chip_smoke.run_multi_rank_train` with ``kw``, 2 epochs of 1 step:
    the parameters equal on every rank, the first loss and gradients
    against the single-process batch-2 step; returns the rank records."""
    from smilecode_tpu_torch.config import TrainConfig

    cfg, records, secs = cs.run_multi_rank_train(card, device, data_dir, root, batch_size=2,
                                                 max_epoch=2, **kw)
    for name, p in records[0]["params"].items():
        for r, rec in enumerate(records[1:], 1):
            cs.require(np.array_equal(p, rec["params"][name]),
                       f"parameter {name} differs between ranks 0 and {r}")
    loss, grads = cs.reference_step(TrainConfig(**{**cfg.__dict__, "dp": 1, "spatial": 1}),
                                    device, 2)
    what = f"train.main(dp={cfg.dp}, spatial={cfg.spatial}) on {cfg.dp * cfg.spatial} cards"
    print(f"[{card}] {what} in {secs:.2f} s: first loss {records[0]['losses'][0]:.7f}, "
          f"single-process batch-2 step {loss:.7f}", flush=True)
    cs.require(abs(records[0]["losses"][0] - loss) <= cs.STEP_LOSS_TOL * abs(loss),
               f"{what}: first loss {records[0]['losses'][0]} vs {loss}")
    cs.compare_grads(f"{what} vs the single-process batch-2 step", records[0]["first_grads"],
                     grads)
    return records


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        raise SystemExit(f"multi_gpu_smoke: needs {CARDS} CUDA cards")
    from smilecode_tpu_torch.kernels import _build
    from smilecode_tpu_torch.parallel.mesh import run_ranks

    card = cs.card_line()
    print(card, f"cards {torch.cuda.device_count()}, torch {torch.__version__}", flush=True)
    device = torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    with tempfile.TemporaryDirectory(prefix="smilecode_multi_") as tmp:
        data = os.path.join(tmp, "Data")
        os.makedirs(data)
        cs.write_subjects(data, device=device, n=2, seed=7)
        n_steps, n_val = 2, 4  # 2 epochs of 1 step; 2 validation pairs per epoch
        records = check_train(card, device, data, os.path.join(tmp, "dpsp"), dp=2, spatial=2)
        for r, rec in enumerate(records):
            want = {k: v * n_steps for k, v in HALO_STEP.items()}
            if r == 0:
                want["K1"] += 5 * n_val
                want["K2"] += 9 * n_val
            cs.require(cs.rank_counts(rec) == want,
                       f"rank {r}: launches {cs.rank_counts(rec)}, expected {want}")
        torch.cuda.empty_cache()
        check_train(card, device, data, os.path.join(tmp, "dp"), dp=2)

        ranks = run_ranks(cs.spatial_rank, 1, 2, "cuda", args=(data, cs.N_TIMED_SP))
        cs.require(ranks[0]["loss"] == ranks[1]["loss"], "the spatial ranks disagree on the loss")
        model = cs.seeded_model(device).train()
        x, y = cs.forward_pair(data, device)
        times, peak, _ = cs.time_steps({"unsharded": model}, x, y, n=cs.N_TIMED_SP)
        print(f"[{card}] ModeT 160x192x160 training step, spatial=2 on 2 cards (NCCL), median "
              f"of {cs.N_TIMED_SP}: " + ", ".join(
                  f"rank {r} {statistics.median(rk['ms']):.3f} ms (peak {rk['peak_gib']:.2f} GiB)"
                  for r, rk in enumerate(ranks))
              + f"; unsharded on 1 card {statistics.median(times['unsharded']):.3f} ms (peak "
                f"{peak['unsharded']:.2f} GiB)", flush=True)
    print(card)
    print("multi_gpu_smoke: every check passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
