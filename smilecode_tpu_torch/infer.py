"""Inference driver of the port (`smilecode_tpu/infer.py` protocol).

Per ordered test pair: run the model, warp x_seg with the flow (nearest),
report Dice over the 54 VOI labels (registered and raw), and the fraction of
voxels with Jacobian determinant <= 0. Prints mean +- std.

Runs on the CUDA card (``device=cuda``, the default; it raises without a
card) through the Hopper kernels, or with ``device=cpu`` on the CPU through
their plain versions. float32, with TF32 off in cuDNN convolutions and
matmuls, for parity with the JAX package; ModeT takes
``compute_dtype=bfloat16`` (its feature path in bf16, the flow float32).

Models: modet (modet-cu), im2grid, pcnet, prnet, prnetplusplus (prnet++,
prpp), vtn, rcn, rdn, rdn_share, rdn_diff, rdn_diff_share
(`models/registry.py`).

Usage: python -m smilecode_tpu_torch.infer test_dir=/data/Test model_dir=experiments/<run>
       [model=rdn stages=4 levels=4,4,4,4] [torch_checkpoint=/path/dsc0.xxx.pth.tar]
       [compute_dtype=bfloat16] [device=cpu]
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np
import torch

from smilecode_tpu_torch.config import InferConfig, apply_cli_overrides
from smilecode_tpu_torch.convert import load_torch_checkpoint, state_dict_from_jax
from smilecode_tpu_torch.data import Compose, Loader, LPBABrainInferDatasetS2S, NumpyType, Seg_norm
from smilecode_tpu_torch.metrics import dice_val_voi, fold_fraction
from smilecode_tpu_torch.models.registry import build_model
from smilecode_tpu_torch.ops.warp import warp
from smilecode_tpu_torch.utils import AverageMeter, latest_checkpoint, load_checkpoint, resolve_device


def make_infer_step(model):
    """(x, y, x_seg, y_seg) NDHWC tensors -> (dice_trans, dice_raw, fold)."""

    @torch.no_grad()
    def step(x, y, x_seg, y_seg):
        flow = model(x, y)[1]  # (moved, flow, *aux)
        def_seg = warp(x_seg.float(), flow, mode="nearest").to(torch.int32)
        dice_trans = dice_val_voi(def_seg, y_seg)
        dice_raw = dice_val_voi(x_seg, y_seg)
        fold = fold_fraction(flow[0])
        return dice_trans, dice_raw, fold

    return step


def load_weights(model, cfg: InferConfig):
    """A reference .pth.tar when ``cfg.torch_checkpoint`` is set, else the
    JAX-format checkpoint chosen by ``cfg.model_dir`` / ``cfg.model_idx``."""
    if cfg.torch_checkpoint:
        load_torch_checkpoint(cfg.torch_checkpoint, model)
        print(f"loaded torch checkpoint {cfg.torch_checkpoint}")
        return model
    ckpt_path = latest_checkpoint(cfg.model_dir, cfg.model_idx)
    if ckpt_path is None:
        raise SystemExit(f"no checkpoints in {cfg.model_dir!r}")
    state = load_checkpoint(ckpt_path)
    model.load_state_dict(state_dict_from_jax(state["params"], model), strict=True)
    print(f"loaded {ckpt_path} (epoch {state.get('epoch')}, best_dsc {state.get('best_dsc')})")
    return model


def main(cfg: InferConfig):
    if cfg.mc_iter > 0:
        raise NotImplementedError("mc_iter > 0: the MC-uncertainty protocol is not ported yet "
                                  "(ROADMAP.md queue 1, item 9a)")
    if cfg.dataset != "s2s":
        raise NotImplementedError(f"dataset={cfg.dataset!r} is not ported yet "
                                  "(ROADMAP.md queue 1, item 5)")
    device = resolve_device(cfg.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = load_weights(build_model(cfg.model, cfg, device=device), cfg).eval()

    test_composed = Compose([Seg_norm(), NumpyType((np.float32, np.int16))])
    test_paths = sorted(glob.glob(os.path.join(cfg.test_dir, "*.pkl")))
    test_set = LPBABrainInferDatasetS2S(test_paths, transforms=test_composed)
    loader = Loader(test_set, batch_size=1, device=device)
    step = make_infer_step(model)

    eval_dsc_def = AverageMeter()
    eval_dsc_raw = AverageMeter()
    eval_det = AverageMeter()
    for x, y, x_seg, y_seg in loader:
        dice_trans, dice_raw, fold = (float(v) for v in step(x, y, x_seg, y_seg))
        eval_dsc_def.update(dice_trans, x.shape[0])
        eval_dsc_raw.update(dice_raw, x.shape[0])
        eval_det.update(fold, x.shape[0])
        print("Trans dsc: {:.4f}, Raw dsc: {:.4f}, fold: {:.6f}".format(dice_trans, dice_raw, fold))
    print("Deformed DSC: {:.3f} +- {:.3f}, Affine DSC: {:.3f} +- {:.3f}".format(
        eval_dsc_def.avg, eval_dsc_def.std, eval_dsc_raw.avg, eval_dsc_raw.std
    ))
    print("deformed det: {:.4f}, std: {:.4f}".format(eval_det.avg, eval_det.std))
    return eval_dsc_def.avg, eval_det.avg


if __name__ == "__main__":
    main(apply_cli_overrides(InferConfig(), sys.argv[1:]))
