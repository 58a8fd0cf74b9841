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
(`models/registry.py`). Pairs: all ordered pairs of ``test_dir``'s
subjects (``dataset=s2s``, and any other name, as the JAX driver), the
same at stride 2 (``dataset=half``), or each subject to the atlas at
``atlas_path`` (``dataset=atlas``).

With ``mc_iter > 0`` (RDN with ``dropout_rate > 0``) it runs the
MC-dropout uncertainty protocol instead (`run_mc_uncertainty`).

Usage: python -m smilecode_tpu_torch.infer test_dir=/data/Test model_dir=experiments/<run>
       [model=rdn stages=4 levels=4,4,4,4] [torch_checkpoint=/path/dsc0.xxx.pth.tar]
       [compute_dtype=bfloat16] [dataset=half | dataset=atlas atlas_path=/data/atlas.pkl]
       [model=rdn dropout_rate=0.3 mc_iter=25] [device=cpu]
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np
import torch

from smilecode_tpu_torch.config import InferConfig, apply_cli_overrides
from smilecode_tpu_torch.convert import load_torch_checkpoint, state_dict_from_jax
from smilecode_tpu_torch.data import (
    Compose,
    Loader,
    NumpyType,
    Seg_norm,
    pair_dataset,
)
from smilecode_tpu_torch.metrics import dice_val_voi, fold_fraction
from smilecode_tpu_torch.metrics_ext import get_mc_preds, uceloss, uncert_regression_gal
from smilecode_tpu_torch.models.registry import build_model
from smilecode_tpu_torch.ops.warp import warp
from smilecode_tpu_torch.utils import AverageMeter, latest_checkpoint, load_checkpoint, resolve_device
from smilecode_tpu_torch.utils.profiling import span


def make_infer_step(model):
    """(x, y, x_seg, y_seg) NDHWC tensors -> (dice_trans, dice_raw, fold).

    Spans (while a profiler records): ``infer.step`` over ``infer.forward``
    (the model) and ``infer.score`` (the nearest warp, both Dice and the
    folding fraction)."""

    @torch.no_grad()
    def step(x, y, x_seg, y_seg):
        with span("infer.step"):
            with span("infer.forward"):
                flow = model(x, y)[1]  # (moved, flow, *aux)
            with span("infer.score"):
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


def mc_pair_stats(preds: np.ndarray, y: np.ndarray):
    """The MC statistics of one pair (`smilecode_tpu/infer.py:112-122`), on
    the host: ``preds`` (N, B, D, H, W, C) float32 MC samples of the moved
    image, ``y`` the fixed image. Gal's decomposition when the samples carry
    an aleatoric channel (C > 1); else ale 0 and epi the unbiased variance
    over samples. Returns (ale, epi, uncert, err) arrays and the UCE."""
    if preds.shape[-1] > 1:
        ale, epi, uncert = uncert_regression_gal(preds, reduction=None)
        pred_mean = preds[..., :-1].mean(axis=0)
    else:
        ale = np.zeros_like(preds[0])
        epi = preds.var(axis=0, ddof=1).mean(axis=-1, keepdims=True)
        uncert = ale + epi
        pred_mean = preds.mean(axis=0)
    err = (pred_mean[..., : uncert.shape[-1]] - y) ** 2
    uce, _, _, _ = uceloss(err, uncert)
    return ale, epi, uncert, err, uce


def run_mc_uncertainty(model, loader, cfg: InferConfig, device: torch.device, record=None):
    """MC-dropout uncertainty protocol (`smilecode_tpu/infer.py:
    run_mc_uncertainty`, `RDN/utils.py:377-504`): ``cfg.mc_iter`` stochastic
    forwards per pair, their dropout masks drawn from one
    ``torch.Generator`` on ``device`` seeded 24 (one stream across all
    pairs, the counterpart of JAX's ``PRNGKey(24)``), then `mc_pair_stats`
    on the moved images. Prints per pair and the means; returns (mean UCE,
    mean epi). A list passed as ``record`` gets, per pair, the stack of MC
    samples and its `mc_pair_stats`.

    The moved image has one channel, so the aleatoric term is zero and the
    uncertainty is the epistemic MC variance alone, as in the JAX package.
    """

    def apply_fn(moving, fixed, generator):
        return model(moving, fixed, generator=generator)[:2]

    meters = {k: AverageMeter() for k in ("ale", "epi", "uncert", "uce", "err")}
    generator = torch.Generator(device=device).manual_seed(24)
    for i, batch in enumerate(loader):
        x, y = batch[0], batch[1]
        img_list, _ = get_mc_preds(apply_fn, x, y, mc_iter=cfg.mc_iter, generator=generator)
        preds = np.stack(img_list, axis=0)
        ale, epi, uncert, err, uce = mc_pair_stats(preds, y.cpu().numpy())
        if record is not None:
            record.append((preds, (ale, epi, uncert, err, uce)))
        means = {"ale": float(np.mean(ale)), "epi": float(np.mean(epi)),
                 "uncert": float(np.mean(uncert)), "err": float(np.mean(err)), "uce": uce}
        for k, v in means.items():
            meters[k].update(v)
        print("pair {}: ale {:.6f}, epi {:.6f}, uncert {:.6f}, err {:.6f}, UCE {:.6f}".format(
            i, means["ale"], means["epi"], means["uncert"], means["err"], uce))
    print("MC uncertainty ({} samples): ale {:.6f} +- {:.6f}, epi {:.6f} +- {:.6f}, "
          "UCE {:.6f} +- {:.6f}".format(
              cfg.mc_iter, meters["ale"].avg, meters["ale"].std, meters["epi"].avg,
              meters["epi"].std, meters["uce"].avg, meters["uce"].std))
    return meters["uce"].avg, meters["epi"].avg


def main(cfg: InferConfig, mc_record=None):
    """The protocol above; ``mc_record`` is `run_mc_uncertainty`'s
    ``record``."""
    if cfg.mc_iter > 0 and cfg.dropout_rate <= 0:
        raise SystemExit("mc_iter > 0 requires dropout_rate > 0 "
                         "(a deterministic net has zero MC variance)")
    device = resolve_device(cfg.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = load_weights(build_model(cfg.model, cfg, device=device), cfg).eval()

    test_composed = Compose([Seg_norm(), NumpyType((np.float32, np.int16))])
    test_paths = sorted(glob.glob(os.path.join(cfg.test_dir, "*.pkl")))
    test_set = pair_dataset(cfg.dataset, test_paths, test_composed, True, cfg.atlas_path)
    loader = Loader(test_set, batch_size=1, device=device)
    if cfg.mc_iter > 0:
        return run_mc_uncertainty(model, loader, cfg, device, record=mc_record)
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
