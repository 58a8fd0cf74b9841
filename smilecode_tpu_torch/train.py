"""Training driver of the port (`smilecode_tpu/train.py` protocol).

* AMSGrad as optax computes it (`optim.py`), poly-0.9 per-epoch learning
  rate rounded to 8 decimals;
* loss = sum criterions[n](outputs[n], fixed) * weights[n], with the model's
  loss plan (`models/registry.py`; the weights list is extended by its last
  entry, so RCN's and RDN's per-cascade or per-stage terms share the
  regulariser's weight);
* pairs: all ordered pairs of ``train_dir``'s subjects (``dataset=s2s``,
  and any other name, as the JAX driver), the same at stride 2
  (``dataset=half``), or each subject to the atlas at ``atlas_path``
  (``dataset=atlas``);
* per-epoch validation: warp x_seg with the flow (nearest), Dice over the 54
  VOI labels; checkpoint named ``dsc{:.3f}.ckpt`` in the JAX format, rolling
  keep-``max_keep``;
* stdout tee to ``<log_root>/<save_dir>/logfile.log``, per-step
  ``metrics.jsonl`` and ``losses and dice.txt``.

Runs on the CUDA card (``device=cuda``, the default; it raises without a
card): the forward and backward of the attention and the bilinear warps go
through the Hopper kernels K1-K5 (`kernels/`). With ``device=cpu`` it runs
their plain versions under torch autograd. float32, with TF32 off in cuDNN
convolutions and matmuls, for parity with the JAX package; with
``compute_dtype=bfloat16`` ModeT's feature path runs in bf16 (the kernels'
bf16 instances) while parameters, gradients, the loss, AMSGrad and the
checkpoints stay float32, so a checkpoint trained in either dtype loads
into the other. Weights are drawn from a ``torch.Generator`` seeded with
``cfg.seed`` (other numbers than JAX's from the same seed).

Every model of the registry trains: ModeT, Im2grid, PCNet, PRNet, PR++, VTN,
RCN (``n_cascade``) and the deterministic RDN variants (``stages``,
``levels``); the baselines in float32 only. The printed "Reg" is the
second criterion's loss, as in the JAX package's `train.main`.

Usage: python -m smilecode_tpu_torch.train train_dir=/data/Train val_dir=/data/Val
       [model=pcnet | model=rcn n_cascade=10 | model=rdn_diff stages=4 levels=4,4,4,4]
       [compute_dtype=bfloat16] [dataset=half | dataset=atlas atlas_path=/data/atlas.pkl]
       [device=cpu]
"""

from __future__ import annotations

import glob
import os
import sys
import time

import numpy as np
import torch

from smilecode_tpu_torch.config import TrainConfig, apply_cli_overrides, check_train_config
from smilecode_tpu_torch.convert import params_from_state_dict, state_dict_from_jax
from smilecode_tpu_torch.data import (
    Compose,
    Loader,
    NumpyType,
    Seg_norm,
    pair_dataset,
)
from smilecode_tpu_torch.metrics import dice_val_voi
from smilecode_tpu_torch.models.registry import CRITERIA, build_model, loss_plan
from smilecode_tpu_torch.ops.warp import warp
from smilecode_tpu_torch.optim import AMSGrad, poly_lr, resolve_weights
from smilecode_tpu_torch.utils import (
    AverageMeter,
    Logger,
    MetricsWriter,
    latest_checkpoint,
    load_checkpoint,
    resolve_device,
    save_checkpoint,
)

_PORT_OPT_KEYS = {"count", "mu", "nu", "nu_max"}


def make_loss_and_grads(model, plan, weights):
    """(x, y) -> (loss, per-criterion losses), with the gradients left in
    each parameter's ``.grad`` (zeroed first)."""
    criterions = [CRITERIA[c] for c in plan.criterions]
    weights = resolve_weights(weights, len(criterions))

    def loss_and_grads(x, y):
        model.zero_grad(set_to_none=True)
        outs = plan.select_train_outputs(model(x, y))
        if len(outs) < len(criterions):
            raise ValueError(f"model returned {len(outs)} train outputs for "
                             f"{len(criterions)} criterions")
        losses = [crit(outs[n], y) * w for n, (crit, w) in enumerate(zip(criterions, weights))]
        loss = sum(losses)
        loss.backward()
        return loss.detach(), tuple(v.detach() for v in losses)

    return loss_and_grads


def make_train_step(model, plan, optimizer, weights):
    """One step: forward, loss, backward, optimizer update."""
    loss_and_grads = make_loss_and_grads(model, plan, weights)

    def step(x, y):
        loss, loss_vals = loss_and_grads(x, y)
        optimizer.step()
        return loss, loss_vals

    return step


def make_eval_step(model):
    @torch.no_grad()
    def eval_step(x, y, x_seg, y_seg):
        flow = model(x, y)[1]  # (moved, flow, *aux)
        warped_seg = warp(x_seg.float(), flow, mode="nearest")
        return dice_val_voi(warped_seg.to(torch.int32), y_seg.to(torch.int32)), flow

    return eval_step


def _resume(cfg, exp_dir, model, optimizer):
    """(epoch_start, best_dsc) from the latest checkpoint of ``exp_dir``."""
    ckpt = latest_checkpoint(exp_dir)
    if not ckpt:
        return cfg.epoch_start, 0.0
    state = load_checkpoint(ckpt)
    model.load_state_dict(state_dict_from_jax(state["params"], model), strict=True)
    opt_state = state.get("opt_state")
    if isinstance(opt_state, dict) and _PORT_OPT_KEYS <= opt_state.keys():
        optimizer.load_state_by_name(model.named_parameters(), opt_state)
    else:
        # an optax state cannot be rebuilt without jax
        print(f"{ckpt}: the optimizer state is not the port's (written by the JAX "
              "package?); params, epoch and best_dsc restored, AMSGrad moments restart at 0")
    # a JAX-written checkpoint holds these as 0-d numpy arrays
    epoch_start = int(state.get("epoch", 0))
    print(f"resumed from {ckpt} at epoch {epoch_start}")
    return epoch_start, float(state.get("best_dsc", 0.0))


def main(cfg: TrainConfig):
    check_train_config(cfg)
    device = resolve_device(cfg.device)
    log_dir = os.path.join(cfg.log_root, cfg.save_dir)
    exp_dir = os.path.join(cfg.save_root, cfg.save_dir)
    os.makedirs(exp_dir, exist_ok=True)
    logger = Logger(log_dir)
    sys.stdout = logger
    metrics = MetricsWriter(log_dir)
    try:
        with open(os.path.join(log_dir, "losses and dice.txt"), "a") as f:
            return _train(cfg, device, exp_dir, metrics, f)
    finally:
        metrics.close()
        logger.close()


def _train(cfg: TrainConfig, device: torch.device, exp_dir: str, metrics: MetricsWriter, f):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(cfg.model, cfg, device=device,
                        generator=torch.Generator().manual_seed(cfg.seed))
    plan = loss_plan(cfg.model, cfg)
    n_params = sum(p.numel() for p in model.parameters())
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"model {cfg.model}: {n_params:,} params; device: {device} ({where}); "
          f"compute dtype: {cfg.compute_dtype or 'float32'}")

    optimizer = AMSGrad(model.parameters(), lr=cfg.lr)
    epoch_start, best_dsc = cfg.epoch_start, 0.0
    if cfg.cont_training:
        epoch_start, best_dsc = _resume(cfg, exp_dir, model, optimizer)

    train_composed = Compose([NumpyType((np.float32, np.float32))])
    val_composed = Compose([Seg_norm(), NumpyType((np.float32, np.int16))])
    train_paths = sorted(glob.glob(os.path.join(cfg.train_dir, "*.pkl")))
    val_paths = sorted(glob.glob(os.path.join(cfg.val_dir, "*.pkl")))
    train_set = pair_dataset(cfg.dataset, train_paths, train_composed, False, cfg.atlas_path)
    val_set = pair_dataset(cfg.dataset, val_paths, val_composed, True, cfg.atlas_path)
    train_loader = Loader(train_set, batch_size=cfg.batch_size, shuffle=True, seed=cfg.seed,
                          num_workers=cfg.num_workers, device=device)
    val_loader = Loader(val_set, batch_size=1, shuffle=False, num_workers=cfg.num_workers,
                        drop_last=True, device=device)

    train_step = make_train_step(model, plan, optimizer, list(cfg.weights))
    eval_step = make_eval_step(model)

    for epoch in range(epoch_start, cfg.max_epoch):
        print("Training Starts")
        loss_all = AverageMeter()
        lr_now = poly_lr(epoch, cfg.max_epoch, cfg.lr)
        for group in optimizer.param_groups:
            group["lr"] = lr_now
        t_epoch = time.time()
        model.train()
        for idx, (x, y) in enumerate(train_loader, 1):
            t0 = time.time()
            loss, loss_vals = train_step(x, y)
            loss = float(loss)  # waits for the step
            loss_all.update(loss, int(np.prod(y.shape)))
            step_ms = (time.time() - t0) * 1000
            print("Iter {} of {} loss {:.4f}, Img Sim: {:.6f}, Reg: {:.6f}".format(
                idx, len(train_loader), loss, float(loss_vals[0]), float(loss_vals[1])))
            metrics.write(epoch=epoch, iter=idx, loss=loss, sim=float(loss_vals[0]),
                          reg=float(loss_vals[1]), lr=lr_now, step_ms=step_ms)
        print("{} Epoch {} loss {:.4f}".format(cfg.save_dir, epoch, loss_all.avg))
        print("Epoch {} loss {:.4f}".format(epoch, loss_all.avg), file=f, end=" ")

        model.eval()
        eval_dsc = AverageMeter()
        for x, y, x_seg, y_seg in val_loader:
            dsc, _ = eval_step(x, y, x_seg, y_seg)
            eval_dsc.update(float(dsc), x.shape[0])
            print(epoch, ":", eval_dsc.avg)
        best_dsc = max(eval_dsc.avg, best_dsc)
        print(eval_dsc.avg, file=f)
        metrics.write(epoch=epoch, val_dice=eval_dsc.avg, best_dice=best_dsc,
                      epoch_s=time.time() - t_epoch)
        save_checkpoint(
            {
                "epoch": epoch + 1,
                "params": params_from_state_dict(model.state_dict(), model),
                "best_dsc": best_dsc,
                "opt_state": optimizer.state_by_name(model.named_parameters()),
                "config": dict(cfg.__dict__),
            },
            save_dir=exp_dir,
            filename="dsc{:.3f}.ckpt".format(eval_dsc.avg),
            max_keep=cfg.max_keep,
        )
    return best_dsc


if __name__ == "__main__":
    main(apply_cli_overrides(TrainConfig(), sys.argv[1:]))
