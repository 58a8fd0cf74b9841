"""Model registry of the port: name -> ``nn.Module`` and its training loss plan.

Counterpart of `smilecode_tpu/models/registry.py` (`build_model`, `CRITERIA`
and the `ModelSpec` loss plan), with the same names: ModeT (modet,
modet-cu), Im2grid, PCNet, PRNet, PR++ (prnetplusplus, prnet++, prpp), VTN,
RCN and the four deterministic RDN variants (rdn, rdn_share, rdn_diff,
rdn_diff_share), each served and trained.

A loss plan is a list of criterion names applied index-wise to the model's
(possibly sliced) training outputs against the fixed volume:
``loss = sum criterions[n](outputs[n], fixed) * weights[n]``. RCN and RDN
drop the composed flow (``outs[0:1] + outs[2:]``) and regularise each
cascade's or stage's field.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from smilecode_tpu_torch.losses import grad3d, ncc_vxm


def _ncc(pred, fixed):
    return ncc_vxm(pred, fixed)


def _grad_l2(pred, fixed):
    return grad3d(pred, penalty="l2")


CRITERIA = {"ncc": _ncc, "grad_l2": _grad_l2}

MODET_NAMES = ("modet", "modet-cu", "modet_cu", "modetcu")
PRPP_NAMES = ("prnetplusplus", "prnet++", "prpp")


def build_model(name: str, cfg, device=None, generator: torch.Generator | None = None):
    """Build ``name`` from ``cfg`` (an InferConfig or a TrainConfig) on ``device``.

    "modet-cu" is the reference's fused-CUDA-operator variant; here it always
    takes the kernel wrappers (attn_impl="auto") whatever ``cfg.attn_impl``.
    ``cfg.compute_dtype`` "bfloat16" is ModeT's only; the baselines raise
    for it (the JAX registry hands it to ModeT alone and runs them in
    float32).
    """
    name = name.lower()
    compute_dtype = getattr(cfg, "compute_dtype", "")
    if compute_dtype and name not in MODET_NAMES:
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r}: the bf16 path is ModeT's; {name!r} runs in "
            "float32 only")
    if name in MODET_NAMES:
        from smilecode_tpu_torch.models.modet import ModeT

        return ModeT(
            channels=cfg.channels,
            head_dim=cfg.head_dim,
            num_heads=tuple(cfg.num_heads),
            qk_scale=cfg.qk_scale,
            attn_impl="auto" if name != "modet" else cfg.attn_impl,
            compute_dtype=compute_dtype,
            device=device,
            generator=generator,
        )
    kw = {"attn_impl": cfg.attn_impl, "device": device, "generator": generator}
    if name == "im2grid":
        from smilecode_tpu_torch.models.im2grid import Im2grid

        return Im2grid(**kw)
    if name == "pcnet":
        from smilecode_tpu_torch.models.pcnet import PCNet

        return PCNet(**kw)
    if name == "prnet" or name in PRPP_NAMES:
        from smilecode_tpu_torch.models.prnet import PRNet, PRNetPlusPlus

        return (PRNet if name == "prnet" else PRNetPlusPlus)(**kw)
    if name == "vtn":
        from smilecode_tpu_torch.models.rcn import build_vtn

        return build_vtn(**kw)
    if name == "rcn":
        from smilecode_tpu_torch.models.rcn import RCN

        return RCN(n_cascade=getattr(cfg, "n_cascade", 10), **kw)
    if name.startswith("rdn"):
        from smilecode_tpu_torch.models.rdn import RDN

        # reference train config: stages=4, levels=[4,4,4,4]
        return RDN(stages=getattr(cfg, "stages", 4),
                   levels=tuple(getattr(cfg, "levels", (4, 4, 4, 4))),
                   share_weights="share" in name, diff="diff" in name,
                   dropout_rate=getattr(cfg, "dropout_rate", 0.0), **kw)
    raise ValueError(f"unknown model {name!r}")


@dataclasses.dataclass(frozen=True)
class LossPlan:
    """Criterion names, index-aligned with ``select_train_outputs(outputs)``."""

    criterions: tuple[str, ...]
    select_train_outputs: Callable = lambda outs: outs


def loss_plan(name: str, cfg=None) -> LossPlan:
    """The training loss plan of model ``name`` (JAX `build_model`'s spec);
    RCN's and RDN's depend on ``cfg.n_cascade`` and ``cfg.stages`` (defaults
    10 and 4, the reference's)."""
    name = name.lower()
    if name in MODET_NAMES or name in ("im2grid", "pcnet", "prnet", "vtn") or name in PRPP_NAMES:
        return LossPlan(("ncc", "grad_l2"))  # (moved, flow): NCC + L2 diffusion
    if name == "rcn" or name.startswith("rdn"):
        # NCC on the moved image, L2 diffusion on each cascade's (RCN) or
        # stage's (RDN) field; the composed flow is dropped
        depth = getattr(cfg, "n_cascade", 10) if name == "rcn" else getattr(cfg, "stages", 4)
        return LossPlan(("ncc",) + ("grad_l2",) * depth, lambda outs: outs[0:1] + outs[2:])
    raise ValueError(f"unknown model {name!r}")
