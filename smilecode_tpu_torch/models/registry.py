"""Model registry of the port: name -> ``nn.Module`` and its training loss plan.

Counterpart of `smilecode_tpu/models/registry.py` (`build_model`, `CRITERIA`
and the `ModelSpec` loss plan). ModeT is ported for inference and training;
Im2grid, VTN, RCN and the four deterministic RDN variants for inference
(their loss plans raise `NotImplementedError`); PCNet and PRNet/PR++ raise
`NotImplementedError` naming their ROADMAP item.

A loss plan is a list of criterion names applied index-wise to the model's
(possibly sliced) training outputs against the fixed volume:
``loss = sum criterions[n](outputs[n], fixed) * weights[n]``.
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
# JAX registry names that are not ported yet (ROADMAP.md queue 1, item 8)
NOT_PORTED = ("pcnet", "prnet", "prnetplusplus", "prnet++", "prpp")
# ported for inference; their training is ROADMAP.md queue 1, item 8
BASELINE_NAMES = ("im2grid", "vtn", "rcn")


def build_model(name: str, cfg, device=None, generator: torch.Generator | None = None):
    """Build ``name`` from ``cfg`` (an InferConfig) on ``device``.

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
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md queue 1, item 8: baselines)")
    kw = {"attn_impl": cfg.attn_impl, "device": device, "generator": generator}
    if name == "im2grid":
        from smilecode_tpu_torch.models.im2grid import Im2grid

        return Im2grid(**kw)
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


def loss_plan(name: str) -> LossPlan:
    """The training loss plan of model ``name`` (JAX `build_model`'s spec)."""
    name = name.lower()
    if name in MODET_NAMES:
        return LossPlan(("ncc", "grad_l2"))  # (moved, flow): NCC + L2 diffusion
    if name in BASELINE_NAMES or name.startswith("rdn"):
        raise NotImplementedError(
            f"training {name!r} is not ported yet (ROADMAP.md queue 1, item 8: training of "
            "the baselines); the port runs its inference")
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md queue 1, item 8: baselines)")
    raise ValueError(f"unknown model {name!r}")
