"""Run configuration for the PyTorch port's drivers.

`TrainConfig`, `InferConfig` and `apply_cli_overrides` are copied from
`smilecode_tpu/config.py` (the JAX package cannot be imported without jax).
Left out: the JAX-only `fast_path` knob (planes-layout TPU decoder) and
`img_size` (the JAX package needs it to build a parameter template; the port
does not). Both configs carry the dataset variant (``dataset`` s2s, half or
atlas, with ``atlas_path``) and the baselines' structural knobs (RCN's
``n_cascade``, RDN's ``stages``, ``levels`` and MC-dropout
``dropout_rate``). `check_train_config` raises `NotImplementedError` for
the training knobs whose paths are not ported yet (multi-GPU). Added:
``device`` (both configs), where `train.main` and `infer.main` run: "cuda"
(the default; they raise without a card) or "cpu".
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

COMPUTE_DTYPES = ("", "bfloat16")  # "" = float32


@dataclasses.dataclass
class TrainConfig:
    model: str = "modet"
    train_dir: str = "/LPBA_path/Train/"
    val_dir: str = "/LPBA_path/Val/"
    batch_size: int = 1
    lr: float = 1e-4
    weights: Sequence[float] = (1.0, 1.0)
    head_dim: int = 6
    num_heads: Sequence[int] = (8, 4, 2, 1, 1)
    channels: int = 4
    qk_scale: float | None = 1.0  # the reference trains ModeT with scale=1
    max_epoch: int = 30
    epoch_start: int = 0
    cont_training: bool = False
    seed: int = 24
    save_root: str = "experiments"
    log_root: str = "logs"
    max_keep: int = 8
    num_workers: int = 4
    # "auto": Hopper kernels for tensors on a CUDA device, their plain
    # PyTorch versions for CPU tensors; "plain": the plain versions always
    attn_impl: str = "auto"
    # "" = float32; "bfloat16" runs ModeT's feature path in bf16
    compute_dtype: str = ""
    # dataset variant: "s2s" (all ordered pairs), "half" (stride-2
    # downsampled pairs), "atlas" (register every subject to one atlas)
    dataset: str = "s2s"
    atlas_path: str = ""
    # "cuda" runs on the card and raises without one; "cpu" asks for the CPU
    device: str = "cuda"
    # data-parallel devices and D-axis shards (only 1 is ported)
    dp: int = 1
    spatial: int = 1
    # RCN: number of cascaded VTNs (the reference trains 10)
    n_cascade: int = 10
    # RDN: outer stage recursion count and per-stage level recursion depths
    # (the reference's stages=4, levels=[4,4,4,4])
    stages: int = 4
    levels: Sequence[int] = (4, 4, 4, 4)
    # RDN MC-dropout rate for the uncertainty protocol (0 = off; training
    # never drops: `models/rdn.py:Estimator`)
    dropout_rate: float = 0.0

    @property
    def save_dir(self) -> str:
        """Reference save-dir naming convention (`ModeT/train.py:51`)."""
        if self.model == "modet":
            return "modet-heads({}{}{}{}{})-rpe_headim_{}_ncc_{}_reg_{}_lr_{}_54r/".format(
                *self.num_heads, self.head_dim, self.weights[0], self.weights[1], self.lr
            )
        return "{}_ncc_{}_reg_{}_lr_{}_54r/".format(
            self.model, self.weights[0], self.weights[1], self.lr
        )


def check_train_config(cfg: TrainConfig) -> None:
    """Raise `NotImplementedError`, naming the ROADMAP item, for a knob whose
    path the port does not have yet."""
    if cfg.dp != 1 or cfg.spatial != 1:
        raise NotImplementedError(f"dp={cfg.dp}, spatial={cfg.spatial}: multi-GPU training is "
                                  "not ported yet (ROADMAP.md queue 1, item 10)")
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {cfg.compute_dtype!r}")


@dataclasses.dataclass
class InferConfig:
    model: str = "modet"
    test_dir: str = "/LPBA_path/Test/"
    model_dir: str = ""
    model_idx: int = -1
    head_dim: int = 6
    num_heads: Sequence[int] = (8, 4, 2, 1, 1)
    channels: int = 4
    qk_scale: float | None = 1.0
    # "auto": Hopper kernels for tensors on a CUDA device, their plain
    # PyTorch versions for CPU tensors; "plain": the plain versions always
    attn_impl: str = "auto"
    # "" = float32; "bfloat16" runs ModeT's feature path in bf16 (other
    # models: float32 only)
    compute_dtype: str = ""
    dataset: str = "s2s"  # s2s | half | atlas
    atlas_path: str = ""
    # "cuda" runs on the card and raises without one; "cpu" asks for the CPU
    device: str = "cuda"
    # load a reference PyTorch .pth.tar instead of a JAX-format checkpoint
    torch_checkpoint: str = ""
    # structural knobs of the baselines (must match the checkpoint): RCN
    # cascade depth, RDN stage and per-level recursions, RDN MC-dropout rate
    n_cascade: int = 10
    stages: int = 4
    levels: Sequence[int] = (4, 4, 4, 4)
    dropout_rate: float = 0.0
    # MC-dropout uncertainty protocol (`RDN/utils.py:377-504`): mc_iter > 0
    # runs mc_iter stochastic forwards per pair (requires dropout_rate > 0)
    mc_iter: int = 0


def apply_cli_overrides(cfg, argv: list[str]):
    """``key=value`` CLI overrides, e.g. ``test_dir=/data/Test model_idx=-1``."""
    for arg in argv:
        if "=" not in arg:
            raise SystemExit(f"expected key=value, got {arg!r}")
        key, val = arg.split("=", 1)
        if not hasattr(cfg, key):
            raise SystemExit(f"unknown config key {key!r}")
        cur = getattr(cfg, key)
        if isinstance(cur, bool):
            setattr(cfg, key, val.lower() in ("1", "true", "yes"))
        elif isinstance(cur, int):
            setattr(cfg, key, int(val))
        elif isinstance(cur, float) or cur is None:
            setattr(cfg, key, float(val) if val.lower() != "none" else None)
        elif isinstance(cur, str):
            setattr(cfg, key, val)
        else:  # sequence
            setattr(cfg, key, tuple(type(cur[0])(v) for v in val.split(",")))
    return cfg
