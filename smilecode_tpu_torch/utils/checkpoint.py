"""Checkpoints in the JAX package's format, written and read without jax.

A ``.ckpt`` (`smilecode_tpu/utils/checkpoint.py:save_checkpoint`) is a
pickle of numpy pytrees: ``{"params": {"params": tree}, "epoch", "best_dsc",
"opt_state", "config"}``. The port writes the same keys, with params in the
JAX layout (`convert.params_from_state_dict`) so that both packages' drivers
read them, and its optimizer state as numpy arrays keyed by ``state_dict``
name (`optim.AMSGrad.state_by_name`). A JAX-written ``opt_state`` is made of
optax classes, which would import jax to unpickle; `load_checkpoint` stands
an opaque placeholder in for every class of the jax family instead, so the
params, epoch and score load with torch and numpy alone
(`convert.state_dict_from_jax` takes it from there). Files are named by
validation Dice and natural-sorted, at most ``max_keep`` are kept (the
lowest-sorted go first), and the last is the latest.
"""

from __future__ import annotations

import glob
import os
import pickle
import re

_JAX_FAMILY = ("jax", "jaxlib", "flax", "optax", "chex", "smilecode_tpu")


def _natsort_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", os.path.basename(s))]


def save_checkpoint(state: dict, save_dir: str, filename: str, max_keep: int = 8) -> str:
    """Pickle ``state`` (numpy values) to ``save_dir/filename``, then delete
    the lowest natural-sorted ``.ckpt`` files beyond ``max_keep``."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, filename)
    with open(path, "wb") as f:
        pickle.dump(state, f)
    ckpts = sorted(glob.glob(os.path.join(save_dir, "*.ckpt")), key=_natsort_key)
    for old in ckpts[:max(0, len(ckpts) - max_keep)]:
        os.remove(old)
    return path


def latest_checkpoint(save_dir: str, idx: int = -1) -> str | None:
    ckpts = sorted(glob.glob(os.path.join(save_dir, "*.ckpt")), key=_natsort_key)
    return ckpts[idx] if ckpts else None


class JaxObject:
    """Placeholder for an unpickled object of a jax-family class."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _JAX_FAMILY:
            return type(name, (JaxObject,), {"__module__": module})
        return super().find_class(module, name)


def load_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return _Unpickler(f).load()
