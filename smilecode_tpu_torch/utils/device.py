"""The device that `train.main` and `infer.main` run on."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``. A CUDA device without a card raises
    `RuntimeError`: nothing falls back to the CPU unasked."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={name!r} but torch.cuda.is_available() is False; "
                           "pass device=cpu to run on the CPU")
    return device
