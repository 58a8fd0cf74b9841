"""LPBA pair datasets (numpy; items are (1, D, H, W) arrays).

Copied from `smilecode_tpu/data/datasets.py` (the JAX package cannot be
imported without jax): the all-ordered-pairs S2S training and inference
datasets. The ``half`` and ``atlas`` variants are not ported yet.

Pair index math: x = i // (n-1); s = i % (n-1); y = s + 1 if s >= x else s,
which enumerates all n*(n-1) ordered (x, y) pairs with x != y.
"""

from __future__ import annotations

import pickle

import numpy as np


def pkload(fname):
    with open(fname, "rb") as f:
        return pickle.load(f)


def pair_indices(index: int, n: int) -> tuple[int, int]:
    x = index // (n - 1)
    s = index % (n - 1)
    y = s + 1 if s >= x else s
    return x, y


class _PairDataset:
    """All ordered pairs over a list of pkl subject paths."""

    def __init__(self, data_path, transforms):
        self.paths = list(data_path)
        self.transforms = transforms

    def __len__(self):
        return len(self.paths) * (len(self.paths) - 1)


class LPBABrainDatasetS2S(_PairDataset):
    """Training pairs: (x, y) images only, transformed jointly."""

    def __getitem__(self, index):
        xi, yi = pair_indices(index, len(self.paths))
        x, _ = pkload(self.paths[xi])
        y, _ = pkload(self.paths[yi])
        x, y = x[None, ...], y[None, ...]
        x, y = self.transforms([x, y])
        return np.ascontiguousarray(x), np.ascontiguousarray(y)


class LPBABrainInferDatasetS2S(_PairDataset):
    """Eval pairs: (x, y, x_seg, y_seg); transform applied per (img, seg)."""

    def __getitem__(self, index):
        xi, yi = pair_indices(index, len(self.paths))
        x, x_seg = pkload(self.paths[xi])
        y, y_seg = pkload(self.paths[yi])
        x, y = x[None, ...], y[None, ...]
        x_seg, y_seg = x_seg[None, ...], y_seg[None, ...]
        x, x_seg = self.transforms([x, x_seg])
        y, y_seg = self.transforms([y, y_seg])
        return (
            np.ascontiguousarray(x),
            np.ascontiguousarray(y),
            np.ascontiguousarray(x_seg),
            np.ascontiguousarray(y_seg),
        )
