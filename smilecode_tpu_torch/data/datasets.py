"""LPBA pair datasets (numpy; items are (1, D, H, W) arrays).

Copied from `smilecode_tpu/data/datasets.py` (the JAX package cannot be
imported without jax): the all-ordered-pairs S2S training and inference
datasets, their stride-2 ``half`` variants, and the ``atlas`` datasets,
which register each subject to one atlas volume (never halved).

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


def halfres(vol: np.ndarray) -> np.ndarray:
    """``vol[::2, ::2, ::2]``, contiguous, dtype kept (the half datasets;
    `smilecode_tpu/native/__init__.py:halfres` without its native copy,
    which gives the same array)."""
    return np.ascontiguousarray(vol[::2, ::2, ::2])


class _PairDataset:
    """All ordered pairs over a list of pkl subject paths; ``half`` loads
    every subject at stride 2."""

    def __init__(self, data_path, transforms, half=False):
        self.paths = list(data_path)
        self.transforms = transforms
        self.half = half

    def __len__(self):
        return len(self.paths) * (len(self.paths) - 1)

    def _load(self, path):
        img, seg = pkload(path)
        if self.half:
            img, seg = halfres(img), halfres(seg)
        return img, seg


class LPBABrainDatasetS2S(_PairDataset):
    """Training pairs: (x, y) images only, transformed jointly."""

    def __getitem__(self, index):
        xi, yi = pair_indices(index, len(self.paths))
        x, _ = self._load(self.paths[xi])
        y, _ = self._load(self.paths[yi])
        x, y = x[None, ...], y[None, ...]
        x, y = self.transforms([x, y])
        return np.ascontiguousarray(x), np.ascontiguousarray(y)


class LPBABrainInferDatasetS2S(_PairDataset):
    """Eval pairs: (x, y, x_seg, y_seg); transform applied per (img, seg)."""

    def __getitem__(self, index):
        xi, yi = pair_indices(index, len(self.paths))
        x, x_seg = self._load(self.paths[xi])
        y, y_seg = self._load(self.paths[yi])
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


class LPBABrainHalfDatasetS2S(LPBABrainDatasetS2S):
    def __init__(self, data_path, transforms):
        super().__init__(data_path, transforms, half=True)


class LPBABrainHalfInferDatasetS2S(LPBABrainInferDatasetS2S):
    def __init__(self, data_path, transforms):
        super().__init__(data_path, transforms, half=True)


class LPBABrainAtlasDataset(_PairDataset):
    """Atlas mode: register every subject to one fixed atlas volume
    (`Baseline methods/RDN/data/datasets.py:10-52`); one item per subject."""

    def __init__(self, data_path, atlas_path, transforms):
        super().__init__(data_path, transforms)
        self.atlas_path = atlas_path

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        x, _ = self._load(self.paths[index])
        y, _ = pkload(self.atlas_path)
        x, y = x[None, ...], y[None, ...]
        x, y = self.transforms([x, y])
        return np.ascontiguousarray(x), np.ascontiguousarray(y)


class LPBABrainAtlasInferDataset(_PairDataset):
    """Atlas mode for evaluation: (x, atlas, x_seg, atlas_seg)."""

    def __init__(self, data_path, atlas_path, transforms):
        super().__init__(data_path, transforms)
        self.atlas_path = atlas_path

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        x, x_seg = self._load(self.paths[index])
        y, y_seg = pkload(self.atlas_path)
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


def pair_dataset(name: str, paths, transforms, infer: bool, atlas_path: str = ""):
    """The dataset that ``dataset=name`` selects, as the JAX drivers do
    (`smilecode_tpu/train.py:216-224`, `smilecode_tpu/infer.py:166-171`):
    ``half`` and ``atlas``, and the all-ordered-pairs S2S for any other
    name; ``infer`` picks the variant that also yields the segmentations."""
    if name == "half":
        return (LPBABrainHalfInferDatasetS2S if infer else LPBABrainHalfDatasetS2S)(paths, transforms)
    if name == "atlas":
        cls = LPBABrainAtlasInferDataset if infer else LPBABrainAtlasDataset
        return cls(paths, atlas_path, transforms)
    return (LPBABrainInferDatasetS2S if infer else LPBABrainDatasetS2S)(paths, transforms)
