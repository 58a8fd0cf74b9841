"""Composable numpy transforms for the inference protocol.

Copied from `smilecode_tpu/data/trans.py`: ``Base.__call__`` samples a shape
once then applies ``tf(img, k)`` to each element of a list (k=0 image, k=1
label). `Seg_norm` remaps the 54 raw LPBA label ids to 0..54 (a label not in
the table becomes 0) through `native.seg_remap`; `seg_remap` here is its
numpy version. `NumpyType` casts per-element dtypes. The RCN/RDN transform
zoo is `data/trans_ext.py`.
"""

from __future__ import annotations

import collections.abc

import numpy as np

from smilecode_tpu_torch import native

# Raw LPBA40 label ids, in order; index in this table = normalized label.
LPBA_SEG_TABLE = np.array(
    [0, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 41, 42, 43,
     44, 45, 46, 47, 48, 49, 50, 61, 62, 63, 64, 65, 66, 67, 68, 81, 82, 83,
     84, 85, 86, 87, 88, 89, 90, 91, 92, 101, 102, 121, 122, 161, 162, 163,
     164, 165, 166]
)


def seg_remap(seg: np.ndarray, table: np.ndarray) -> np.ndarray:
    """out[v] = index of v in ``table`` (0 if absent): one lookup-table pass
    for unsigned labels, a per-label loop otherwise."""
    if np.issubdtype(seg.dtype, np.unsignedinteger) and seg.size:
        lut = np.zeros(max(int(seg.max()), int(table.max())) + 1, seg.dtype)
        lut[table] = np.arange(len(table), dtype=seg.dtype)
        return lut[seg]
    out = np.zeros_like(seg)
    for i, lbl in enumerate(table):
        out[seg == lbl] = i
    return out


class Base:
    def sample(self, *shape):
        return shape

    def tf(self, img, k=0):
        return img

    def __call__(self, img, dim=3, reuse=False):
        if not reuse:
            im = img if isinstance(img, np.ndarray) else img[0]
            shape = im.shape[1 : dim + 1]
            self.sample(*shape)
        if isinstance(img, collections.abc.Sequence):
            return [self.tf(x, k) for k, x in enumerate(img)]
        return self.tf(img)

    def __str__(self):
        return "Identity()"


class Seg_norm(Base):
    """Remap raw LPBA label ids to contiguous 0..54 via LPBA_SEG_TABLE."""

    def __init__(self):
        self.seg_table = LPBA_SEG_TABLE

    def tf(self, img, k=0):
        if k == 0:
            return img
        return native.seg_remap(img, self.seg_table)


class NumpyType(Base):
    def __init__(self, types, num=-1):
        self.types = types
        self.num = num

    def tf(self, img, k=0):
        if self.num > 0 and k >= self.num:
            return img
        return img.astype(self.types[k])

    def __str__(self):
        return "NumpyType(({}))".format(", ".join(str(s) for s in self.types))


class Compose(Base):
    """Apply a list of transforms in order."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, dim=3, reuse=False):
        for t in self.transforms:
            img = t(img, dim=dim, reuse=reuse)
        return img

    def __str__(self):
        return "Compose([{}])".format(", ".join(str(t) for t in self.transforms))
