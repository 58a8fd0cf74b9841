"""Seeded synthetic subjects for the benchmark.

A copy of `chip_smoke.py:write_subjects`, rewritten to draw from the run's
``--seed`` on the card in one call: each subject is a smooth image in [0, 1]
(a coarse uniform field, one cell every 16 voxels, upsampled trilinearly)
and a label volume cut from a second such field into 55 bands, written as
the raw LPBA40 label ids that the program's `Seg_norm` maps back to 0..54.
The benchmark keeps the images and the band indices in host memory, so the
reference reads the same data without the program's loaders.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.nn.functional as F

# the raw LPBA40 label ids; index in this table = normalised label 0..54
LPBA_SEG_TABLE = np.array(
    [0, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 41, 42, 43,
     44, 45, 46, 47, 48, 49, 50, 61, 62, 63, 64, 65, 66, 67, 68, 81, 82, 83,
     84, 85, 86, 87, 88, 89, 90, 91, 92, 101, 102, 121, 122, 161, 162, 163,
     164, 165, 166])
N_LABELS = 55


def make_subjects(n: int, size, generator: torch.Generator, device) -> list:
    """``n`` subjects as (image float32 (D, H, W), labels 0..54 uint8) numpy
    pairs, drawn from ``generator`` (on ``device``) in one call."""
    coarse = tuple(max(2, s // 16) for s in size)
    fields = torch.rand((n, 2, *coarse), generator=generator, device=device)
    out = []
    for i in range(n):
        f = F.interpolate(fields[i:i + 1], size=tuple(size), mode="trilinear",
                          align_corners=True)[0]
        lab = f[1]
        lab = (lab - lab.min()) / (lab.max() - lab.min() + 1e-6)
        bands = torch.clamp((lab * N_LABELS).to(torch.int64), max=N_LABELS - 1)
        out.append((f[0].contiguous().cpu().numpy(), bands.to(torch.uint8).cpu().numpy()))
    return out


def write_subjects(subjects, directory: str) -> list:
    """Pickle each subject as the program's datasets read it: (image,
    raw LPBA label ids as uint16). Returns the paths, in order."""
    paths = []
    for i, (img, bands) in enumerate(subjects):
        path = os.path.join(directory, f"subject_{i:02d}.pkl")
        with open(path, "wb") as f:
            pickle.dump((img, LPBA_SEG_TABLE[bands].astype(np.uint16)), f)
        paths.append(path)
    return paths


def identify(volume: np.ndarray, subjects, half: bool) -> int:
    """The subject whose image ``volume`` is exactly (at stride 2 with
    ``half``), or -1."""
    for i, (img, _) in enumerate(subjects):
        ref = img[::2, ::2, ::2] if half else img
        if ref.shape == volume.shape and np.array_equal(ref, volume):
            return i
    return -1
