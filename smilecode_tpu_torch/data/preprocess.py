"""LPBA40 raw -> pkl preprocessing (the reference's `makePklDataset.py`).

Copied from `smilecode_tpu/data/preprocess.py`, so that both packages write
the same pkls array for array:
  * crop center rule: mean of per-axis [first, last] indices taken from
    np.sort(np.nonzero(arr)), i.e. sorted-flat nonzero index lists per axis
    (quirky but reproduced exactly);
  * center crop to 160x192x160; min-max normalize image to [0, 1] float32;
  * labels uint16; pickled (img, label) tuple per subject.

The Analyze 7.5 (.hdr or .hdr.gz beside .img or .img.gz) reader takes
either endianness; numpy arrays can also be passed straight to
`process_subject`. There is no command-line entry point: call
`make_pkl_dataset(raw_dir, out_dir)`.
"""

from __future__ import annotations

import glob
import gzip
import os
import pickle

import numpy as np

CROP_SHAPE = (160, 192, 160)


def center(arr: np.ndarray) -> np.ndarray:
    """Reference `center()` (`makePklDataset.py:15-17`): per-axis midpoint of
    the sorted-flat nonzero index lists, truncated via int16 cast."""
    c = np.sort(np.nonzero(arr))[:, [0, -1]]
    return np.mean(c, axis=-1).astype("int16")


def crop_by_center(image: np.ndarray, c, final_shape=CROP_SHAPE) -> np.ndarray:
    """Reference `cropByCenter` (`makePklDataset.py:22-53`): center +- half
    per axis, clamped to the volume so the output is exactly final_shape."""
    crop = np.array([s // 2 for s in final_shape])
    for axis in range(3):
        cropmin, cropmax = int(c[axis] - crop[axis]), int(c[axis] + crop[axis])
        if cropmin < 0:
            cropmin = 0
            cropmax = final_shape[axis]
        if cropmax > image.shape[axis]:
            cropmax = image.shape[axis]
            cropmin = image.shape[axis] - final_shape[axis]
        sl = [slice(None)] * 3
        sl[axis] = slice(cropmin, cropmax)
        image = image[tuple(sl)]
    return image


def minmax(arr: np.ndarray) -> np.ndarray:
    """(x - min) / (max - min); float64 intermediate like the reference, the
    caller casts to float32 afterwards (bit parity with `makePklDataset.py:76`)."""
    return (arr - np.min(arr)) / (np.max(arr) - np.min(arr))


def process_subject(img: np.ndarray, label: np.ndarray, shape=CROP_SHAPE):
    """Crop both volumes around the image's nonzero center, normalize."""
    c = center(img)
    img_c = crop_by_center(img, c, shape)
    lbl_c = crop_by_center(label, c, shape)
    return minmax(img_c).astype("float32"), lbl_c.astype("uint16")


def _read_analyze_img_gz(path: str) -> np.ndarray:
    """Minimal Analyze 7.5 (.hdr/.img[.gz]) reader for LPBA volumes."""
    hdr_path = path.replace(".img.gz", ".hdr").replace(".img", ".hdr")
    if not os.path.exists(hdr_path) and os.path.exists(hdr_path + ".gz"):
        with gzip.open(hdr_path + ".gz", "rb") as f:
            hdr = f.read()
    else:
        with open(hdr_path, "rb") as f:
            hdr = f.read()
    endian = "<" if int.from_bytes(hdr[0:4], "little") == 348 else ">"
    dims = np.frombuffer(hdr[40:56], dtype=np.dtype(endian + "i2"))
    ndim, dx, dy, dz = int(dims[0]), int(dims[1]), int(dims[2]), int(dims[3])
    datatype = int(np.frombuffer(hdr[70:72], dtype=np.dtype(endian + "i2"))[0])
    dtypes = {2: "u1", 4: "i2", 8: "i4", 16: "f4", 64: "f8"}
    dt = np.dtype(endian + dtypes[datatype])
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = np.frombuffer(f.read(), dtype=dt)
    # Analyze 7.5 stores the buffer x-fastest (then y, then z). Reshaping the
    # raw buffer to (dz, dy, dx) therefore yields index order (z, y, x) with
    # NO transpose — exactly what the reference gets from
    # `sitk.GetArrayFromImage(sitk.ReadImage(path))` (makePklDataset.py:12-13),
    # whose array convention is (z, y, x) over the same x-fastest buffer.
    # Orientation: tests/test_torch_data_tools.py::test_analyze_reader_matches_jax.
    vol = data[: dx * dy * dz].reshape(dz, dy, dx) if ndim >= 3 else data
    return np.ascontiguousarray(vol)


def pksave(img: np.ndarray, label: np.ndarray, path: str):
    with open(path, "wb") as f:
        pickle.dump((img, label), f)


def natsort_key(s: str):
    """Natural-sort key (natsorted equivalent for LPBA file names)."""
    import re

    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def make_pkl_dataset(raw_dir: str, out_dir: str, shape=CROP_SHAPE, verbose=True):
    """Convert a directory of LPBA subjects to cropped/normalized pkl pairs.

    Mirrors the reference driver (`makePklDataset.py:55-81`): natsorted
    `*skullstripped.img.gz` / `*label.img.gz` pairs -> `subject_%02d.pkl`."""
    os.makedirs(out_dir, exist_ok=True)
    imgs = sorted(
        glob.glob(os.path.join(raw_dir, "**", "*skullstripped.img.gz"), recursive=True),
        key=natsort_key,
    )
    lbls = sorted(
        glob.glob(os.path.join(raw_dir, "**", "*label.img.gz"), recursive=True),
        key=natsort_key,
    )
    for i, (img_path, lbl_path) in enumerate(zip(imgs, lbls)):
        img = _read_analyze_img_gz(img_path)
        lbl = _read_analyze_img_gz(lbl_path)
        pimg, plbl = process_subject(img, lbl, shape)
        name = "subject_%02d.pkl" % (i + 1)
        pksave(pimg, plbl, os.path.join(out_dir, name))
        if verbose:
            print(f"{name}: img {pimg.shape} {pimg.dtype}, label {plbl.shape} {plbl.dtype}")
