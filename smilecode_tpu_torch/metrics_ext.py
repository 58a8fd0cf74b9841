"""Extended evaluation utilities (RDN/RCN `utils.py` parity), numpy and scipy.

Copied from `smilecode_tpu/metrics_ext.py` (the JAX package cannot be
imported without jax): the LPBA 54-label and Mindboggle label-name tables,
per-class Dice/ASSD/HD/HD95 (medpy equivalents on scipy distance
transforms), 7-VOI Dice, the CSV writer, segmentation smoothing and padding,
and the MC-dropout uncertainty summaries. `get_mc_preds` and
`get_mc_preds_w_errors` take a forward ``apply_fn(moving, fixed,
generator)`` and a `torch.Generator` in place of a JAX key. Nifti save with
a reference header is gated on nibabel presence.
"""

from __future__ import annotations

import csv

import numpy as np
import torch
from scipy import ndimage

LPBA_LABEL_NAMES = [
    "L superior frontal gyrus", "R superior frontal gyrus",
    "L middle frontal gyrus", "R middle frontal gyrus",
    "L inferior frontal gyrus", "R inferior frontal gyrus",
    "L precentral gyrus", "R precentral gyrus",
    "L middle orbitofrontal gyrus", "R middle orbitofrontal gyrus",
    "L lateral orbitofrontal gyrus", "R lateral orbitofrontal gyrus",
    "L gyrus rectus", "R gyrus rectus",
    "L postcentral gyrus", "R postcentral gyrus",
    "L superior parietal gyrus", "R superior parietal gyrus",
    "L supramarginal gyrus", "R supramarginal gyrus",
    "L angular gyrus", "R angular gyrus",
    "L precuneus", "R precuneus",
    "L superior occipital gyrus", "R superior occipital gyrus",
    "L middle occipital gyrus", "R middle occipital gyrus",
    "L inferior occipital gyrus", "R inferior occipital gyrus",
    "L cuneus", "R cuneus",
    "L superior temporal gyrus", "R superior temporal gyrus",
    "L middle temporal gyrus", "R middle temporal gyrus",
    "L inferior temporal gyrus", "R inferior temporal gyrus",
    "L parahippocampal gyrus", "R parahippocampal gyrus",
    "L lingual gyrus", "R lingual gyrus",
    "L fusiform gyrus", "R fusiform gyrus",
    "L insular cortex", "R insular cortex",
    "L cingulate gyrus", "R cingulate gyrus",
    "L caudate", "R caudate",
    "L putamen", "R putamen",
    "L hippocampus", "R hippocampus",
]

SEVEN_REGION_NAMES = [
    "Frontal", "Parietal", "Occipital", "Temporal", "Cingulate",
    "Hippocampus", "Putamen",
]

# `get_Mindbogglelabel` (`Baseline methods/RDN/utils.py:70-78`)
MINDBOGGLE_LABEL_NAMES = [
    "Frontal", "Parietal", "Occipital", "Temporal", "Cingulate",
]


def dice_binary(pred: np.ndarray, true: np.ndarray) -> float:
    """medpy.metric.binary.dc equivalent."""
    pred = np.asarray(pred, bool)
    true = np.asarray(true, bool)
    inter = np.count_nonzero(pred & true)
    denom = np.count_nonzero(pred) + np.count_nonzero(true)
    return 2.0 * inter / denom if denom else 0.0


def _surface_distances(pred: np.ndarray, true: np.ndarray, voxelspacing=None):
    """Distances from the surface of pred to the surface of true
    (medpy __surface_distances equivalent)."""
    pred = np.asarray(pred, bool)
    true = np.asarray(true, bool)
    conn = ndimage.generate_binary_structure(pred.ndim, 1)
    pred_border = pred ^ ndimage.binary_erosion(pred, structure=conn, iterations=1)
    true_border = true ^ ndimage.binary_erosion(true, structure=conn, iterations=1)
    dt = ndimage.distance_transform_edt(~true_border, sampling=voxelspacing)
    return dt[pred_border]


def assd(pred, true, voxelspacing=None) -> float:
    """Average symmetric surface distance (medpy assd equivalent)."""
    d1 = _surface_distances(pred, true, voxelspacing)
    d2 = _surface_distances(true, pred, voxelspacing)
    return float(np.mean(np.concatenate([d1, d2])))


def hd(pred, true, voxelspacing=None) -> float:
    """Hausdorff distance (medpy hd equivalent)."""
    d1 = _surface_distances(pred, true, voxelspacing)
    d2 = _surface_distances(true, pred, voxelspacing)
    return float(max(d1.max(), d2.max()))


def hd95(pred, true, voxelspacing=None) -> float:
    """95th-percentile Hausdorff distance (medpy hd95 equivalent)."""
    d1 = _surface_distances(pred, true, voxelspacing)
    d2 = _surface_distances(true, pred, voxelspacing)
    return float(np.percentile(np.concatenate([d1, d2]), 95))


def per_class_metrics(pred_seg, true_seg, labels, metrics=("dice",)):
    """Per-structure metric table, one row per label id."""
    fns = {"dice": dice_binary, "assd": assd, "hd": hd, "hd95": hd95}
    rows = {}
    for lbl in labels:
        p = pred_seg == lbl
        t = true_seg == lbl
        row = {}
        for m in metrics:
            if m != "dice" and (not p.any() or not t.any()):
                row[m] = np.nan
            else:
                row[m] = fns[m](p, t)
        rows[int(lbl)] = row
    return rows


def dice_val_voi_np(y_pred: np.ndarray, y_true: np.ndarray, labels=range(1, 55)) -> float:
    """Mean Dice over ``labels``, the reference's numpy loop (`dice_val_VOI`)."""
    pred = np.asarray(y_pred).reshape(-1)
    true = np.asarray(y_true).reshape(-1)
    dscs = []
    for i in labels:
        pred_i = pred == i
        true_i = true == i
        inter = np.sum(pred_i * true_i)
        union = np.sum(pred_i) + np.sum(true_i)
        dscs.append(2.0 * inter / (union + 1e-5))
    return float(np.mean(dscs))


def dice_val_7voi(y_pred, y_true) -> float:
    """Mean Dice over the 7 grouped LPBA regions (`dice_val_7VOI`)."""
    return dice_val_voi_np(y_pred, y_true, labels=range(1, 8))


def write_csv(path, header, rows):
    """Reference CSV writer helper (`RDN/utils.py` csv usage)."""
    with open(path, "a", newline="") as f:
        writer = csv.writer(f)
        if header:
            writer.writerow(header)
        for row in rows:
            writer.writerow(row)


def smooth_seg(binary_img: np.ndarray, sigma: float = 1.5, thresh: float = 0.4) -> np.ndarray:
    """Gaussian-smooth a binary mask then re-threshold (`smooth_seg`)."""
    return ndimage.gaussian_filter(binary_img.astype(np.float32), sigma) > thresh


def pad_image(img: np.ndarray, target_shape, mode="constant", **kw) -> np.ndarray:
    """Symmetric pad to target shape (`pad_image`)."""
    pads = []
    for s, t in zip(img.shape, target_shape):
        diff = max(0, t - s)
        pads.append((diff // 2, diff - diff // 2))
    return np.pad(img, pads, mode=mode, **kw)


# ---------------------------------------------------------- uncertainty
# Parity: `Baseline methods/RDN/utils.py:377-504`. Layout note: the
# reference stacks MC samples on the batch axis of NCDHW tensors and splits
# channels as [:-1] (prediction) / [-1:] (aleatoric head); here samples are
# axis 0 of channels-LAST arrays, so the split is on the trailing axis.


def get_mc_preds(apply_fn, moving, fixed, mc_iter: int = 25, generator=None):
    """MC-integration sampling (`get_mc_preds`, `RDN/utils.py:377-393`):
    run a stochastic forward `mc_iter` times, return (img_list, flow_list)
    as numpy arrays.

    `apply_fn(moving, fixed, generator)` must be a forward whose randomness
    (e.g. dropout, ``models.RDN(dropout_rate=...)``) is drawn from
    ``generator``, a `torch.Generator` on the inputs' device; the samples
    draw from it one after another. None: a generator seeded 0.
    """
    if generator is None:
        generator = torch.Generator(device=moving.device).manual_seed(0)
    img_list, flow_list = [], []
    with torch.no_grad():
        for _ in range(mc_iter):
            out = apply_fn(moving, fixed, generator)
            img_list.append(out[0].cpu().numpy())
            flow_list.append(out[1].cpu().numpy())
    return img_list, flow_list


def get_mc_preds_w_errors(apply_fn, moving, fixed, target, mc_iter: int = 25, generator=None):
    """`get_mc_preds_w_errors` (`RDN/utils.py:414-433`): also collects the
    per-sample MSE against ``target``."""
    img_list, flow_list = get_mc_preds(apply_fn, moving, fixed, mc_iter, generator)
    target = np.asarray(target.cpu() if hasattr(target, "cpu") else target)
    errs = [float(np.mean((img - target) ** 2)) for img in img_list]
    return img_list, flow_list, errs


def calc_uncert(tar, img_list):
    """Mean squared deviation from ``tar`` across MC samples, per voxel
    (`calc_uncert`/`calc_error`, `RDN/utils.py:395-411`)."""
    tar = np.asarray(tar)
    sqr = np.stack([(np.asarray(img) - tar) ** 2 for img in img_list], axis=0)
    return sqr.mean(axis=0, keepdims=False)[None]


calc_error = calc_uncert


def mc_stats(preds: np.ndarray):
    """Mean/variance over Monte-Carlo forward passes (axis 0)."""
    preds = np.asarray(preds)
    return preds.mean(axis=0), preds.var(axis=0)


def uncert_regression_gal(img_list, reduction: str = "mean"):
    """Gal-style decomposition (`uncert_regression_gal`, `RDN/utils.py:459-472`):
    the last channel is the aleatoric (predicted-variance) head; the rest is
    the prediction. ale = mean of that channel over samples; epi = variance
    of the prediction channels over samples, averaged across channels.

    img_list: sequence of (..., C) sample arrays (or an (N, ..., C) array).
    Returns (ale, epi, ale+epi) — scalars for reduction 'mean'/'sum',
    arrays for anything else.
    """
    preds = np.stack([np.asarray(x) for x in img_list], axis=0)
    ale = preds[..., -1:].mean(axis=0)
    # ddof=1: the reference uses torch.var's default UNBIASED estimator
    epi = preds[..., :-1].var(axis=0, ddof=1).mean(axis=-1, keepdims=True)
    uncert = ale + epi
    if reduction == "mean":
        return float(ale.mean()), float(epi.mean()), float(uncert.mean())
    if reduction == "sum":
        return float(ale.sum()), float(epi.sum()), float(uncert.sum())
    return ale, epi, uncert


def uceloss(errors, uncert, n_bins: int = 15, outlier: float = 0.0, value_range=None):
    """Uncertainty calibration error (`uceloss`, `RDN/utils.py:474-504`):
    bin voxels by uncertainty, accumulate |mean err - mean uncert| * bin
    fraction. Returns (uce, err_in_bin, avg_uncert_in_bin, prop_in_bin)
    like the reference (bins with fraction <= ``outlier`` are skipped;
    first boundary is exclusive, matching torch ``gt``/``le``)."""
    errors = np.asarray(errors, np.float64).reshape(-1)
    uncert = np.asarray(uncert, np.float64).reshape(-1)
    if value_range is None:
        edges = np.linspace(uncert.min(), uncert.max(), n_bins + 1)
    else:
        edges = np.linspace(value_range[0], value_range[1], n_bins + 1)
    uce = 0.0
    err_in_bin, avg_unc_in_bin, prop_in_bin = [], [], []
    n = len(uncert)
    for lo, hi in zip(edges[:-1], edges[1:]):
        mask = (uncert > lo) & (uncert <= hi)
        prop = mask.sum() / n
        prop_in_bin.append(prop)
        if prop > outlier:
            e = errors[mask].mean() if mask.any() else np.nan
            u = uncert[mask].mean() if mask.any() else np.nan
            uce += abs(u - e) * prop
            err_in_bin.append(e)
            avg_unc_in_bin.append(u)
    return (
        float(uce),
        np.asarray(err_in_bin),
        np.asarray(avg_unc_in_bin),
        np.asarray(prop_in_bin),
    )


def uce_loss(errors, uncert, n_bins: int = 15):
    """Scalar convenience wrapper over `uceloss`."""
    return uceloss(errors, uncert, n_bins)[0]


def save_nii(img: np.ndarray, path: str, reference_header_path: str | None = None):
    """Save a volume as NIfTI with an optional reference header
    (`RDN/utils.py` nii save). Requires nibabel."""
    try:
        import nibabel as nib
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError("save_nii requires nibabel") from e
    if reference_header_path:
        ref = nib.load(reference_header_path)
        out = nib.Nifti1Image(img, ref.affine, ref.header)
    else:
        out = nib.Nifti1Image(img, np.eye(4))
    nib.save(out, path)
