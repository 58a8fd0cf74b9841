"""Evaluation metrics on device: LPBA VOI Dice, Jacobian determinant, folding.

Counterpart of `smilecode_tpu/metrics.py`: Dice over the 54 VOI labels with
the same f32 arithmetic (and `dice_val_voi_np`, the numpy loop), the
Jacobian determinant of ``disp + grid`` with np.gradient semantics (central
differences inside, one-sided at the borders: ``torch.gradient`` with
``edge_order=1``), and the fraction of voxels with determinant <= 0.
"""

from __future__ import annotations

import numpy as np
import torch

from smilecode_tpu_torch.ops.warp import base_grid

# The 54 LPBA VOI labels after Seg_norm remapping (labels 1..54).
VOI_LBLS = tuple(range(1, 55))


def dice_val_voi(y_pred: torch.Tensor, y_true: torch.Tensor, labels: tuple = VOI_LBLS) -> torch.Tensor:
    """Mean Dice over ``labels`` of two integer volumes of any shape.

    Per-label counts come from three ``bincount``s; values outside
    [0, max(labels)] fall in a spare bin and match no label."""
    n = int(max(labels)) + 1
    pred = y_pred.reshape(-1).long()
    true = y_true.reshape(-1).long()
    spare = torch.full_like(pred, n)
    pred = torch.where((pred >= 0) & (pred < n), pred, spare)
    true = torch.where((true >= 0) & (true < n), true, spare)
    n_pred = torch.bincount(pred, minlength=n + 1)
    n_true = torch.bincount(true, minlength=n + 1)
    inter = torch.bincount(torch.where(pred == true, pred, spare), minlength=n + 1)
    lbl = torch.as_tensor(labels, device=pred.device)
    inter, n_pred, n_true = inter[lbl], n_pred[lbl], n_true[lbl]
    dsc = 2.0 * inter.float() / ((n_pred + n_true).float() + 1e-5)
    return dsc.mean()


def dice_val_voi_np(y_pred: np.ndarray, y_true: np.ndarray, labels=VOI_LBLS) -> float:
    """Numpy mirror of the reference's per-label loop (the plain version of
    `native.dice_val_voi_native`)."""
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


def jacobian_determinant(disp: torch.Tensor) -> torch.Tensor:
    """Voxelwise Jacobian determinant of a displacement field (D, H, W, 3)."""
    d, h, w, _ = disp.shape
    phi = disp + base_grid(d, h, w, disp.dtype, disp.device)
    jd, jh, jw = torch.gradient(phi, dim=(0, 1, 2), edge_order=1)
    det0 = jd[..., 0] * (jh[..., 1] * jw[..., 2] - jh[..., 2] * jw[..., 1])
    det1 = jd[..., 1] * (jh[..., 0] * jw[..., 2] - jh[..., 2] * jw[..., 0])
    det2 = jd[..., 2] * (jh[..., 0] * jw[..., 1] - jh[..., 1] * jw[..., 0])
    return det0 - det1 + det2


def fold_fraction(disp: torch.Tensor) -> torch.Tensor:
    """Fraction of voxels with Jacobian determinant <= 0 (folding metric)."""
    return (jacobian_determinant(disp) <= 0).float().mean()
