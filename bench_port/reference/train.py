"""Plain reference of what surrounds the models: the training loss (local
NCC over 9^3 windows, the L2 diffusion regulariser), optax's AMSGrad with
SmileCode's poly learning rate, and the scores of a registered pair (Dice
over the 54 LPBA labels of the nearest-warped moving labels, the fraction
of voxels whose Jacobian determinant is <= 0). NCDHW, in the dtype of the
inputs (the benchmark hands the loss float64 ones); Dice and the folding
share counted in float64. Imports torch alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def box_sum(x, win: int = 9):
    """Sum over the win^3 box around each voxel of (B, C, D, H, W) ``x``,
    zero outside: the convolution by ones of VoxelMorph's NCC, one axis at
    a time."""
    pad = win // 2
    for dim in (2, 3, 4):
        pads = [0, 0] * (4 - dim) + [pad, pad]
        x = F.pad(x, pads).unfold(dim, win, 1).sum(-1)
    return x


def ncc(a, b, win: int = 9):
    """VoxelMorph's local NCC loss, -mean(cc)."""
    i_sum, j_sum, i2_sum, j2_sum, ij_sum = (box_sum(t, win) for t in (a, b, a * a, b * b, a * b))
    n = float(win ** 3)
    u_i, u_j = i_sum / n, j_sum / n
    cross = ij_sum - u_j * i_sum - u_i * j_sum + u_i * u_j * n
    i_var = i2_sum - 2 * u_i * i_sum + u_i * u_i * n
    j_var = j2_sum - 2 * u_j * j_sum + u_j * u_j * n
    return -torch.mean(cross * cross / (i_var * j_var + 1e-5))


def grad_l2(flow):
    """Mean squared forward difference along D, H and W, averaged."""
    dd = flow[:, :, 1:] - flow[:, :, :-1]
    dh = flow[:, :, :, 1:] - flow[:, :, :, :-1]
    dw = flow[:, :, :, :, 1:] - flow[:, :, :, :, :-1]
    return ((dd * dd).mean() + (dh * dh).mean() + (dw * dw).mean()) / 3.0


def loss_terms(outputs, fixed, weights):
    """[weighted NCC of outputs[0], weighted L2 regulariser of each further
    output]; the weights list extends by its last entry."""
    weights = list(weights) + [weights[-1]] * max(0, len(outputs) - len(weights))
    terms = [ncc(outputs[0], fixed) * weights[0]]
    terms += [grad_l2(f) * w for f, w in zip(outputs[1:], weights[1:])]
    return terms


def poly_lr(epoch: int, max_epoch: int, lr: float) -> float:
    return round(lr * (1 - epoch / max_epoch) ** 0.9, 8)


class AMSGrad:
    """optax.amsgrad (b1 0.9, b2 0.999, eps 1e-8): the max of the
    bias-corrected second moment; a functional copy over a params dict."""

    def __init__(self, params: dict, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps, self.count = b1, b2, eps, 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu_max = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float):
        self.count += 1
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** self.count
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** self.count
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * g * g + self.b2 * self.nu[k]
            self.nu_max[k] = torch.maximum(self.nu_max[k], self.nu[k] / bc2.item())
            p -= lr * (self.mu[k] / bc1.item()) / (torch.sqrt(self.nu_max[k]) + self.eps)


def dice(pred, true, labels=range(1, 55)) -> float:
    """Mean Dice over ``labels`` of two integer volumes."""
    pred, true = pred.reshape(-1).long(), true.reshape(-1).long()
    n = max(labels) + 1
    pred = torch.where((pred >= 0) & (pred < n), pred, n)
    true = torch.where((true >= 0) & (true < n), true, n)
    n_pred = torch.bincount(pred, minlength=n + 1).double()
    n_true = torch.bincount(true, minlength=n + 1).double()
    inter = torch.bincount(torch.where(pred == true, pred, n), minlength=n + 1).double()
    idx = torch.tensor(list(labels), device=pred.device)
    return float((2 * inter[idx] / (n_pred[idx] + n_true[idx] + 1e-5)).mean())


def fold_fraction(flow) -> float:
    """Share of voxels where the Jacobian determinant of grid + ``flow``
    (3, D, H, W) is <= 0; central differences inside, one-sided at the
    borders (numpy's ``gradient``)."""
    sizes = flow.shape[1:]
    grid = torch.stack(torch.meshgrid(
        *[torch.arange(n, dtype=flow.dtype, device=flow.device) for n in sizes], indexing="ij"))
    phi = flow + grid
    j = [torch.gradient(phi[i], dim=(0, 1, 2), edge_order=1) for i in range(3)]  # j[i][a] = d phi_i / d x_a
    det = (j[0][0] * (j[1][1] * j[2][2] - j[2][1] * j[1][2])
           - j[1][0] * (j[0][1] * j[2][2] - j[2][1] * j[0][2])
           + j[2][0] * (j[0][1] * j[1][2] - j[1][1] * j[0][2]))
    return float((det <= 0).double().mean())
