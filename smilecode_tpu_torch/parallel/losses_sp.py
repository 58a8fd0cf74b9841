"""The D-sharded training objective and step of ModeT.

Ports `smilecode_tpu/parallel/modet_planes_sp.py:443-585`
(`_box_sum_axis_prepadded`, `ncc_sp`, `grad3d_sp`,
`make_spatial_loss_and_grads`) and the step of `smilecode_tpu/train.py:
138-163` (`make_train_step_spatial`), on the reference-graph forward of
`parallel/modet_sp.py` (the planes graph is not ported).

Each rank computes its contribution to the global loss (its local sums
over the global voxel counts), so the losses' psum over "spatial" is the
unsharded loss; its backward runs through the halo exchanges' and the
all-gathers' transposes, and the gradients of the contributions summed over
"spatial" are the gradient of the global loss. With dp > 1 the loss, its
terms and the gradients are then averaged over "data", as JAX's pmean of
equal shards.
"""

from __future__ import annotations

import torch

from smilecode_tpu_torch.losses.core import abs_
from smilecode_tpu_torch.ops.box import box_sum_axis
from smilecode_tpu_torch.optim import resolve_weights
from smilecode_tpu_torch.parallel.mesh import Mesh
from smilecode_tpu_torch.parallel.modet_sp import modet_forward_spatial
from smilecode_tpu_torch.parallel.spatial import halo_exchange


def _box_sum_axis_prepadded(x: torch.Tensor, win: int, size: int, axis: int) -> torch.Tensor:
    """`ops.box.box_sum_axis` of an input that already carries its
    win//2 padding along ``axis`` (a neighbour's halo)."""
    out = x.narrow(axis, 0, size)
    for o in range(1, win):
        out = out + x.narrow(axis, o, size)
    return out


def ncc_sp(y_true: torch.Tensor, y_pred: torch.Tensor, mesh: Mesh, win: int = 9) -> torch.Tensor:
    """`losses.core.ncc_vxm` from D slabs: both volumes get a win//2 D halo
    (zeros at the volume's ends: the unsharded zero padding), the D box sum
    runs VALID on it, H and W stay local. Returns this rank's contribution:
    minus its local sum of cc over the global voxel count."""
    pad = win // 2
    b, dl, h, w, c = y_true.shape
    ii = halo_exchange(y_true, pad, mesh)
    ji = halo_exchange(y_pred, pad, mesh)

    def box(x):
        x = _box_sum_axis_prepadded(x, win, dl, 1)
        return box_sum_axis(box_sum_axis(x, win, 2), win, 3)

    i_sum, j_sum = box(ii), box(ji)
    i2_sum, j2_sum, ij_sum = box(ii * ii), box(ji * ji), box(ii * ji)
    win_size = float(win ** 3)
    u_i = i_sum / win_size
    u_j = j_sum / win_size
    cross = ij_sum - u_j * i_sum - u_i * j_sum + u_i * u_j * win_size
    i_var = i2_sum - 2 * u_i * i_sum + u_i * u_i * win_size
    j_var = j2_sum - 2 * u_j * j_sum + u_j * u_j * win_size
    cc = cross * cross / (i_var * j_var + 1e-5)
    return -torch.sum(cc) / float(b * dl * mesh.spatial * h * w * c)


def grad3d_sp(flow: torch.Tensor, mesh: Mesh, penalty: str = "l1") -> torch.Tensor:
    """`losses.core.grad3d` from D slabs: the D forward difference crosses
    the slab boundary through a 1-voxel halo, and the difference against
    the zero halo at the volume's end is dropped. Returns this rank's
    contribution."""
    n, i = mesh.spatial, mesh.spatial_index
    b, dl, h, w, c = flow.shape
    d_glob = dl * n
    xh = halo_exchange(flow, 1, mesh)
    dd = abs_(xh[:, 2:] - xh[:, 1:-1])
    dh = abs_(flow[:, :, 1:] - flow[:, :, :-1])
    dw = abs_(flow[:, :, :, 1:] - flow[:, :, :, :-1])
    if penalty == "l2":
        dd, dh, dw = dd * dd, dh * dh, dw * dw
    elif penalty != "l1":
        raise ValueError(f"penalty must be l1 or l2, got {penalty!r}")
    if i == n - 1:  # the last slice's difference runs against the zero halo
        dd = dd[:, :-1]
    return (torch.sum(dd) / float(b * (d_glob - 1) * h * w * c)
            + torch.sum(dh) / float(b * d_glob * (h - 1) * w * c)
            + torch.sum(dw) / float(b * d_glob * h * (w - 1) * c)) / 3.0


def reduce_losses_and_grads(model, mesh: Mesh, values: torch.Tensor, spatial_sum: bool) -> None:
    """In place: the loss values and every parameter's gradient summed over
    "spatial" (when ``spatial_sum``: the ranks hold contributions) and
    averaged over "data"."""
    grads = []
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    if spatial_sum:
        mesh.reduce_([values, *grads], "spatial")
    mesh.reduce_([values, *grads], "data", mean=True)


def make_spatial_loss_and_grads(model, mesh: Mesh, weights=(1.0, 1.0)):
    """(moving, fixed) slabs -> (loss, (sim, reg)) of the reference training
    objective, NCC(9^3) * weights[0] + L2-diffusion Grad3d * weights[1]
    (the reference ModeT's ``train.py:101-104``), through the D-sharded
    forward; the gradients are left in each parameter's ``.grad`` (zeroed
    first), summed over "spatial" and averaged over "data", and the losses
    are the global ones."""
    w_sim, w_reg = resolve_weights(weights, 2)

    def loss_and_grads(moving, fixed):
        model.zero_grad(set_to_none=True)
        moved, flow = modet_forward_spatial(model, moving, fixed, mesh)
        sim = ncc_sp(fixed, moved, mesh) * w_sim
        reg = grad3d_sp(flow, mesh, penalty="l2") * w_reg
        loss = sim + reg
        loss.backward()
        values = torch.stack([loss.detach(), sim.detach(), reg.detach()])
        reduce_losses_and_grads(model, mesh, values, spatial_sum=True)
        return values[0], (values[1], values[2])

    return loss_and_grads


def make_train_step_spatial(model, optimizer, weights, mesh: Mesh):
    """One D-sharded step: forward, loss, backward, the collectives of
    `make_spatial_loss_and_grads`, then the optimizer update on every rank
    (the same gradients, so the same parameters)."""
    loss_and_grads = make_spatial_loss_and_grads(model, mesh, weights)

    def step(moving, fixed):
        loss, loss_vals = loss_and_grads(moving, fixed)
        optimizer.step()
        return loss, loss_vals

    return step
