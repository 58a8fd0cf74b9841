"""Rank functions of the port's multi-rank CPU tests (`run_ranks` spawns them).

They import torch, numpy and the port only (no jax): each spawned rank
imports this module. Inputs are drawn from numpy seeds, so every rank and
the parent see the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from smilecode_tpu_torch.models import ModeT
from smilecode_tpu_torch.models.registry import loss_plan
from smilecode_tpu_torch.optim import AMSGrad
from smilecode_tpu_torch.parallel import losses_sp, mesh as M
from smilecode_tpu_torch.parallel.modet_sp import modet_forward_spatial
from smilecode_tpu_torch.parallel.spatial import halo_conv, halo_exchange
from smilecode_tpu_torch.train import make_train_step


def arrays(seed, *shapes, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def modet_and_pair(shape, batch=1, seed=3, dtype=torch.float64):
    """Full-width ModeT (qk_scale 1) with excited projections and rpb
    (+0.1 N(0, 1), `tests/test_modet.py`'s recipe) and a random volume pair
    of ``batch`` rows, in ``dtype``."""
    model = ModeT(qk_scale=1.0, generator=torch.Generator().manual_seed(seed)).to(dtype)
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("rpb") or "proj.weight" in name:
                p.add_(torch.from_numpy(rng.standard_normal(p.shape)).to(dtype) * 0.1)
    x, y = (torch.from_numpy(rng.random((batch, *shape, 1))).to(dtype) for _ in range(2))
    return model, x, y


def grads_of(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def collective_inputs(seed, spatial):
    """x (1, 8, 3, 4, 2), the cotangents g1, g2 of its halo-1 and halo-2
    exchanges over ``spatial`` ranks, a conv weight and bias, and the
    cotangent gg of its all-gather."""
    return arrays(seed, (1, 8, 3, 4, 2), (1, 8 + 2 * spatial, 3, 4, 2),
                  (1, 8 + 4 * spatial, 3, 4, 2), (3, 2, 3, 3, 3), (3,), (1, 8, 3, 4, 2))


def collectives(mesh, seed):
    """Halo exchanges (halo 1 and 2) and their backward for a cotangent,
    a halo conv, all_gather_d / psum and their backward, on this rank's D
    slab of `collective_inputs`."""
    x, g1, g2, w, bias, gg = collective_inputs(seed, mesh.spatial)
    dl = 8 // mesh.spatial
    j = mesh.spatial_index
    xl = torch.from_numpy(x[:, j * dl:(j + 1) * dl]).requires_grad_()
    out = {}
    for halo, g in ((1, g1), (2, g2)):
        gl = torch.from_numpy(g[:, j * (dl + 2 * halo):(j + 1) * (dl + 2 * halo)])
        y = halo_exchange(xl, halo, mesh)
        (dx,) = torch.autograd.grad(y, xl, gl)
        out[f"halo{halo}"] = (y.detach(), dx)
    out["conv"] = halo_conv(xl, torch.from_numpy(w), torch.from_numpy(bias), mesh).detach()
    ga = M.all_gather_d(xl, mesh)
    (dxa,) = torch.autograd.grad(ga, xl, torch.from_numpy(gg))
    s = M.psum(xl.sum(dim=(1, 2, 3)), mesh)
    (dxs,) = torch.autograd.grad(s, xl, torch.ones_like(s) * (j + 1))
    out.update(gather=(ga.detach(), dxa), psum=(s.detach(), dxs))
    return out


def spatial_forward_and_step(mesh, shape, batch, dtype, seed=3):
    """This rank's slabs of the D-sharded forward, and the loss and
    gradients of the sharded step (summed over "spatial", averaged over
    "data"), of `modet_and_pair`."""
    model, x, y = modet_and_pair(shape, batch, seed, dtype)
    xs, ys = M.shard_batch(mesh, (x, y))
    with torch.no_grad():
        moved, flow = modet_forward_spatial(model, xs, ys, mesh)
    loss, (sim, reg) = losses_sp.make_spatial_loss_and_grads(model, mesh)(xs, ys)
    return {"moved": moved, "flow": flow, "loss": float(loss), "sim": float(sim),
            "reg": float(reg), "grads": grads_of(model)}


def sharded_losses(mesh, seed):
    """`ncc_sp` and `grad3d_sp` (l1 and l2) contributions and the gradients
    of this rank's total contribution with respect to its slabs (the halo
    exchanges' transposes bring the other ranks' terms)."""
    yt, yp, fl = arrays(seed, (1, 16, 6, 5, 1), (1, 16, 6, 5, 1), (1, 16, 6, 5, 3))
    dl, j = 16 // mesh.spatial, mesh.spatial_index
    t, p, f = (torch.from_numpy(a[:, j * dl:(j + 1) * dl]).requires_grad_() for a in (yt, yp, fl))
    ncc = losses_sp.ncc_sp(t, p, mesh)
    l1 = losses_sp.grad3d_sp(f, mesh, "l1")
    l2 = losses_sp.grad3d_sp(f, mesh, "l2")
    grads = torch.autograd.grad(ncc + l1 + 2 * l2, (t, p, f))
    return {"ncc": ncc.item(), "l1": l1.item(), "l2": l2.item(), "grads": grads}


def dp_steps(mesh, shape, seed, dtype, n_steps=2):
    """Two AMSGrad steps of the data-parallel ModeT step on this rank's rows
    of a batch of 2 in ``dtype``: the first step's loss, its terms and the
    averaged gradients, then the parameters after both."""
    model, x, y = modet_and_pair(shape, 2, seed, dtype)
    opt = AMSGrad(model.parameters(), lr=1e-3)
    step = make_train_step(model, loss_plan("modet"), opt, (1.0, 1.0), mesh)
    xs, ys = M.shard_batch(mesh, (x, y))
    loss, vals = step(xs, ys)
    first = {"loss": float(loss), "vals": [float(v) for v in vals], "grads": grads_of(model)}
    for _ in range(n_steps - 1):
        step(xs, ys)
    return first, {n: p.detach().clone() for n, p in model.named_parameters()}


def write_subjects(root, shape, n_train=3, n_val=2, seed=41):
    """Smooth random subjects (image, LPBA labels) as pkl files under
    ``root``/Train and ``root``/Val."""
    import pickle

    from smilecode_tpu_torch.data.trans import LPBA_SEG_TABLE

    rng = np.random.default_rng(seed)
    for split, n in (("Train", n_train), ("Val", n_val)):
        (root / split).mkdir(parents=True)
        for i in range(n):
            img = torch.nn.functional.interpolate(
                torch.from_numpy(rng.random((1, 1, 4, 4, 4)).astype(np.float32)),
                size=shape, mode="trilinear", align_corners=True)[0, 0].numpy()
            seg = LPBA_SEG_TABLE[(img * 54.99).astype(np.int64)].astype(np.uint16)
            with open(root / split / f"subject_{i:02d}.pkl", "wb") as f:
                pickle.dump((img, seg), f)
