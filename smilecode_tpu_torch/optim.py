"""Optimizer and learning-rate schedule of the training driver.

`AMSGrad` follows `optax.amsgrad` (the JAX package's optimizer,
`smilecode_tpu/train.py:195-197`), not `torch.optim.Adam(amsgrad=True)`:
optax keeps the running max of the *bias-corrected* second moment, torch the
max of the raw moment divided by the current bias correction, and the two
agree only on the first step. Per step t, for gradient g:

    mu = (1 - b1) g + b1 mu,   nu = (1 - b2) g^2 + b2 nu,
    nu_max = max(nu_max, nu / (1 - b2^t)),
    p -= lr * (mu / (1 - b1^t)) / (sqrt(nu_max + eps_root) + eps)

with b1 0.9, b2 0.999, eps 1e-8, eps_root 0 and no weight decay. A
parameter without a gradient is updated as if its gradient were zero, as
optax does. `poly_lr` and `resolve_weights` are copied from
`smilecode_tpu/train.py:52,57`.
"""

from __future__ import annotations

import numpy as np
import torch


def poly_lr(epoch: int, max_epoch: int, init_lr: float, power: float = 0.9) -> float:
    """Poly-0.9 per-epoch learning rate, rounded to 8 decimals."""
    return round(init_lr * np.power(1 - epoch / max_epoch, power), 8)


def resolve_weights(weights, n_criterions: int) -> list[float]:
    """One weight per criterion: extend ``weights`` by repeating the last."""
    weights = list(weights)
    if not weights:
        raise ValueError("weights must be non-empty")
    if len(weights) < n_criterions:
        weights = weights + [weights[-1]] * (n_criterions - len(weights))
    return weights[:n_criterions]


class AMSGrad(torch.optim.Optimizer):
    """optax.amsgrad as a torch optimizer (see the module docstring).

    State per parameter: ``mu``, ``nu``, ``nu_max`` (optax's
    ScaleByAmsgradState fields); the step count is ``self.count``, shared by
    all parameters like optax's ``count``.
    """

    def __init__(self, params, lr: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root))
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AMSGrad.step takes no closure")
        self.count += 1
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            # the bias corrections in float32, as optax computes them
            bc1 = float(1 - np.float32(b1) ** np.float32(self.count))
            bc2 = float(1 - np.float32(b2) ** np.float32(self.count))
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                st = self.state[p]
                if not st:
                    for key in ("mu", "nu", "nu_max"):
                        st[key] = torch.zeros_like(p)
                mu, nu, nu_max = st["mu"], st["nu"], st["nu_max"]
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * (g * g) + b2 * nu)
                torch.maximum(nu_max, nu / bc2, out=nu_max)
                update = (mu / bc1) / (torch.sqrt(nu_max + group["eps_root"]) + group["eps"])
                p.add_(update * -group["lr"])

    def state_by_name(self, named_params) -> dict:
        """{"count", "mu", "nu", "nu_max"}: numpy arrays keyed by the
        parameters' ``state_dict`` names."""
        out = {"count": self.count, "mu": {}, "nu": {}, "nu_max": {}}
        for name, p in named_params:
            st = self.state.get(p, {})
            for key in ("mu", "nu", "nu_max"):
                val = st[key] if key in st else torch.zeros_like(p)
                out[key][name] = val.detach().cpu().numpy()
        return out

    def load_state_by_name(self, named_params, state: dict) -> None:
        """Inverse of `state_by_name`; raises KeyError on a missing name."""
        self.count = int(state["count"])
        for name, p in named_params:
            self.state[p] = {key: torch.as_tensor(state[key][name]).to(p.device).clone()
                             for key in ("mu", "nu", "nu_max")}
