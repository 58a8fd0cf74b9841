"""The port's training step vs the JAX package's, at full width.

Full-width ModeT (channels 4, head_dim 6, heads 8/4/2/1/1, qk_scale 1, a
seeded random RPB) at 16^3, batch 1 and batch 2 (the per-rank rows of the
data-parallel step), the ncc + grad_l2 plan with weights (1, 1): the
port's loss and every parameter gradient (`train.make_loss_and_grads`, torch
autograd through the plain versions) against ``jax.value_and_grad`` of JAX
``ModeT(attn_impl="xla")`` with the same plan, on the same numpy volumes and
the same weights (`convert_state_dict`).

Tolerances: loss 1e-5 relative; each gradient within 1e-4 of its own largest
magnitude (measured: at most 8e-6), plus 1e-6 of the largest gradient of the
model, for the conv biases ahead of an instance norm, whose gradient is zero
but for rounding (~1e-10). The two graphs sum in other orders (box sums,
convolutions, norm reductions, the packed vs gathered warp).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from smilecode_tpu.convert import convert_state_dict
from smilecode_tpu.models import ModeT as JaxModeT
from smilecode_tpu.models.registry import CRITERIA as JAX_CRITERIA
from smilecode_tpu_torch.convert import state_dict_from_jax
from smilecode_tpu_torch.models import ModeT
from smilecode_tpu_torch.models.registry import loss_plan
from smilecode_tpu_torch.train import make_loss_and_grads

torch.set_num_threads(1)
SHAPE = (16, 16, 16)


def test_loss_and_every_gradient_match_jax_value_and_grad():
    assert_step_matches_jax(batch=1)


def test_loss_and_every_gradient_match_jax_value_and_grad_at_batch_2():
    assert_step_matches_jax(batch=2)


def assert_step_matches_jax(batch):
    model = ModeT(qk_scale=1.0, generator=torch.Generator().manual_seed(31))
    rng = np.random.default_rng(32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("rpb"):
                p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    moving = rng.random((batch, *SHAPE, 1)).astype(np.float32)
    fixed = rng.random((batch, *SHAPE, 1)).astype(np.float32)

    plan = loss_plan("modet")
    loss, (sim, reg) = make_loss_and_grads(model, plan, (1.0, 1.0))(
        torch.from_numpy(moving), torch.from_numpy(fixed))
    grads = {name: p.grad for name, p in model.named_parameters()}

    jm = JaxModeT(qk_scale=1.0, attn_impl="xla")
    vol = jnp.zeros((batch, *SHAPE, 1), jnp.float32)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), vol, vol)
    params = jax.tree.map(jnp.asarray, convert_state_dict(model.state_dict(), template))

    def loss_fn(p, x, y):
        outs = jm.apply(p, x, y)
        vals = [JAX_CRITERIA[c](outs[n], y) * 1.0 for n, c in enumerate(plan.criterions)]
        return sum(vals), tuple(vals)

    (j_loss, (j_sim, j_reg)), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jnp.asarray(moving), jnp.asarray(fixed))

    assert float(reg) > 0 and float(sim) < 0  # a real deformation and similarity
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(sim), float(j_sim), rtol=1e-5)
    np.testing.assert_allclose(float(reg), float(j_reg), rtol=1e-4)
    want = state_dict_from_jax(jax.tree.map(np.array, j_grads))
    assert set(want) == set(grads)
    floor = 1e-6 * max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, g in grads.items():
        w = want[name].numpy()
        assert g is not None and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + floor,
                                   err_msg=name)
