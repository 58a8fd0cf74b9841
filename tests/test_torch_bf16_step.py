"""The port's bf16 training step (`compute_dtype="bfloat16"`) vs
``jax.value_and_grad`` of the JAX package's bf16 ModeT, on the CPU.

Full-width ModeT at 16^3 with excited weights (tests/test_torch_bf16.py), the
ncc + grad_l2 plan with weights (1, 1); the JAX side runs kernels A, B and C
in interpret mode (``attn_impl="pallas"``). Tolerances in the test.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from smilecode_tpu.models import ModeT as JaxModeT
from smilecode_tpu.models.registry import CRITERIA as JAX_CRITERIA
from smilecode_tpu_torch.convert import state_dict_from_jax
from smilecode_tpu_torch.models.registry import loss_plan
from smilecode_tpu_torch.train import make_loss_and_grads
from test_torch_bf16 import STEP_SHAPE, excited_model, smooth_vol
from test_torch_modet import jax_params

torch.set_num_threads(1)


def relative_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_modet_bf16_training_step_matches_jax_value_and_grad():
    """The port's bf16 step against ``jax.value_and_grad`` of the JAX bf16
    model (kernels A, B, C in interpret mode) on the same weights and pair.

    * The loss within 1e-2 relative.
    * Parameters and gradients are float32.
    * The gradients: a bf16 step's gradient is far from any other
      implementation's, element by element, because a flipped rounding in
      the attention cascade moves it. Measured here: each of the two bf16
      gradients is ~0.2 away from the float32 gradient in relative L2 over
      the parameters, and the worst parameter is several times the
      5e-2-of-its-largest-magnitude bound of one attention op (the test
      prints both). So the port's bf16 gradient is held to be no noisier
      than the JAX package's: its relative L2 distance to the float32
      gradient (the port's, equal to JAX's within 8e-6:
      tests/test_torch_train_step.py), over the parameters with a real
      gradient, is at most that of JAX's bf16 gradient.
    * The conv biases ahead of an instance norm (and the level-5 branch,
      which a 1^3 instance norm cuts off at 16^3) have a zero gradient but
      for rounding; the port's rounding there is at most JAX's (measured
      0.006 vs 0.18: JAX's CPU backward sums those reductions in bf16).
    """
    model = excited_model(30, compute_dtype="bfloat16")
    model32 = excited_model(30)
    moving, fixed = smooth_vol(STEP_SHAPE, 3), smooth_vol(STEP_SHAPE, 4)
    plan = loss_plan("modet")
    grads = {}
    for tag, m in (("bf16", model), ("f32", model32)):
        loss, _ = make_loss_and_grads(m, plan, (1.0, 1.0))(torch.from_numpy(moving),
                                                            torch.from_numpy(fixed))
        grads[tag] = {n: p.grad.numpy() for n, p in m.named_parameters()}
        if tag == "bf16":
            loss16 = float(loss)
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in model.parameters())

    jm = JaxModeT(qk_scale=1.0, attn_impl="pallas", compute_dtype="bfloat16")
    params = jax.tree.map(jnp.asarray, jax_params(model, STEP_SHAPE))

    def loss_fn(p, x, y):
        outs = jm.apply(p, x, y)
        return sum(JAX_CRITERIA[c](outs[n], y) for n, c in enumerate(plan.criterions))

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params, jnp.asarray(moving),
                                                           jnp.asarray(fixed))
    want = {n: w.numpy() for n, w in state_dict_from_jax(jax.tree.map(np.array, j_grads)).items()}
    assert set(want) == set(grads["bf16"])
    np.testing.assert_allclose(loss16, float(j_loss), rtol=1e-2)

    g32 = grads["f32"]
    floor = 1e-6 * max(np.abs(g).max() for g in g32.values())
    real = [n for n in g32 if np.abs(g32[n]).max() > floor]
    zero = [n for n in g32 if n not in real]
    assert real and all(n.endswith("main.bias") or "conv4" in n or "projblock5" in n for n in zero)

    def cat(gs, names):
        return np.concatenate([gs[n].ravel() for n in names])

    port = relative_l2(cat(grads["bf16"], real), cat(g32, real))
    jax_own = relative_l2(cat(want, real), cat(g32, real))
    between = relative_l2(cat(grads["bf16"], real), cat(want, real))
    zero_port = max(np.abs(grads["bf16"][n]).max() for n in zero)
    zero_jax = max(np.abs(want[n]).max() for n in zero)
    worst = max((float(np.abs(grads["bf16"][n] - want[n]).max() / (5e-2 * np.abs(want[n]).max())), n)
                for n in real)
    print(f"loss {loss16:.7f} vs JAX {float(j_loss):.7f}; relative L2 to the float32 gradient: "
          f"port bf16 {port:.4f}, JAX bf16 {jax_own:.4f} (port vs JAX bf16 {between:.4f}); "
          f"worst parameter, port vs JAX bf16, over 5e-2 of its largest magnitude: "
          f"{worst[0]:.2f} ({worst[1]}); zero-gradient parameters max |g|: port "
          f"{zero_port:.2e}, JAX {zero_jax:.2e}")
    assert port <= jax_own
    assert zero_port <= zero_jax
