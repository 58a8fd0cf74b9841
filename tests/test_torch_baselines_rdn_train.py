"""Training of the port's RDN vs the JAX package: loss and every gradient
of one step against ``jax.value_and_grad`` at 32^3, stages 2 and levels
(2, 1, 1, 2), with and without diff and weight sharing at the two ends
(rdn, rdn_diff_share). Helper and tolerances:
`test_torch_baselines_train.py`."""

import pytest
import torch

from test_torch_baselines import RDN_SMALL
from test_torch_baselines_train import assert_step_matches_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["rdn", "rdn_diff_share"])
def test_rdn_step_matches_jax_value_and_grad(name):
    vals = assert_step_matches_jax(name, 52)
    assert len(vals) == 1 + RDN_SMALL["stages"]  # ncc + grad_l2 per stage
