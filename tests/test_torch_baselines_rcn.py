"""Port VTN and RCN forwards vs JAX ``apply`` at 64^3 on converted JAX
params (helpers and tolerances: `test_torch_baselines.py`). VTN's five
``Upsamp*`` are square ConvTranspose3d(3, 3): loaded with a Conv3d's
layout, as `state_dict_from_jax` without the model would, the forward
differs from JAX's."""

import numpy as np
import pytest
import torch

from test_torch_baselines import (
    MODELS,
    assert_forward_matches_jax,
    jax_template,
    pair,
    port_model,
    random_jax_params,
)
from smilecode_tpu_torch.convert import state_dict_from_jax

torch.set_num_threads(1)


def test_vtn_forward_matches_jax_at_64():
    outs = assert_forward_matches_jax("vtn", 20)
    # the Conv3d layout that a converter reading shapes alone gives Upsamp*
    params = random_jax_params(jax_template("vtn"), 20)
    model = port_model("vtn")
    wrong = state_dict_from_jax(params, model)
    for lvl in range(6, 1, -1):
        kernel = params["params"][f"Upsamp{lvl}to{lvl - 1}"]["kernel"]
        wrong[f"Upsamp{lvl}to{lvl - 1}.upconv.weight"] = torch.from_numpy(
            kernel.transpose(4, 3, 0, 1, 2).copy())
    model.load_state_dict(wrong, strict=True)
    moving, fixed = pair(MODELS["vtn"][2], 21)
    with torch.no_grad():
        bad = model(torch.from_numpy(moving), torch.from_numpy(fixed))
    assert float((bad[1] - outs[1]).abs().max()) > 1e-2


@pytest.mark.parametrize("name", ["rcn"])
def test_rcn_forward_matches_jax_at_64(name):
    """RCN with 2 cascades: (moved, flow, subflow 0, subflow 1)."""
    outs = assert_forward_matches_jax(name, 22)
    assert len(outs) == 4
    np.testing.assert_array_equal(outs[2].shape, outs[1].shape)
