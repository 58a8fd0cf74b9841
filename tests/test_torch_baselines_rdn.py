"""Port RDN forwards vs JAX ``apply`` at 32^3 (stages 2, levels
(2, 1, 1, 2)) in all four share x diff combinations, on converted JAX
params, every output included (the per-stage flows, or ``sv`` with diff);
and `smilecode_tpu_torch.infer.main` vs `smilecode_tpu.infer.main` on RDN
(helpers and tolerances: `test_torch_baselines.py`)."""

import pytest
import torch

from test_torch_baselines import RDN_SMALL, assert_infer_mains_agree, assert_forward_matches_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["rdn", "rdn_share", "rdn_diff", "rdn_diff_share"])
def test_rdn_forward_matches_jax_at_32(name):
    outs = assert_forward_matches_jax(name, 30)
    assert len(outs) == 2 + RDN_SMALL["stages"]
    assert outs[2].shape == (1, 16, 16, 16, 3)  # per-stage fields at half resolution


def test_infer_main_rdn_matches_jax_infer_main(tmp_path):
    assert_infer_mains_agree(tmp_path, "rdn", 31, **RDN_SMALL)
