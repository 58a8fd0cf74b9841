"""Port PRNet and PR++ vs the JAX package: `upsample2_nearest` and
`correlation3d` at odd, unequal shapes (the correlation's offsets pinned by
an impulse), the warp of a flow by a finer field (PR++'s composition: the
source coarser than the flow), the forwards at 32^3 (at 16^3 their coarsest
level is one voxel and the rescale degenerates), one training step each
(loss and every gradient vs ``jax.value_and_grad``), and `train.main` for
PR++ followed by both packages' `infer.main` on its checkpoint. Helpers and
tolerances: `test_torch_baselines.py`, `test_torch_baselines_train.py`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smilecode_tpu.models.prnet import correlation3d as jax_correlation3d
from smilecode_tpu.ops.resize import upsample2_nearest as jax_upsample2_nearest
from smilecode_tpu.ops.warp import warp as jax_warp
from smilecode_tpu_torch.models.prnet import correlation3d
from smilecode_tpu_torch.ops.resize import upsample2_nearest
from smilecode_tpu_torch.ops.warp import warp
from test_torch_baselines import assert_forward_matches_jax
from test_torch_baselines_train import (
    assert_step_matches_jax,
    assert_trained_checkpoint_infers_as_jax,
)

torch.set_num_threads(1)


def test_upsample2_nearest_matches_jax():
    x = np.random.default_rng(70).standard_normal((2, 3, 4, 5, 3)).astype(np.float32)
    got = upsample2_nearest(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_upsample2_nearest(jnp.asarray(x))))
    assert got.shape == (2, 6, 8, 10, 3)
    np.testing.assert_array_equal(got[:, 1::2, ::2, 1::2], x)


def test_correlation3d_matches_jax_at_odd_unequal_shapes():
    rng = np.random.default_rng(71)
    mov, fix = (rng.standard_normal((2, 5, 7, 9, 6)).astype(np.float32) for _ in range(2))
    got = correlation3d(torch.from_numpy(mov), torch.from_numpy(fix)).numpy()
    want = np.asarray(jax_correlation3d(jnp.asarray(mov), jnp.asarray(fix)))
    assert got.shape == want.shape == (2, 5, 7, 9, 27)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("delta", [(-2, -2, -2), (0, 0, 0), (2, 2, 2), (2, 0, -2), (-2, 2, 0)])
def test_correlation3d_offsets_pinned_by_an_impulse(delta):
    """Channel t = 9i + 3j + k correlates the moving map at x with the fixed
    map at x + (2i - 2, 2j - 2, 2k - 2): the offsets are {-2, 0, 2} per
    axis in both packages, not the {-3, -1, 1} that the JAX docstring names.
    An impulse in each map, ``delta`` apart, peaks (at 1) in that channel
    alone."""
    shape, p = (1, 9, 10, 11, 1), (4, 5, 5)
    mov, fix = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    mov[(0, *p, 0)] = 1.0
    fix[(0, *(a + b for a, b in zip(p, delta)), 0)] = 1.0
    got = correlation3d(torch.from_numpy(mov), torch.from_numpy(fix)).numpy()
    want = np.asarray(jax_correlation3d(jnp.asarray(mov), jnp.asarray(fix)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    total = got.sum(axis=(0, 1, 2, 3))
    t = int(np.ravel_multi_index(tuple((d + 2) // 2 for d in delta), (3, 3, 3)))
    assert np.argmax(total) == t and total[t] == pytest.approx(1.0, abs=1e-6)
    assert np.all(np.delete(total, t) < 0.5)


@pytest.mark.parametrize("src_shape,flow_shape", [((5, 6, 4), (9, 11, 7)),
                                                   ((4, 6, 5), (8, 12, 10))])
def test_warp_of_a_coarser_source_matches_jax(src_shape, flow_shape):
    """PR++'s ``T(flow, w)``: a source coarser than the flow, coordinates
    rescaled by (S-1)/(F-1) < 1, no magnitude rescale. Forward and both
    gradients vs ``jax.vjp`` of JAX `ops.warp` (the default, packed warp);
    flows of a few voxels cross cells in every direction."""
    rng = np.random.default_rng(72)
    src = rng.standard_normal((1, *src_shape, 3)).astype(np.float32)
    flow = rng.uniform(-3, 3, (1, *flow_shape, 3)).astype(np.float32)
    g = rng.standard_normal((1, *flow_shape, 3)).astype(np.float32)
    want, vjp = jax.vjp(jax_warp, jnp.asarray(src), jnp.asarray(flow))
    d_src, d_flow = vjp(jnp.asarray(g))
    st, ft = (torch.from_numpy(v).requires_grad_() for v in (src, flow))
    got = warp(st, ft)
    got.backward(torch.from_numpy(g))
    assert got.shape == (1, *flow_shape, 3)
    for a, b in ((got.detach(), want), (st.grad, d_src), (ft.grad, d_flow)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["prnet", "prnetplusplus"])
def test_forward_matches_jax_at_32(name):
    assert len(assert_forward_matches_jax(name, 73)) == 2


@pytest.mark.parametrize("name", ["prnet", "prnetplusplus"])
def test_step_matches_jax_value_and_grad(name):
    assert len(assert_step_matches_jax(name, 74)) == 2


def test_train_main_prnetplusplus_then_infer_main_matches_jax(tmp_path):
    assert_trained_checkpoint_infers_as_jax(tmp_path, "prnetplusplus", 75)


def test_registry_aliases_build_pr_plus_plus():
    from smilecode_tpu_torch.config import InferConfig
    from smilecode_tpu_torch.models import build_model

    ref = build_model("prnetplusplus", InferConfig(), device="meta")
    for alias in ("prnet++", "prpp", "PRNetPlusPlus"):
        model = build_model(alias, InferConfig(), device="meta")
        assert type(model) is type(ref) and list(model.state_dict()) == list(ref.state_dict())
