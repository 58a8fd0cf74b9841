"""Port losses vs the JAX package: `ncc_vxm` and `grad3d` (l1, l2,
``loss_mult``), value and gradient, on the same numpy inputs.

Tolerances: NCC value 1e-5 relative (float32 box sums of 729 terms added in
the same order, then the same algebra; only rounding of the elementwise
steps differs), NCC gradient 1e-4 relative to its largest entry; grad3d value
1e-6 relative and gradient 1e-6 absolute (a few float32 terms).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smilecode_tpu.losses import grad3d as jax_grad3d
from smilecode_tpu.losses import ncc_vxm as jax_ncc
from smilecode_tpu.models.registry import CRITERIA as JAX_CRITERIA
from smilecode_tpu_torch.losses import grad3d, ncc_vxm
from smilecode_tpu_torch.models.registry import CRITERIA, LossPlan, loss_plan

torch.set_num_threads(1)


def volumes(shape, c, seed):
    rng = np.random.default_rng(seed)
    smooth = np.cumsum(rng.standard_normal((2, 1, *shape, c)), axis=2)  # correlated rows
    return [(a / np.abs(a).max()).astype(np.float32) for a in smooth]


def value_and_grad_torch(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    val = fn(*ts)
    val.backward()
    return float(val.detach()), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("shape,c,win", [((12, 10, 11), 1, 9), ((9, 14, 8), 2, 9), ((8, 8, 8), 1, 5)])
def test_ncc_matches_jax_value_and_grad(shape, c, win):
    a, b = volumes(shape, c, seed=1)
    val, (ga, gb) = value_and_grad_torch(lambda x, y: ncc_vxm(x, y, win), a, b)
    jval, (jga, jgb) = jax.value_and_grad(lambda x, y: jax_ncc(x, y, win), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    assert val < 0
    np.testing.assert_allclose(val, float(jval), rtol=1e-5)
    for g, jg in ((ga, jga), (gb, jgb)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g, jg, rtol=0, atol=1e-4 * np.abs(jg).max())


@pytest.mark.parametrize("penalty,loss_mult", [("l1", None), ("l2", None), ("l2", 2.5)])
def test_grad3d_matches_jax_value_and_grad(penalty, loss_mult):
    (flow,) = volumes((7, 9, 6), 3, seed=2)[:1]
    flow = flow * 4.0
    val, (g,) = value_and_grad_torch(lambda f: grad3d(f, penalty, loss_mult), flow)
    jval, jg = jax.value_and_grad(lambda f: jax_grad3d(f, penalty, loss_mult))(jnp.asarray(flow))
    np.testing.assert_allclose(val, float(jval), rtol=1e-6)
    np.testing.assert_allclose(g, np.asarray(jg), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="penalty"):
        grad3d(torch.from_numpy(flow), "l3")


@pytest.mark.parametrize("loss_mult", [None, 2.5])
def test_grad3d_l1_gradient_at_equal_neighbours_matches_jax(loss_mult):
    """Equal neighbours: ``jnp.abs``'s derivative at 0 is +1, where
    ``torch.abs``'s is 0, so a constant region's forward differences carry
    gradient. The flow has zero slabs along D (a zero-initialised head or a
    warp's out-of-volume zeros), a constant block and a plane constant
    along W; ties along every axis. Same tolerances as above."""
    (flow,) = volumes((6, 7, 8), 3, seed=5)[:1]
    flow[:, :2] = 0.0
    flow[:, 3:5, 2:6, 1:7] = 0.25
    flow[:, 5, :, :, 1] = flow[:, 5, :, :1, 1]
    val, (g,) = value_and_grad_torch(lambda f: grad3d(f, "l1", loss_mult), flow)
    jval, jg = jax.value_and_grad(lambda f: jax_grad3d(f, "l1", loss_mult))(jnp.asarray(flow))
    np.testing.assert_allclose(val, float(jval), rtol=1e-6)
    np.testing.assert_allclose(g, np.asarray(jg), rtol=0, atol=1e-6)
    assert np.abs(np.asarray(jg)).max() > 1e3 * 1e-6


def test_criteria_and_modet_plan_match_jax():
    moved, fixed = volumes((10, 10, 10), 1, seed=3)
    (flow,) = volumes((10, 10, 10), 3, seed=4)[:1]
    assert set(CRITERIA) == set(JAX_CRITERIA)
    for name, pred in (("ncc", moved), ("grad_l2", flow)):
        got = float(CRITERIA[name](torch.from_numpy(pred), torch.from_numpy(fixed)))
        want = float(JAX_CRITERIA[name](jnp.asarray(pred), jnp.asarray(fixed)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    plan = loss_plan("modet-cu")
    assert plan == loss_plan("modet") and plan.criterions == ("ncc", "grad_l2")
    outs = ("moved", "flow")
    assert plan.select_train_outputs(outs) == outs
    assert isinstance(plan, LossPlan)
    rcn = loss_plan("rcn")  # the reference's 10 cascades; the composed flow is dropped
    assert rcn.criterions == ("ncc",) + ("grad_l2",) * 10
    assert rcn.select_train_outputs(("moved", "flow", "w1", "w2")) == ("moved", "w1", "w2")
    with pytest.raises(ValueError, match="unknown"):
        loss_plan("nope")
