"""Data-parallel training of the port (`train.py`, ``dp=N``) on the CPU.

Ranks are gloo processes on the CPU (`parallel.mesh.run_ranks`, a
``file://`` store), full-width ModeT at 16^3 with excited projections and
rpb:

* The dp=2 step (each rank its row of a batch of 2, loss, terms and
  gradients averaged over "data") against one process on the whole batch:
  loss and terms within 1e-5 relative and every gradient within 1e-4 of its
  largest + 1e-6 of the model's (`tests/test_torch_train_step.py`'s
  tolerances: the same function summed in another order); after two
  AMSGrad steps at lr 1e-3 the parameters are the same bits on both ranks,
  and equal the one process's after the same two steps. In
  float64 on both sides, as the baselines' step tests compare gradients:
  in float32 the conv biases ahead of an instance norm, whose exact
  gradient is zero, carry up to 6.5e-7 of rounding in the batch-2 step, 1.3
  times the 1e-6 floor at these weights.
* The same ranks' loss and gradients against JAX `train.make_train_step`
  with ``mesh=make_mesh(2)`` (shard_map over "data", pmean) on the same
  weights (`convert_state_dict`) and batch, float64 on both sides, at the
  same tolerances. The JAX step's optimizer is a transformation that keeps
  the gradients as its state, so the step returns the pmean'd gradients
  themselves.
* `train.main(dp=2, batch_size=2)` against `train.main(dp=1, batch_size=2)`
  over two epochs at a learning rate of 0: the same per-step losses and
  terms (1e-5 relative), the same validation Dice and the same checkpoint:
  the parameters bit for bit, and AMSGrad's moments, which hold every
  step's averaged gradients, within 1e-4 of each one's largest + 1e-6 of
  the model's. At a learning rate above 0 the two runs part: float32
  rounding of the two summation orders gives different noise in the
  gradient components whose exact value is 0 (conv biases ahead of an
  instance norm, projection biases along LayerNorm's mean), and AMSGrad
  moves such a component by about the learning rate whatever its size, so
  after 6 steps at 1e-3 the parameters differ by up to 4e-3 and the losses
  by 1.4%.
* Each check that `train.main` makes before any rank starts raises
  `ValueError`.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_ranks as R
from smilecode_tpu.convert import convert_state_dict
from smilecode_tpu.config import TrainConfig as JaxTrainConfig
from smilecode_tpu.models.registry import build_model as jax_build_model
from smilecode_tpu.parallel.mesh import make_mesh
from smilecode_tpu.train import make_train_step as jax_make_train_step
from smilecode_tpu_torch import train
from smilecode_tpu_torch.config import TrainConfig
from smilecode_tpu_torch.convert import state_dict_from_jax
from smilecode_tpu_torch.models.registry import loss_plan
from smilecode_tpu_torch.optim import AMSGrad
from smilecode_tpu_torch.parallel import mesh as M
from smilecode_tpu_torch.utils import latest_checkpoint, load_checkpoint

torch.set_num_threads(1)
SHAPE = (16, 16, 16)
SEED = 7


@pytest.fixture(scope="module")
def dp_ranks():
    return M.run_ranks(R.dp_steps, 2, 1, "cpu", args=(SHAPE, SEED, torch.float64), threads=1)


def assert_grads_close(grads, want):
    floor = 1e-6 * max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    assert set(grads) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(grads[name]), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + floor, err_msg=name)


def test_dp2_step_matches_one_process_on_the_concatenated_batch(dp_ranks):
    model, x, y = R.modet_and_pair(SHAPE, 2, SEED, torch.float64)
    step = train.make_train_step(model, loss_plan("modet"), AMSGrad(model.parameters(), lr=1e-3),
                                 (1.0, 1.0))
    loss, vals = step(x, y)
    (first0, params0), (first1, params1) = dp_ranks
    assert first0["loss"] == first1["loss"] and first0["vals"] == first1["vals"]
    np.testing.assert_allclose(first0["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(first0["vals"], [float(v) for v in vals], rtol=1e-5)
    assert_grads_close({n: g.numpy() for n, g in first0["grads"].items()},
                       {n: p.grad.numpy() for n, p in model.named_parameters()})
    for name, p in params0.items():
        assert torch.equal(p, params1[name]), name
        assert torch.equal(first0["grads"][name], first1["grads"][name]), name


def test_dp2_parameters_after_two_amsgrad_steps_match_one_process(dp_ranks):
    """The dp=2 update itself: two AMSGrad steps at lr 1e-3 on each rank's
    row against two on the whole batch in one process, float64. A component
    with a nonzero gradient moves alike to ~1e-15. One whose exact gradient
    is 0 (a conv bias ahead of an instance norm) carries rounding noise of
    at most ~1e-16 in either run, which AMSGrad moves by lr * noise / eps
    (eps 1e-8) per step: at most 2e-11 over the two steps (6e-12 seen).
    So every parameter within 2e-11 + 1e-12 of its largest magnitude; a
    missing or doubled update moves it by ~1e-3."""
    model, x, y = R.modet_and_pair(SHAPE, 2, SEED, torch.float64)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = train.make_train_step(model, loss_plan("modet"), AMSGrad(model.parameters(), lr=1e-3),
                                 (1.0, 1.0))
    for _ in range(2):
        step(x, y)
    params0 = dp_ranks[0][1]
    moved = 0.0
    for name, p in model.named_parameters():
        want = p.detach().numpy()
        np.testing.assert_allclose(params0[name].numpy(), want, rtol=0,
                                   atol=2e-11 + 1e-12 * np.abs(want).max(), err_msg=name)
        moved = max(moved, float((p.detach() - before[name]).abs().max()))
    assert moved > 1e-4  # the steps did move the parameters (by ~2 lr)


def _grads_as_state():
    """An optax transformation that leaves the parameters and keeps the
    gradients of the last update as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def test_dp2_step_matches_jax_make_train_step_on_a_data_mesh(dp_ranks):
    model, x, y = R.modet_and_pair(SHAPE, 2, SEED, torch.float64)
    spec = jax_build_model("modet", JaxTrainConfig(attn_impl="xla"))
    vol = jnp.zeros((1, *SHAPE, 1), jnp.float32)
    template = jax.eval_shape(spec.module.init, jax.random.PRNGKey(0), vol, vol)
    with jax.enable_x64():
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              convert_state_dict(model.state_dict(), template))
        tx = _grads_as_state()
        step = jax_make_train_step(spec, tx, [1.0, 1.0], mesh=make_mesh(2))
        _, grads, loss, vals = step(params, tx.init(params), jnp.asarray(x.numpy()),
                                    jnp.asarray(y.numpy()))
    first = dp_ranks[0][0]
    np.testing.assert_allclose(first["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(first["vals"], [float(v) for v in vals], rtol=1e-4)
    assert_grads_close({n: g.numpy() for n, g in first["grads"].items()},
                       state_dict_from_jax(jax.tree.map(np.asarray, grads)))


def _steps(cfg):
    path = f"{cfg.log_root}/{cfg.save_dir}/metrics.jsonl"
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if "iter" in r], [r for r in rows if "val_dice" in r]


def test_train_main_dp2_equals_dp1_at_batch_2_over_two_epochs(tmp_path):
    R.write_subjects(tmp_path / "data", SHAPE)
    runs = {}
    for dp in (1, 2):
        root = tmp_path / f"dp{dp}"
        cfg = TrainConfig(train_dir=str(tmp_path / "data" / "Train"),
                          val_dir=str(tmp_path / "data" / "Val"), save_root=str(root / "exp"),
                          log_root=str(root / "logs"), batch_size=2, dp=dp, max_epoch=2,
                          lr=0.0, num_workers=0, device="cpu")
        best = train.main(cfg)
        ckpt = load_checkpoint(latest_checkpoint(f"{cfg.save_root}/{cfg.save_dir}"))
        runs[dp] = (best, _steps(cfg), ckpt)
    (best1, (steps1, epochs1), ck1), (best2, (steps2, epochs2), ck2) = runs[1], runs[2]
    assert len(steps1) == len(steps2) == 6  # 6 pairs, batch 2, two epochs
    for a, b in zip(steps1, steps2):
        for key in ("loss", "sim", "reg"):
            np.testing.assert_allclose(b[key], a[key], rtol=1e-5, err_msg=key)
    assert [e["val_dice"] for e in epochs2] == [e["val_dice"] for e in epochs1]
    assert best2 == best1
    assert ck1["epoch"] == ck2["epoch"] == 2
    assert ck1["opt_state"]["count"] == ck2["opt_state"]["count"] == 6
    p1, p2 = state_dict_from_jax(ck1["params"]), state_dict_from_jax(ck2["params"])
    assert set(p1) == set(p2)
    for name in p1:
        assert torch.equal(p1[name], p2[name]), name
    for key in ("mu", "nu", "nu_max"):
        want = {n: np.asarray(v) for n, v in ck1["opt_state"][key].items()}
        floor = 1e-6 * max(float(np.abs(v).max()) for v in want.values())
        for name, a in want.items():
            np.testing.assert_allclose(np.asarray(ck2["opt_state"][key][name]), a, rtol=0,
                                       atol=1e-4 * np.abs(a).max() + floor,
                                       err_msg=f"{key} {name}")


RAISES = {
    "batch that dp does not divide": (dict(dp=2, batch_size=3), "shard_batch"),
    "trailing partial batch that dp does not divide": (
        dict(dp=2, batch_size=2, dataset="atlas"), "shard_batch"),
    "spatial with a baseline": (dict(spatial=2, model="pcnet"), "ModeT"),
    "spatial with bfloat16": (dict(spatial=2, compute_dtype="bfloat16"), "float32 only"),
    "spatial with a D that 16*spatial does not divide": (dict(spatial=2), "divisible by 16"),
}


@pytest.mark.parametrize("case", list(RAISES))
def test_multi_rank_checks_raise_before_any_rank_starts(tmp_path, case):
    """JAX's `train.main` raises for each (its `shard_batch` on an uneven
    batch, `train.py:234-244` for spatial); the port raises `ValueError`
    in the calling process, before it spawns a rank."""
    kw, match = RAISES[case]
    R.write_subjects(tmp_path, SHAPE)  # D = 16: not a multiple of 16 * 2
    atlas = tmp_path / "Val" / "subject_00.pkl"
    cfg = TrainConfig(train_dir=str(tmp_path / "Train"), val_dir=str(tmp_path / "Val"),
                      save_root=str(tmp_path / "exp"), log_root=str(tmp_path / "logs"),
                      device="cpu", atlas_path=str(atlas), **kw)
    with pytest.raises(ValueError, match=match):
        train.main(cfg)
    assert not (tmp_path / "exp").exists()
