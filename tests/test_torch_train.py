"""The port's training driver and its parts vs the JAX package.

* AMSGrad: 3 steps against ``optax.amsgrad`` (1e-6 relative: the same
  float32 arithmetic in another library), and the step table that separates
  it from ``torch.optim.Adam(amsgrad=True)``; `poly_lr` and `resolve_weights`
  equal JAX's.
* The loader yields the JAX `Loader`'s batches in its order over 2 epochs,
  with 0 and 2 worker threads.
* `train.main` at 16^3 over 2 epochs: log files, metrics fields, the
  checkpoint (read by both packages' `load_checkpoint`, params on the JAX
  template), keep-``max_keep``, resume from a port and from a JAX checkpoint;
  and the loss decreases over steps on one pair.
"""

import json
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from smilecode_tpu.convert import convert_state_dict
from smilecode_tpu.data.loader import Loader as JaxLoader
from smilecode_tpu.models import ModeT as JaxModeT
from smilecode_tpu.train import poly_lr as jax_poly_lr
from smilecode_tpu.train import resolve_weights as jax_resolve_weights
from smilecode_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from smilecode_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from smilecode_tpu_torch import train
from smilecode_tpu_torch.config import InferConfig, TrainConfig, check_train_config
from smilecode_tpu_torch.convert import params_from_state_dict, state_dict_from_jax
from smilecode_tpu_torch.data import Loader
from smilecode_tpu_torch.data.trans import LPBA_SEG_TABLE
from smilecode_tpu_torch.models import ModeT
from smilecode_tpu_torch.models.registry import loss_plan
from smilecode_tpu_torch.optim import AMSGrad, poly_lr, resolve_weights
from smilecode_tpu_torch.utils import load_checkpoint, save_checkpoint

torch.set_num_threads(1)
SHAPE = (16, 16, 16)


def test_amsgrad_matches_optax_over_3_steps():
    rng = np.random.default_rng(40)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 2)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    grads[1]["b"][:] = 0.0  # a zero gradient still moves the moments
    lrs = [1e-2, 5e-3, 2e-3]  # the driver changes the rate between epochs

    params = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in init.items()}
    opt = AMSGrad(params.values(), lr=lrs[0])
    tx = optax.inject_hyperparams(lambda learning_rate: optax.amsgrad(learning_rate))(
        learning_rate=lrs[0])
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(j_params)
    for lr, g in zip(lrs, grads):
        for group in opt.param_groups:
            group["lr"] = lr
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k in shapes:
            np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(j_params[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert opt.count == 3 and int(state.inner_state[0].count) == 3
    saved = opt.state_by_name(params.items())
    for key in ("mu", "nu", "nu_max"):
        for k in shapes:
            np.testing.assert_allclose(saved[key][k], np.asarray(getattr(state.inner_state[0], key)[k]),
                                       rtol=1e-6, atol=1e-12)


def test_amsgrad_is_not_torch_adam_amsgrad():
    """lr 1e-2, gradients 1, 0, 0.5 on one parameter: optax's rule (the
    port's) and torch's agree on step 1 only."""
    ours, theirs = torch.zeros(1, requires_grad=True), torch.zeros(1, requires_grad=True)
    opt, adam = AMSGrad([ours], lr=1e-2), torch.optim.Adam([theirs], lr=1e-2, amsgrad=True)
    got, torch_got = [], []
    for g in (1.0, 0.0, 0.5):
        ours.grad, theirs.grad = torch.tensor([g]), torch.tensor([g])
        opt.step()
        adam.step()
        got.append(float(ours.detach()))
        torch_got.append(float(theirs.detach()))
    np.testing.assert_allclose(got, [-0.0100, -0.01474, -0.01957], atol=5e-6)
    np.testing.assert_allclose(torch_got, [-0.0100, -0.01670, -0.02419], atol=5e-6)


def test_amsgrad_state_round_trips_by_name():
    model = torch.nn.Linear(3, 2)
    opt = AMSGrad(model.parameters(), lr=1e-3)
    model(torch.ones(4, 3)).sum().backward()
    opt.step()
    saved = opt.state_by_name(model.named_parameters())
    assert set(saved["mu"]) == {"weight", "bias"} and saved["count"] == 1
    fresh = AMSGrad(model.parameters(), lr=1e-3)
    fresh.load_state_by_name(model.named_parameters(), saved)
    again = fresh.state_by_name(model.named_parameters())
    assert again["count"] == 1
    for key in ("mu", "nu", "nu_max"):
        for name in saved[key]:
            np.testing.assert_array_equal(again[key][name], saved[key][name])


def test_poly_lr_and_resolve_weights_match_jax():
    for epoch in range(0, 30, 7):
        assert poly_lr(epoch, 30, 1e-4) == jax_poly_lr(epoch, 30, 1e-4)
    assert poly_lr(3, 7, 3e-4, 0.5) == jax_poly_lr(3, 7, 3e-4, 0.5)
    for weights, n in (((1.0, 1.0), 2), ((1.0, 0.5), 5), ((2.0,), 3), ((1.0, 2.0, 3.0), 2)):
        assert resolve_weights(weights, n) == jax_resolve_weights(weights, n)
    with pytest.raises(ValueError):
        resolve_weights((), 2)


class Indexed:
    """Items tagged with their index; an optional delay jitters the workers."""

    def __init__(self, n, delay=0.0, fail_at=None):
        self.n, self.delay, self.fail_at = n, delay, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.delay:
            time.sleep(self.delay * ((i * 7) % 3))
        if i == self.fail_at:
            raise KeyError(i)
        return (np.full((1, 2, 2, 2), i, np.float32), np.full((1, 2, 2, 2), -i, np.int16))


def batch_ids(batches):
    return [tuple(int(v) for v in b[0][:, 0, 0, 0, 0]) for b in batches]


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_order_matches_jax_over_two_epochs(num_workers, drop_last):
    ds = Indexed(11)
    ours = Loader(ds, batch_size=3, shuffle=True, seed=24, num_workers=num_workers,
                  drop_last=drop_last)
    theirs = JaxLoader(ds, batch_size=3, shuffle=True, seed=24, num_workers=num_workers,
                       drop_last=drop_last, device_put=False)
    assert len(ours) == len(theirs)
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert batch_ids(got) == batch_ids(want)
        assert len(got) == len(ours)
        for g, w in zip(got, want):
            assert g[0].shape == (len(w[0]), 2, 2, 2, 1) and g[1].dtype == torch.int16
            np.testing.assert_array_equal(g[1].numpy(), w[1])
    assert batch_ids(Loader(ds, batch_size=4)) == [(0, 1, 2, 3), (4, 5, 6, 7), (8, 9, 10)]


def test_loader_keeps_order_with_many_threads_and_raises_worker_errors():
    threads_before = threading.active_count()
    ds = Indexed(24, delay=0.002)
    got = batch_ids(Loader(ds, batch_size=2, shuffle=True, seed=3, num_workers=16, prefetch=1))
    want = batch_ids(Loader(ds, batch_size=2, shuffle=True, seed=3, num_workers=0))
    assert got == want
    it = iter(Loader(Indexed(10), batch_size=1, num_workers=3))
    next(it)
    it.close()  # an abandoned epoch joins its workers
    with pytest.raises(KeyError):
        list(Loader(Indexed(8, fail_at=5), batch_size=2, num_workers=2))
    assert threading.active_count() == threads_before


def write_subjects(root, n_train=3, n_val=2, seed=41):
    rng = np.random.default_rng(seed)
    for split, n in (("Train", n_train), ("Val", n_val)):
        (root / split).mkdir(parents=True)
        for i in range(n):
            img = torch.nn.functional.interpolate(
                torch.from_numpy(rng.random((1, 1, 4, 4, 4)).astype(np.float32)),
                size=SHAPE, mode="trilinear", align_corners=True)[0, 0].numpy()
            seg = LPBA_SEG_TABLE[(img * 54.99).astype(np.int64)].astype(np.uint16)
            with open(root / split / f"subject_{i:02d}.pkl", "wb") as f:
                pickle.dump((img, seg), f)


def config(root, **kw):
    kw.setdefault("num_workers", 2)
    kw.setdefault("device", "cpu")
    return TrainConfig(train_dir=str(root / "Train"), val_dir=str(root / "Val"),
                       save_root=str(root / "experiments"), log_root=str(root / "logs"), **kw)


def jax_template():
    vol = jnp.zeros((1, *SHAPE, 1), jnp.float32)
    return jax.eval_shape(JaxModeT(qk_scale=1.0).init, jax.random.PRNGKey(0), vol, vol)


def test_train_main_two_epochs_then_resume(tmp_path, capsys):
    write_subjects(tmp_path)
    cfg = config(tmp_path, max_epoch=2, lr=1e-3)
    best = train.main(cfg)
    assert 0.0 <= best <= 1.0
    log_dir = tmp_path / "logs" / cfg.save_dir
    exp_dir = tmp_path / "experiments" / cfg.save_dir
    assert cfg.save_dir == "modet-heads(84211)-rpe_headim_6_ncc_1.0_reg_1.0_lr_0.001_54r/"
    log = (log_dir / "logfile.log").read_text()
    assert log.count("Training Starts") == 2 and "Iter 6 of 6 loss" in log
    rows = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in rows if "iter" in r]
    assert len(steps) == 12 and set(steps[0]) == {"epoch", "iter", "loss", "sim", "reg", "lr",
                                                  "step_ms", "ts"}
    assert [r["lr"] for r in steps[::6]] == [poly_lr(0, 2, 1e-3), poly_lr(1, 2, 1e-3)]
    epochs = [r for r in rows if "val_dice" in r]
    assert [set(r) for r in epochs] == [{"epoch", "val_dice", "best_dice", "epoch_s", "ts"}] * 2
    assert len((log_dir / "losses and dice.txt").read_text().splitlines()) == 2

    ckpts = sorted(p.name for p in exp_dir.glob("*.ckpt"))
    assert ckpts and all(p.startswith("dsc") for p in ckpts)
    path = str(exp_dir / ckpts[-1])
    ours, theirs = load_checkpoint(path), jax_load_checkpoint(path)
    assert ours["epoch"] == theirs["epoch"] == 2 and ours["opt_state"]["count"] == 12
    assert ours["config"]["lr"] == 1e-3
    template = jax_template()
    assert jax.tree.structure(theirs["params"]) == jax.tree.structure(template)
    for leaf, t in zip(jax.tree.leaves(theirs["params"]), jax.tree.leaves(template)):
        assert leaf.shape == t.shape and leaf.dtype == t.dtype
    # the JAX converter maps the port's state_dict onto the template to the same params
    again = convert_state_dict(state_dict_from_jax(ours["params"]), template)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(theirs["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert set(ours["opt_state"]["mu"]) == set(state_dict_from_jax(ours["params"]))

    capsys.readouterr()
    cfg.cont_training, cfg.max_epoch = True, 3
    train.main(cfg)
    out = capsys.readouterr().out
    assert "resumed from" in out and "at epoch 2" in out and out.count("Training Starts") == 1
    latest = load_checkpoint(str(sorted(exp_dir.glob("*.ckpt"), key=os.path.getmtime)[-1]))
    assert latest["epoch"] == 3 and latest["opt_state"]["count"] == 18


def test_train_main_resumes_a_jax_checkpoint(tmp_path, capsys):
    """Params, epoch and best_dsc come back; the optax moments restart."""
    write_subjects(tmp_path, n_train=2, n_val=2)
    cfg = config(tmp_path, max_epoch=2, cont_training=True, num_workers=0)
    exp_dir = tmp_path / "experiments" / cfg.save_dir
    model = ModeT(qk_scale=1.0, generator=torch.Generator().manual_seed(42))
    params = jax.tree.map(jnp.asarray, params_from_state_dict(model.state_dict()))
    jax_save_checkpoint({"epoch": 1, "params": params, "best_dsc": 0.25,
                         "opt_state": optax.amsgrad(1e-4).init(params)}, str(exp_dir),
                        "dsc0.250.ckpt")
    best = train.main(cfg)
    out = capsys.readouterr().out
    assert "AMSGrad moments restart" in out and "at epoch 1" in out
    assert out.count("Training Starts") == 1 and best >= 0.25
    ckpt = load_checkpoint(str(sorted(exp_dir.glob("*.ckpt"), key=os.path.getmtime)[-1]))
    assert ckpt["epoch"] == 2 and ckpt["opt_state"]["count"] == 2


def test_save_checkpoint_keeps_the_last_natsorted_like_jax(tmp_path):
    names = [f"dsc0.{v:03d}.ckpt" for v in (700, 95, 5, 810, 120, 64, 999, 300, 42, 7)]
    for d, save in (("ours", save_checkpoint), ("theirs", jax_save_checkpoint)):
        for i, name in enumerate(names):
            save({"epoch": i}, str(tmp_path / d), name, max_keep=8)
    kept = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert kept == sorted(p.name for p in (tmp_path / "theirs").iterdir())
    assert len(kept) == 8 and "dsc0.005.ckpt" not in kept and "dsc0.007.ckpt" not in kept


def test_loss_decreases_on_one_pair():
    rng = np.random.default_rng(43)
    base = torch.nn.functional.interpolate(
        torch.from_numpy(rng.random((1, 1, 4, 4, 4)).astype(np.float32)), size=SHAPE,
        mode="trilinear", align_corners=True)
    fixed = base.permute(0, 2, 3, 4, 1).contiguous()
    moving = torch.roll(fixed, shifts=(1, -1), dims=(1, 2))
    model = ModeT(qk_scale=1.0, generator=torch.Generator().manual_seed(44))
    opt = AMSGrad(model.parameters(), lr=1e-3)
    step = train.make_train_step(model, loss_plan("modet"), opt, (1.0, 1.0))
    losses = [float(step(moving, fixed)[0]) for _ in range(12)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0] - 0.01, losses


def test_unported_knobs_raise():
    """Multi-GPU is ported (`tests/test_torch_dp.py`, `test_torch_spatial.py`):
    dp and spatial pass, and the combinations JAX refuses raise."""
    for kw in ({"dp": 2}, {"spatial": 2}, {"dp": 2, "spatial": 2}):
        check_train_config(TrainConfig(**kw))
    for kw, match in (({"spatial": 2, "model": "pcnet"}, "ModeT"),
                      ({"spatial": 2, "compute_dtype": "bfloat16"}, "float32 only"),
                      ({"dp": 0}, "dp and spatial")):
        with pytest.raises(ValueError, match=match):
            check_train_config(TrainConfig(**kw))
    for dataset in ("half", "atlas"):  # ported: the dataset variants pass
        check_train_config(TrainConfig(dataset=dataset, atlas_path="atlas.pkl"))
    check_train_config(TrainConfig(compute_dtype="bfloat16"))  # the bf16 path is ported
    with pytest.raises(ValueError, match="compute_dtype"):
        check_train_config(TrainConfig(compute_dtype="float16"))


def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """``device`` defaults to "cuda": without a card `train.main` and
    `infer.main` raise, and never fall back to the CPU unasked."""
    from smilecode_tpu_torch import infer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TrainConfig().device == "cuda" and InferConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="device=cpu"):
        train.main(config(tmp_path, device="cuda"))
    with pytest.raises(RuntimeError, match="device=cpu"):
        infer.main(InferConfig(test_dir=str(tmp_path), model_dir=str(tmp_path), device="cuda"))
    assert not (tmp_path / "experiments").exists()
