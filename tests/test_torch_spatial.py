"""D-sharded ModeT training of the port (``spatial=N``) on the CPU.

Ranks are gloo processes (`parallel.mesh.run_ranks`, a ``file://`` store).
Full-width ModeT (channels 4, head_dim 6, heads 8/4/2/1/1, qk_scale 1) with
excited projections and rpb at 32x16x16 (D a multiple of 16 * 2), float64
unless named, so that sharded and unsharded agree to their rounding:

* The spatial=2 forward against the unsharded port (flow and moved image
  within 1e-9) and against JAX `parallel.modet_sp.modet_forward_spatial`
  on 2 of the conftest's 8 CPU devices with float64 parameters (atol 2e-4,
  rtol 1e-3, `tests/test_modet_sp.py`'s: JAX's sharded warp takes float32
  coordinates, 1.7e-5 of the port's float64 here).
* `ncc_sp` and `grad3d_sp` (l1, l2) summed over the shards against the
  unsharded `ncc_vxm` and `grad3d`, values and gradients (1e-12).
* The spatial=2 loss and every gradient against the unsharded port step
  (loss 1e-10 relative, gradients 1e-7 of each largest + 1e-9 of the
  model's) and against JAX `make_spatial_loss_and_grads` with the XLA
  attention oracle, float64 (`tests/test_modet_planes_sp.py::
  test_spatial_train_loss_grads_equal_unsharded`'s set-up; loss 1e-6
  relative, gradients 1e-4 of each largest + 1e-6 of the model's: JAX's
  float32 warp coordinates again).
* One dp=2 x spatial=2 step on 4 ranks against the unsharded batch-2 step
  (the same gates as the spatial=2 step).
* `train.main(spatial=2)` and `train.main(dp=2, spatial=2)` (float32)
  against the unsharded `train.main` at batch 1 and 2, one epoch at a
  learning rate of 0: per-step losses within 1e-5 relative, validation Dice
  equal, parameters bit for bit, AMSGrad's moments within 1e-3 of each
  one's largest + 1e-6 of the model's (the sharded and unsharded float32
  gradients: phase 9's gate on the card).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ranks as R
from smilecode_tpu.convert import convert_state_dict
from smilecode_tpu.models import ModeT as JaxModeT
from smilecode_tpu_torch import train
from smilecode_tpu_torch.config import TrainConfig
from smilecode_tpu_torch.convert import state_dict_from_jax
from smilecode_tpu_torch.losses import grad3d, ncc_vxm
from smilecode_tpu_torch.models.registry import loss_plan
from smilecode_tpu_torch.parallel import mesh as M
from smilecode_tpu_torch.utils import latest_checkpoint, load_checkpoint

torch.set_num_threads(1)
SHAPE = (32, 16, 16)
SEED = 3


@pytest.fixture(scope="module")
def sp2():
    return M.run_ranks(R.spatial_forward_and_step, 1, 2, "cpu",
                       args=(SHAPE, 1, torch.float64, SEED), threads=1)


def jax_params(model):
    vol = jnp.zeros((1, *SHAPE, 1), jnp.float32)
    template = jax.eval_shape(JaxModeT(qk_scale=1.0).init, jax.random.PRNGKey(0), vol, vol)
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                        convert_state_dict(model.state_dict(), template))


def assert_grads_close(grads, want, rel, floor_rel):
    floor = floor_rel * max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    assert set(grads) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(grads[name]), w, rtol=0,
                                   atol=rel * np.abs(w).max() + floor, err_msg=name)


def unsharded_step(batch):
    model, x, y = R.modet_and_pair(SHAPE, batch, SEED, torch.float64)
    loss, _ = train.make_loss_and_grads(model, loss_plan("modet"), (1.0, 1.0))(x, y)
    return model, x, y, float(loss), {n: p.grad.numpy() for n, p in model.named_parameters()}


def test_spatial2_forward_matches_the_unsharded_port_and_jax(sp2):
    from smilecode_tpu.parallel.mesh import make_mesh
    from smilecode_tpu.parallel.modet_sp import modet_forward_spatial

    model, x, y = R.modet_and_pair(SHAPE, 1, SEED, torch.float64)
    with torch.no_grad():
        moved, flow = model(x, y)
    s_moved = torch.cat([r["moved"] for r in sp2], 1)
    s_flow = torch.cat([r["flow"] for r in sp2], 1)
    assert float(flow.abs().max()) > 1.0  # a real deformation
    np.testing.assert_allclose(s_flow.numpy(), flow.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(s_moved.numpy(), moved.numpy(), rtol=0, atol=1e-9)
    with jax.enable_x64():
        j_moved, j_flow = modet_forward_spatial(make_mesh(1, 2), jax_params(model),
                                                jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                                                qk_scale=1.0)
        j_moved, j_flow = np.asarray(j_moved), np.asarray(j_flow)
    np.testing.assert_allclose(s_flow.numpy(), j_flow, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(s_moved.numpy(), j_moved, atol=2e-4, rtol=1e-3)


def test_sharded_ncc_and_grad3d_match_the_unsharded_losses():
    ranks = M.run_ranks(R.sharded_losses, 1, 2, "cpu", args=(9,), threads=1)
    yt, yp, fl = (torch.from_numpy(a).requires_grad_() for a in R.arrays(
        9, (1, 16, 6, 5, 1), (1, 16, 6, 5, 1), (1, 16, 6, 5, 3)))
    ncc, l1, l2 = ncc_vxm(yt, yp), grad3d(fl, "l1"), grad3d(fl, "l2")
    want = torch.autograd.grad(ncc + l1 + 2 * l2, (yt, yp, fl), retain_graph=True)
    for key, value in (("ncc", ncc), ("l1", l1), ("l2", l2)):
        np.testing.assert_allclose(sum(r[key] for r in ranks), value.item(), rtol=1e-12)
    for i, w in enumerate(want):
        got = torch.cat([r["grads"][i] for r in ranks], 1)
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=1e-12)


def test_spatial2_loss_and_every_gradient_match_the_unsharded_step(sp2):
    _, _, _, loss, grads = unsharded_step(1)
    for r in sp2:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-10)
        assert_grads_close({n: g.numpy() for n, g in r["grads"].items()}, grads, 1e-7, 1e-9)
    for name, g in sp2[0]["grads"].items():
        assert torch.equal(g, sp2[1]["grads"][name]), name


def _oracle_attention_planes_prepad(qs, kpl, rpb, heads, scale=1.0, interpret=False,
                                    k_prepadded_d=False):
    """The XLA oracle in place of JAX's Pallas attention on planes, with its
    prepadded-k contract (`tests/test_modet_planes_sp.py`'s helper)."""
    from smilecode_tpu.ops.attention import _neighborhood_attention_xla

    bh, d, hd, h, w = qs.shape
    b = bh // heads

    def to_ndhwc(x):
        return x.reshape(b, heads, x.shape[1], hd, h, w).transpose(0, 2, 4, 5, 1, 3)

    out = _neighborhood_attention_xla(to_ndhwc(qs), to_ndhwc(kpl), rpb, scale,
                                      k_prepadded_d=k_prepadded_d)
    return out.reshape(b, d, h, w, heads, 3).transpose(0, 4, 5, 1, 2, 3).reshape(bh, 3, d, h, w)


def test_spatial2_loss_and_every_gradient_match_jax_make_spatial_loss_and_grads(sp2,
                                                                                 monkeypatch):
    from smilecode_tpu.models import modet_planes as MP
    from smilecode_tpu.parallel import modet_planes_sp as MPS
    from smilecode_tpu.parallel.mesh import make_mesh

    monkeypatch.setattr(MP, "modet_attention_planes_diff", _oracle_attention_planes_prepad)
    monkeypatch.setattr(MPS, "modet_attention_planes_diff", _oracle_attention_planes_prepad)
    model, x, y = R.modet_and_pair(SHAPE, 1, SEED, torch.float64)
    with jax.enable_x64():
        loss, grads = MPS.modet_train_loss_spatial(make_mesh(1, 2), jax_params(model),
                                                   jnp.asarray(x.numpy()),
                                                   jnp.asarray(y.numpy()), qk_scale=1.0,
                                                   weights=(1.0, 1.0))
        loss, grads = float(loss), jax.tree.map(np.asarray, grads)
    np.testing.assert_allclose(sp2[0]["loss"], loss, rtol=1e-6)
    assert_grads_close({n: g.numpy() for n, g in sp2[0]["grads"].items()},
                       state_dict_from_jax(grads), 1e-4, 1e-6)


def test_dp2_by_spatial2_step_matches_the_unsharded_batch_2_step():
    ranks = M.run_ranks(R.spatial_forward_and_step, 2, 2, "cpu",
                        args=(SHAPE, 2, torch.float64, SEED), threads=1)
    model, x, y, loss, grads = unsharded_step(2)
    with torch.no_grad():
        moved, flow = model(x, y)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-10)
        assert_grads_close({n: g.numpy() for n, g in r["grads"].items()}, grads, 1e-7, 1e-9)
    # rank (i, j) holds row i, D slab j
    s_flow = torch.cat([torch.cat([ranks[2 * i + j]["flow"] for j in range(2)], 1)
                        for i in range(2)], 0)
    np.testing.assert_allclose(s_flow.numpy(), flow.numpy(), rtol=0, atol=1e-9)


def _metrics(cfg):
    with open(f"{cfg.log_root}/{cfg.save_dir}/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if "iter" in r], [r["val_dice"] for r in rows if "val_dice" in r]


@pytest.mark.parametrize("dp", [1, 2])
def test_train_main_spatial2_matches_the_unsharded_run(tmp_path, dp):
    R.write_subjects(tmp_path / "data", SHAPE, n_train=2, n_val=2)
    runs = {}
    for spatial in (1, 2):
        root = tmp_path / f"sp{spatial}"
        cfg = TrainConfig(train_dir=str(tmp_path / "data" / "Train"),
                          val_dir=str(tmp_path / "data" / "Val"), save_root=str(root / "exp"),
                          log_root=str(root / "logs"), batch_size=dp,
                          dp=dp if spatial > 1 else 1, spatial=spatial, max_epoch=1, lr=0.0,
                          num_workers=0, device="cpu")
        best = train.main(cfg)
        ckpt = load_checkpoint(latest_checkpoint(f"{cfg.save_root}/{cfg.save_dir}"))
        runs[spatial] = (best, *_metrics(cfg), ckpt)
    (best1, steps1, dice1, ck1), (best2, steps2, dice2, ck2) = runs[1], runs[2]
    assert len(steps1) == len(steps2) == 2 // dp
    for a, b in zip(steps1, steps2):
        for key in ("loss", "sim", "reg"):
            np.testing.assert_allclose(b[key], a[key], rtol=1e-5, err_msg=key)
    assert dice1 == dice2 and best1 == best2
    p1, p2 = state_dict_from_jax(ck1["params"]), state_dict_from_jax(ck2["params"])
    for name in p1:
        assert torch.equal(p1[name], p2[name]), name
    for key in ("mu", "nu", "nu_max"):
        want = {n: np.asarray(v) for n, v in ck1["opt_state"][key].items()}
        floor = 1e-6 * max(float(np.abs(v).max()) for v in want.values())
        for name, a in want.items():
            np.testing.assert_allclose(np.asarray(ck2["opt_state"][key][name]), a, rtol=0,
                                       atol=1e-3 * np.abs(a).max() + floor,
                                       err_msg=f"{key} {name}")
