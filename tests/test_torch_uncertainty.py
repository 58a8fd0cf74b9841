"""The port's MC-dropout uncertainty protocol vs the JAX package.

* `metrics_ext`: every function the JAX package's has, on seeded numpy
  inputs in float64, within 1e-12 (the same numpy and scipy arithmetic).
* `infer.mc_pair_stats` on one seeded stack of MC samples equals the
  expressions of `smilecode_tpu/infer.py:112-122` built from the JAX
  package's functions, within 1e-6 relative (float32 samples; the same
  numpy reductions).
* RDN's MC-dropout head: with no generator the forward is the
  deterministic one and equals JAX ``apply`` with no rngs at the RDN
  tolerance (atol 2e-4, rtol 1e-3, `test_torch_baselines.py`), 16^3; the
  masks are inverted dropout (every value 0 or x / (1 - p), the keep
  fraction within 4 sigma of 1 - p on 2^18 values), one stream per seed.
  Masks cannot match JAX's random bits, so the stochastic forwards are
  checked by these properties, not against JAX.
* `infer.main` with ``mc_iter`` runs the protocol on 16^3 subjects, and
  exits without ``dropout_rate`` as JAX's does; training ignores
  ``dropout_rate`` in both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smilecode_tpu import metrics_ext as jax_mx
from smilecode_tpu.models import RDN as JaxRDN
from smilecode_tpu.utils.checkpoint import save_checkpoint
from smilecode_tpu_torch import infer, metrics_ext
from smilecode_tpu_torch.config import InferConfig, TrainConfig
from smilecode_tpu_torch.convert import state_dict_from_jax
from smilecode_tpu_torch.models import build_model
from smilecode_tpu_torch.models.rdn import dropout
from smilecode_tpu_torch.models.registry import loss_plan
from smilecode_tpu_torch.train import make_loss_and_grads
from test_torch_baselines import ATOL, RTOL, pair, random_jax_params, write_subjects

torch.set_num_threads(1)
RDN_KW = {"stages": 2, "levels": (2, 1, 1, 2)}
SHAPE = (16, 16, 16)


def sphere(shape, centre, radius):
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    return np.linalg.norm(grid - np.asarray(centre), axis=-1) <= radius


def _inputs():
    rng = np.random.default_rng(33)
    a, b = sphere((20, 22, 24), (10, 11, 12), 6), sphere((20, 22, 24), (11, 10, 13), 5)
    labels = rng.integers(0, 4, (12, 13, 14))
    return rng, a, b, labels


# name -> (port, JAX) arguments from a seeded generator; float64 throughout
CASES = {
    "uceloss": lambda rng, a, b, lab: ((rng.random(5000) * 0.2, rng.random(5000) * 0.15), {}),
    "uce_loss": lambda rng, a, b, lab: ((rng.random(3000), rng.random(3000)), {"n_bins": 7}),
    "uncert_regression_gal": lambda rng, a, b, lab: (
        ([rng.random((2, 5, 6, 7, 3)) for _ in range(6)],), {"reduction": None}),
    "calc_uncert": lambda rng, a, b, lab: (
        (rng.random((5, 6, 7)), [rng.random((5, 6, 7)) for _ in range(4)]), {}),
    "mc_stats": lambda rng, a, b, lab: ((rng.random((6, 4, 5, 3)),), {}),
    "dice_binary": lambda rng, a, b, lab: ((a, b), {}),
    "assd": lambda rng, a, b, lab: ((a, b), {"voxelspacing": (1.0, 1.5, 2.0)}),
    "hd": lambda rng, a, b, lab: ((a, b), {}),
    "hd95": lambda rng, a, b, lab: ((a, b), {}),
    "per_class_metrics": lambda rng, a, b, lab: (
        (lab, np.roll(lab, 1, axis=0), [0, 1, 2, 3, 7]), {"metrics": ("dice", "assd", "hd95")}),
    "dice_val_7voi": lambda rng, a, b, lab: ((lab * 2, np.roll(lab * 2, 1, axis=1)), {}),
    "smooth_seg": lambda rng, a, b, lab: ((a,), {"sigma": 1.2, "thresh": 0.3}),
    "pad_image": lambda rng, a, b, lab: ((rng.random((5, 6, 7)), (8, 6, 10)), {}),
}


def _close(x, y, path="out"):
    if isinstance(x, dict):
        assert x.keys() == y.keys(), path
        for k in x:
            _close(x[k], y[k], f"{path}[{k}]")
    elif isinstance(x, (tuple, list)):
        assert len(x) == len(y), path
        for i, (u, v) in enumerate(zip(x, y)):
            _close(u, v, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64),
                                   rtol=1e-12, atol=1e-12, err_msg=path)


@pytest.mark.parametrize("name", list(CASES))
def test_metrics_ext_matches_jax(name):
    args, kw = CASES[name](*_inputs())
    _close(getattr(metrics_ext, name)(*args, **kw), getattr(jax_mx, name)(*args, **kw))


def test_label_tables_match_jax():
    for table in ("LPBA_LABEL_NAMES", "SEVEN_REGION_NAMES", "MINDBOGGLE_LABEL_NAMES"):
        assert getattr(metrics_ext, table) == getattr(jax_mx, table)


def test_uceloss_leaves_the_least_uncertain_voxel_out_as_the_reference():
    """The first bin edge is exclusive (torch ``gt``), so the voxel with the
    least uncertainty falls in no bin, in both packages."""
    uncert = np.array([0.0, 0.5, 1.0])
    _, _, _, props = metrics_ext.uceloss(np.zeros(3), uncert, n_bins=2)
    assert props.sum() == pytest.approx(2 / 3)


@pytest.mark.parametrize("channels", [1, 2])
def test_mc_pair_stats_match_the_jax_expressions(channels):
    """`smilecode_tpu/infer.py:112-122` on one stack: epistemic variance
    alone for a one-channel moved image, Gal's decomposition with an
    aleatoric channel."""
    rng = np.random.default_rng(8)
    preds = rng.random((5, 1, 6, 7, 8, channels)).astype(np.float32)
    y = rng.random((1, 6, 7, 8, 1)).astype(np.float32)
    got = infer.mc_pair_stats(preds, y)
    if preds.shape[-1] > 1:
        ale, epi, uncert = jax_mx.uncert_regression_gal(list(preds), reduction=None)
        pred_mean = preds[..., :-1].mean(axis=0)
    else:
        ale = np.zeros_like(preds[0])
        epi = preds.var(axis=0, ddof=1).mean(axis=-1, keepdims=True)
        uncert = ale + epi
        pred_mean = preds.mean(axis=0)
    err = (pred_mean[..., : uncert.shape[-1]] - y) ** 2
    uce = jax_mx.uceloss(err, uncert)[0]
    for a, b in zip(got, (ale, epi, uncert, err, uce)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    assert float(np.mean(got[1])) > 0 and np.isfinite(got[4])


def rdn_pair(seed, dropout_rate, kw=RDN_KW):
    """A port RDN and JAX params at 16^3, the params drawn from a seed."""
    vol = jnp.zeros((1, *SHAPE, 1), jnp.float32)
    jmodel = JaxRDN(share_weights=False, diff=False, dropout_rate=dropout_rate, **kw)
    params = random_jax_params(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), vol, vol),
                               seed)
    model = build_model("rdn", InferConfig(model="rdn", dropout_rate=dropout_rate, **kw),
                        generator=torch.Generator().manual_seed(0)).eval()
    model.load_state_dict(state_dict_from_jax(params, model), strict=True)
    return model, jmodel, params


def test_rdn_without_a_generator_is_the_deterministic_forward_and_matches_jax():
    model, jmodel, params = rdn_pair(40, 0.3)
    moving, fixed = pair(SHAPE, 41)
    with torch.no_grad():
        outs = model(torch.from_numpy(moving), torch.from_numpy(fixed))
    j_outs = jax.jit(jmodel.apply)(jax.tree.map(jnp.asarray, params), jnp.asarray(moving),
                                   jnp.asarray(fixed))
    assert len(outs) == len(j_outs) == 2 + RDN_KW["stages"]
    for i, (a, b) in enumerate(zip(outs, j_outs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL,
                                   err_msg=f"output {i}")
    deterministic, _, _ = rdn_pair(40, 0.0)
    with torch.no_grad():
        for a, b in zip(outs, deterministic(torch.from_numpy(moving), torch.from_numpy(fixed))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_dropout_is_inverted_dropout(rate):
    x = torch.rand((1, 64, 64, 64), generator=torch.Generator().manual_seed(1)) + 0.5
    out = dropout(x, rate, torch.Generator().manual_seed(2))
    kept = out != 0
    assert torch.equal(out[kept], x[kept] / (1 - rate))
    n, keep = x.numel(), 1 - rate
    sigma = (keep * (1 - keep) / n) ** 0.5
    assert abs(float(kept.float().mean()) - keep) <= 4 * sigma
    assert torch.equal(out, dropout(x, rate, torch.Generator().manual_seed(2)))
    assert not torch.equal(out, dropout(x, rate, torch.Generator().manual_seed(3)))


def test_mc_samples_follow_the_generator():
    """Same seed, same stack of MC samples; another seed, another stack; the
    samples of one stream differ from each other."""
    model, _, _ = rdn_pair(42, 0.3)
    moving, fixed = (torch.from_numpy(v) for v in pair(SHAPE, 43))

    def stack(seed):
        imgs, flows = metrics_ext.get_mc_preds(
            lambda m, f, g: model(m, f, generator=g)[:2], moving, fixed, mc_iter=3,
            generator=torch.Generator().manual_seed(seed))
        return np.stack(imgs), np.stack(flows)

    (a_img, a_flow), (b_img, b_flow), (c_img, _) = stack(5), stack(5), stack(6)
    np.testing.assert_array_equal(a_img, b_img)
    np.testing.assert_array_equal(a_flow, b_flow)
    assert not np.array_equal(a_img, c_img)
    assert not np.array_equal(a_flow[0], a_flow[1])


@pytest.fixture(scope="module")
def mc_setup(tmp_path_factory):
    """16^3 subjects and a JAX-format checkpoint of RDN (stages 1, levels
    1,1,1,1, dropout head at 0.3), written by the JAX package."""
    root = tmp_path_factory.mktemp("mc")
    kw = {"stages": 1, "levels": (1, 1, 1, 1)}
    vol = jnp.zeros((1, *SHAPE, 1), jnp.float32)
    jmodel = JaxRDN(share_weights=False, diff=False, dropout_rate=0.3, **kw)
    params = random_jax_params(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), vol, vol), 44)
    write_subjects(str(root / "Test"), SHAPE)
    save_checkpoint({"epoch": 1, "params": params, "best_dsc": 0.5}, str(root / "exp"),
                    "dsc0.500.ckpt")
    return dict(model="rdn", test_dir=str(root / "Test"), model_dir=str(root / "exp"), **kw)


def test_infer_main_runs_the_mc_protocol(mc_setup, capsys):
    uce, epi = infer.main(InferConfig(dropout_rate=0.3, mc_iter=3, device="cpu", **mc_setup))
    out = capsys.readouterr().out
    assert np.isfinite(uce) and uce >= 0 and np.isfinite(epi) and epi > 0
    assert out.count("pair ") == 6 and "MC uncertainty (3 samples)" in out
    record = []
    again = infer.main(InferConfig(dropout_rate=0.3, mc_iter=3, device="cpu", **mc_setup),
                       mc_record=record)
    assert again == (uce, epi)  # one generator seeded 24: reproducible
    assert len(record) == 6  # per pair: the MC stack and its statistics
    for preds, stats in record:
        assert preds.shape == (3, 1, *SHAPE, 1) and preds.dtype == np.float32
        assert len(stats) == 5 and float(np.mean(stats[1])) > 0
    assert np.mean([float(np.mean(stats[1])) for _, stats in record]) == pytest.approx(
        epi, rel=1e-12)
    assert np.mean([stats[4] for _, stats in record]) == pytest.approx(uce, rel=1e-12)


def test_mc_without_dropout_exits_as_jax(mc_setup):
    from smilecode_tpu import infer as jax_infer
    from smilecode_tpu.config import InferConfig as JaxInferConfig

    with pytest.raises(SystemExit, match="dropout_rate"):
        infer.main(InferConfig(mc_iter=2, dropout_rate=0.0, device="cpu", **mc_setup))
    with pytest.raises(SystemExit, match="dropout_rate"):
        jax_infer.main(JaxInferConfig(mc_iter=2, dropout_rate=0.0, img_size=SHAPE, **mc_setup))


def test_training_ignores_the_dropout_rate():
    """A training step of RDN with dropout_rate 0.3 (in ``.train()`` mode,
    as `train.main` runs it) gives the loss and gradients of dropout_rate
    0, as JAX's `train.main` passes no dropout rng; JAX ``apply`` without
    rngs likewise ignores the rate."""
    moving, fixed = pair(SHAPE, 45)
    x, y = torch.from_numpy(moving), torch.from_numpy(fixed)
    kw = {"stages": 1, "levels": (1, 1, 1, 1)}
    plan = loss_plan("rdn", TrainConfig(model="rdn", **kw))
    results = []
    for rate in (0.3, 0.0):
        model, jmodel, params = rdn_pair(46, rate, kw)
        loss, _ = make_loss_and_grads(model.train(), plan, [1.0, 1.0])(x, y)
        results.append((loss, {n: p.grad.clone() for n, p in model.named_parameters()},
                        jax.jit(jmodel.apply)(jax.tree.map(jnp.asarray, params),
                                              jnp.asarray(moving), jnp.asarray(fixed))))
    (loss, grads, j_outs), (loss0, grads0, j_outs0) = results
    assert torch.equal(loss, loss0) and grads.keys() == grads0.keys()
    assert all(torch.equal(grads[n], grads0[n]) for n in grads)
    for a, b in zip(j_outs, j_outs0):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
