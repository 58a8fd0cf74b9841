"""Port resize, blocks, metrics, data, config and checkpoint helpers vs the
JAX package, on the same numpy inputs.

Tolerances: 1e-6 for interpolation and pooling (same arithmetic), 1e-5 for
normalisations and convolutions (float32 reductions in another order).
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smilecode_tpu import metrics as jmetrics
from smilecode_tpu.config import InferConfig as JaxInferConfig
from smilecode_tpu.data import datasets as jdatasets
from smilecode_tpu.data import trans as jtrans
from smilecode_tpu.ops import blocks as jblocks
from smilecode_tpu.ops import resize as jresize
from smilecode_tpu_torch import metrics
from smilecode_tpu_torch.config import InferConfig, apply_cli_overrides
from smilecode_tpu_torch.convert import params_from_state_dict
from smilecode_tpu_torch.data import (
    LPBA_SEG_TABLE,
    Compose,
    Loader,
    LPBABrainInferDatasetS2S,
    NumpyType,
    Seg_norm,
    pair_indices,
)
from smilecode_tpu_torch.ops import blocks, resize
from smilecode_tpu_torch.utils import AverageMeter, latest_checkpoint

torch.set_num_threads(1)
RNG = np.random.default_rng(21)


def vol(shape, c=3):
    return RNG.standard_normal((2, *shape, c)).astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 6, 5), (1, 3, 2)])
def test_upsample2_trilinear_matches_jax(shape):
    x = vol(shape)
    ref = np.asarray(jresize.upsample2_trilinear(jnp.asarray(x)))
    np.testing.assert_allclose(resize.upsample2_trilinear(torch.from_numpy(x)).numpy(), ref,
                               atol=1e-6, rtol=0)


def test_interp_trilinear_odd_sizes_matches_jax():
    x = vol((5, 7, 4))
    ref = np.asarray(jresize.interp_trilinear(jnp.asarray(x), (9, 3, 1)))
    out = resize.interp_trilinear(torch.from_numpy(x), (9, 3, 1))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


def test_avg_pool2_matches_jax():
    x = vol((6, 8, 4))
    np.testing.assert_allclose(resize.avg_pool2(torch.from_numpy(x)).numpy(),
                               np.asarray(jresize.avg_pool2(jnp.asarray(x))), atol=1e-6, rtol=0)


def test_instance_norm_and_leaky_relu_match_jax():
    x = vol((5, 6, 4), 4) * 3 + 1
    np.testing.assert_allclose(blocks.instance_norm(torch.from_numpy(x)).numpy(),
                               np.asarray(jblocks.instance_norm(jnp.asarray(x))), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(blocks.leaky_relu(torch.from_numpy(x)).numpy(),
                                  np.asarray(jblocks.leaky_relu(jnp.asarray(x))))


def test_layer_norm_matches_jax():
    x = vol((3, 4, 5), 12) * 2 + 0.5
    ln = torch.nn.LayerNorm(12, eps=1e-5)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(RNG.standard_normal(12).astype(np.float32)))
        ln.bias.copy_(torch.from_numpy(RNG.standard_normal(12).astype(np.float32)))
    params = {"params": {"scale": ln.weight.detach().numpy(), "bias": ln.bias.detach().numpy()}}
    ref = jblocks.LayerNorm().apply(params, jnp.asarray(x))
    with torch.no_grad():
        out = ln(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("cls,jcls", [(blocks.ConvBlock, jblocks.ConvBlock),
                                      (blocks.ConvInsBlock, jblocks.ConvInsBlock)])
def test_conv_blocks_match_jax(cls, jcls):
    x = vol((6, 5, 7), 3)
    block = cls(3, 5)
    blocks.reset_conv_(block.main, torch.Generator().manual_seed(0))
    params = params_from_state_dict(block.state_dict())
    ref = jcls(5).apply(params, jnp.asarray(x))
    with torch.no_grad():
        out = block(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_torch_uniform_init_bounds():
    conv = torch.nn.Conv3d(4, 8, 3)
    blocks.reset_conv_(conv, torch.Generator().manual_seed(1))
    bound = 1 / (4 * 27) ** 0.5
    assert float(conv.weight.detach().abs().max()) <= bound
    assert float(conv.bias.detach().abs().max()) <= bound


def labels(shape, seed):
    r = np.random.default_rng(seed)
    return r.integers(0, 12, shape).astype(np.int32)


def test_dice_matches_jax_and_numpy():
    pred, true = labels((9, 10, 11), 1), labels((9, 10, 11), 2)
    true[0] = 70  # out of the VOI range: matches no label
    pred[1] = -3
    out = float(metrics.dice_val_voi(torch.from_numpy(pred), torch.from_numpy(true)))
    assert out == pytest.approx(float(jmetrics.dice_val_voi(jnp.asarray(pred), jnp.asarray(true))),
                                abs=1e-6)
    assert out == pytest.approx(jmetrics.dice_val_voi_np(pred, true), abs=1e-6)
    same = float(metrics.dice_val_voi(torch.from_numpy(pred), torch.from_numpy(pred)))
    assert same == pytest.approx(jmetrics.dice_val_voi_np(pred, pred), abs=1e-6)


def test_jacobian_and_fold_match_jax():
    disp = (RNG.standard_normal((7, 8, 6, 3)) * 0.6).astype(np.float32)
    det = metrics.jacobian_determinant(torch.from_numpy(disp)).numpy()
    np.testing.assert_allclose(det, np.asarray(jmetrics.jacobian_determinant(jnp.asarray(disp))),
                               atol=1e-5, rtol=1e-6)
    fold = float(metrics.fold_fraction(torch.from_numpy(disp)))
    assert 0.0 < fold < 1.0
    assert fold == pytest.approx(float(jmetrics.fold_fraction(jnp.asarray(disp))), abs=1e-7)


@pytest.mark.parametrize("dtype", [np.uint16, np.int16])
def test_seg_norm_matches_jax(dtype):
    raw = np.random.default_rng(3).choice(np.append(LPBA_SEG_TABLE, [7, 200]), (1, 6, 5, 4))
    raw = raw.astype(dtype)
    img = np.zeros((1, 6, 5, 4), np.float32)
    out = Seg_norm()([img, raw])[1]
    ref = jtrans.Seg_norm()([img, raw])[1]
    np.testing.assert_array_equal(out, ref)
    assert out.dtype == ref.dtype


@pytest.fixture()
def subjects(tmp_path):
    rng = np.random.default_rng(5)
    paths = []
    for i in range(3):
        img = rng.random((4, 6, 5)).astype(np.float32)
        seg = rng.choice(LPBA_SEG_TABLE[:9], (4, 6, 5)).astype(np.uint16)
        path = tmp_path / f"subject_{i}.pkl"
        with open(path, "wb") as f:
            pickle.dump((img, seg), f)
        paths.append(str(path))
    return paths


def test_dataset_and_loader_match_jax(subjects):
    n = len(subjects)
    assert [pair_indices(i, n) for i in range(6)] == [jdatasets.pair_indices(i, n) for i in range(6)]
    tf = Compose([Seg_norm(), NumpyType((np.float32, np.int16))])
    jtf = jtrans.Compose([jtrans.Seg_norm(), jtrans.NumpyType((np.float32, np.int16))])
    ds = LPBABrainInferDatasetS2S(subjects, tf)
    jds = jdatasets.LPBABrainInferDatasetS2S(subjects, jtf)
    assert len(ds) == len(jds) == 6
    for a, b in zip(ds[4], jds[4]):
        np.testing.assert_array_equal(a, b)
    batches = list(Loader(ds, batch_size=4))
    assert len(batches) == 2
    x, y, x_seg, y_seg = batches[0]
    assert x.shape == (4, 4, 6, 5, 1) and x.dtype == torch.float32
    assert y_seg.dtype == torch.int16 and x.device.type == "cpu"
    np.testing.assert_array_equal(x_seg[1].numpy(), np.moveaxis(ds[1][2], 0, -1))
    assert batches[1][0].shape[0] == 2


def test_infer_config_mirrors_jax_and_overrides():
    ours, theirs = InferConfig(), JaxInferConfig()
    # the port's own field: where `infer.main` runs (JAX picks its backend itself)
    assert [f for f in vars(ours) if not hasattr(theirs, f)] == ["device"]
    for field, value in vars(ours).items():
        if field != "device":
            assert getattr(theirs, field) == value, field
    cfg = apply_cli_overrides(InferConfig(), ["num_heads=4,2,2,1,1", "qk_scale=none",
                                              "test_dir=/t", "model_idx=-2"])
    assert cfg.num_heads == (4, 2, 2, 1, 1) and cfg.qk_scale is None
    assert cfg.test_dir == "/t" and cfg.model_idx == -2
    with pytest.raises(SystemExit):
        apply_cli_overrides(InferConfig(), ["fast_path=off"])


def test_meter_and_latest_checkpoint(tmp_path):
    m = AverageMeter()
    for v in (1.0, 2.0, 4.0):
        m.update(v)
    assert m.avg == pytest.approx(7 / 3) and m.std == pytest.approx(np.std([1, 2, 4]))
    assert latest_checkpoint(str(tmp_path)) is None
    for name in ("dsc0.9.ckpt", "dsc0.10.ckpt", "dsc0.700.ckpt"):
        open(os.path.join(tmp_path, name), "wb").close()
    assert os.path.basename(latest_checkpoint(str(tmp_path))) == "dsc0.700.ckpt"
    assert os.path.basename(latest_checkpoint(str(tmp_path), 0)) == "dsc0.9.ckpt"
