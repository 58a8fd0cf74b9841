"""The port's half and atlas datasets and drivers vs the JAX package.

* `halfres` and the four datasets (`LPBABrainHalfDatasetS2S`,
  `LPBABrainHalfInferDatasetS2S`, `LPBABrainAtlasDataset`,
  `LPBABrainAtlasInferDataset`) give the JAX package's items, in its
  order, exactly, on synthetic pkl subjects whose axes are odd (9x10x11),
  where the stride-2 slice keeps the last plane; `pair_dataset`, which
  both drivers call, picks the JAX drivers' class for each ``dataset``.
* `train.main` (one epoch of 2 steps) and then `infer.main`, with
  ``dataset=half`` (32^3 subjects, 16^3 pairs) and ``dataset=atlas`` (16^3
  subjects and atlas), against JAX's `train.main` and `infer.main` from the
  same JAX-format checkpoint (ModeT, CPU, the default learning rate): the
  step losses within 1e-5 relative (the same float32 loss in another
  library), validation Dice, and the trained checkpoints' Dice and fold
  within 1e-6, as tests/test_torch_modet.py holds `infer.main` to JAX's.
  The first case takes ~100 s on the CPU, most of it JAX compiling its
  eager parameter init op by op; the second reuses those compiles (~30 s).
"""

import json
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from smilecode_tpu import data as jax_data
from smilecode_tpu import infer as jax_infer
from smilecode_tpu import native
from smilecode_tpu import train as jax_train
from smilecode_tpu.config import InferConfig as JaxInferConfig
from smilecode_tpu.config import TrainConfig as JaxTrainConfig
from smilecode_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from smilecode_tpu_torch import data, infer, train
from smilecode_tpu_torch.config import InferConfig, TrainConfig
from smilecode_tpu_torch.convert import params_from_state_dict
from smilecode_tpu_torch.data.trans import LPBA_SEG_TABLE
from smilecode_tpu_torch.models import ModeT

torch.set_num_threads(1)


def write_subject(path, shape, seed):
    rng = np.random.default_rng(seed)
    img = torch.nn.functional.interpolate(
        torch.from_numpy(rng.random((1, 1, 4, 4, 4)).astype(np.float32)),
        size=shape, mode="trilinear", align_corners=True)[0, 0].numpy()
    seg = LPBA_SEG_TABLE[(img * 54.99).astype(np.int64)].astype(np.uint16)
    with open(path, "wb") as f:
        pickle.dump((img, seg), f)


def write_dir(d, shape, n, seed):
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        write_subject(d / f"subject_{i:02d}.pkl", shape, seed + i)
    return sorted(str(p) for p in d.glob("*.pkl"))


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
@pytest.mark.parametrize("shape", [(9, 10, 11), (16, 16, 16), (1, 2, 3)])
def test_halfres_matches_jax(shape, dtype):
    vol = (np.random.default_rng(1).random(shape) * 100).astype(dtype)
    got, want = data.halfres(vol), native.halfres(vol)
    assert got.dtype == want.dtype == dtype and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


TRAIN_T = ((np.float32, np.float32),)
INFER_T = ((np.float32, np.int16),)


@pytest.mark.parametrize("name,infer_mode", [
    ("LPBABrainHalfDatasetS2S", False), ("LPBABrainHalfInferDatasetS2S", True),
    ("LPBABrainAtlasDataset", False), ("LPBABrainAtlasInferDataset", True),
    ("LPBABrainDatasetS2S", False), ("LPBABrainInferDatasetS2S", True),
])
def test_datasets_give_the_jax_items_in_order(tmp_path, name, infer_mode):
    paths = write_dir(tmp_path / "subjects", (9, 10, 11), 3, seed=5)
    atlas = tmp_path / "atlas.pkl"
    write_subject(atlas, (9, 10, 11), seed=40)

    def make(pkg):
        trans = pkg.Compose(([pkg.Seg_norm()] if infer_mode else [])
                            + [pkg.NumpyType(*(INFER_T if infer_mode else TRAIN_T))])
        cls = getattr(pkg, name)
        return cls(paths, str(atlas), trans) if "Atlas" in name else cls(paths, trans)

    ours, theirs = make(data), make(jax_data)
    assert len(ours) == len(theirs) == (3 if "Atlas" in name else 6)
    half = "Half" in name
    for i in range(len(theirs)):
        a, b = ours[i], theirs[i]
        assert len(a) == len(b) == (4 if infer_mode else 2)
        for u, v in zip(a, b):
            assert u.shape == v.shape == ((1, 5, 5, 6) if half else (1, 9, 10, 11))
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
    if "Atlas" in name:  # the atlas is the fixed volume of every item, never halved
        assert all(np.array_equal(ours[i][1], ours[0][1]) for i in range(3))


@pytest.mark.parametrize("dataset,infer_mode,name", [
    ("half", False, "LPBABrainHalfDatasetS2S"), ("half", True, "LPBABrainHalfInferDatasetS2S"),
    ("atlas", False, "LPBABrainAtlasDataset"), ("atlas", True, "LPBABrainAtlasInferDataset"),
    ("s2s", False, "LPBABrainDatasetS2S"), ("s2s", True, "LPBABrainInferDatasetS2S"),
    ("other", False, "LPBABrainDatasetS2S"), ("other", True, "LPBABrainInferDatasetS2S"),
])
def test_pair_dataset_selects_as_the_jax_drivers(tmp_path, dataset, infer_mode, name):
    """`pair_dataset`, which both drivers call, picks the class that
    `smilecode_tpu/train.py:216-224` and `smilecode_tpu/infer.py:166-171`
    pick for ``dataset``, with the fall-through to s2s for any other name."""
    paths = write_dir(tmp_path / "subjects", (9, 10, 11), 3, seed=5)
    atlas = tmp_path / "atlas.pkl"
    write_subject(atlas, (9, 10, 11), seed=40)
    trans = data.Compose([data.NumpyType(*(INFER_T if infer_mode else TRAIN_T))])
    ds = data.pair_dataset(dataset, paths, trans, infer_mode, str(atlas))
    assert type(ds) is getattr(data, name)
    assert len(ds) == len(getattr(jax_data, name)(*((paths, str(atlas), trans)
                                                     if "Atlas" in name else (paths, trans))))


def _start_checkpoint(model, lr):
    """A JAX-format checkpoint at epoch 1 of 2: the model's params and a
    fresh optax AMSGrad state, which both drivers resume (the port restarts
    its moments at 0, the same state)."""
    params = jax.tree.map(jnp.asarray, params_from_state_dict(model.state_dict()))
    tx = optax.inject_hyperparams(lambda learning_rate: optax.amsgrad(learning_rate=learning_rate))
    return {"epoch": 1, "params": params, "best_dsc": 0.0,
            "opt_state": tx(learning_rate=lr).init(params)}


def _metrics(log_dir):
    rows = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    return [r["loss"] for r in rows if "iter" in r], [r["val_dice"] for r in rows
                                                        if "val_dice" in r]


@pytest.mark.parametrize("dataset,size,pair", [("half", (32, 32, 32), (16, 16, 16)),
                                               ("atlas", (16, 16, 16), (16, 16, 16))])
def test_train_then_infer_match_jax(tmp_path, dataset, size, pair):
    train_paths = write_dir(tmp_path / "Train", size, 2, seed=21)
    write_dir(tmp_path / "Val", size, 2, seed=31)
    atlas = tmp_path / "atlas.pkl"
    write_subject(atlas, size, seed=50)
    lr = 1e-4
    start = _start_checkpoint(ModeT(qk_scale=1.0, generator=torch.Generator().manual_seed(3)), lr)
    common = dict(train_dir=str(tmp_path / "Train"), val_dir=str(tmp_path / "Val"), lr=lr,
                  max_epoch=2, cont_training=True, num_workers=0, dataset=dataset,
                  atlas_path=str(atlas))
    runs = {}
    for pkg, cfg in (("port", TrainConfig(device="cpu", **common)),
                     ("jax", JaxTrainConfig(img_size=pair, fast_path="off", attn_impl="xla",
                                            **common))):
        cfg.save_root, cfg.log_root = str(tmp_path / pkg / "exp"), str(tmp_path / pkg / "logs")
        exp_dir = tmp_path / pkg / "exp" / cfg.save_dir
        jax_save_checkpoint(start, str(exp_dir), "dsc0.000.ckpt")
        real_stdout = sys.stdout
        try:  # JAX's train.main leaves its log file as sys.stdout
            best = (train if pkg == "port" else jax_train).main(cfg)
        finally:
            sys.stdout = real_stdout
        losses, val = _metrics(tmp_path / pkg / "logs" / cfg.save_dir)
        runs[pkg] = best, losses, val, exp_dir
    (best, losses, val, exp_dir), (j_best, j_losses, j_val, j_exp_dir) = runs["port"], runs["jax"]
    assert len(losses) == len(j_losses) == len(train_paths)  # 2 ordered pairs, or 2 subjects
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    assert val == pytest.approx(j_val, abs=1e-6) and best == pytest.approx(j_best, abs=1e-6)

    icommon = dict(test_dir=str(tmp_path / "Val"), dataset=dataset, atlas_path=str(atlas))
    dsc, fold = infer.main(InferConfig(model_dir=str(exp_dir), device="cpu", **icommon))
    j_dsc, j_fold = jax_infer.main(JaxInferConfig(model_dir=str(j_exp_dir), img_size=pair,
                                                  fast_path="off", attn_impl="xla", **icommon))
    assert 0.0 < dsc < 1.0
    assert dsc == pytest.approx(j_dsc, abs=1e-6) and fold == pytest.approx(j_fold, abs=1e-6)
