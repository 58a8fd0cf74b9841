"""Port ModeT and its inference driver vs the JAX package.

* Module names: a port `state_dict` maps onto the JAX ModeT through
  `smilecode_tpu.convert.convert_state_dict`, and back.
* Forward at 32^3, full width (channels 4, head_dim 6, heads 8/4/2/1/1,
  qk_scale 1): moved and flow within atol 2e-4 / rtol 1e-3 of JAX
  ``ModeT(attn_impl="xla").apply`` (the tolerance of the JAX package's own
  reference parity test; measured agreement is ~1e-5).
* The driver: `smilecode_tpu_torch.infer.main` on synthetic .pkl subjects
  and a JAX-format .ckpt gives the Dice and fold of `smilecode_tpu.infer.main`.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smilecode_tpu.convert import convert_state_dict
from smilecode_tpu.models import ModeT as JaxModeT
from smilecode_tpu.utils.checkpoint import save_checkpoint
from smilecode_tpu_torch.config import InferConfig, TrainConfig, check_train_config
from smilecode_tpu_torch.convert import (
    load_torch_checkpoint,
    params_from_state_dict,
    state_dict_from_jax,
)
from smilecode_tpu_torch.data.trans import LPBA_SEG_TABLE
from smilecode_tpu_torch.models import ModeT, build_model

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeded_model(seed=0, rpb_seed=None, rpb_scale=1.0, **kw):
    """Port ModeT from a seed; ``rpb_seed`` adds a random RPB so the
    attention's bias path and token order are exercised (a larger
    ``rpb_scale`` gives larger, folding flows)."""
    model = ModeT(qk_scale=1.0, generator=torch.Generator().manual_seed(seed), **kw).eval()
    if rpb_seed is not None:
        rng = np.random.default_rng(rpb_seed)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("rpb"):
                    p.copy_(torch.from_numpy(
                        rpb_scale * rng.standard_normal(p.shape).astype(np.float32)))
    return model


def jax_params(model, shape):
    vol = jnp.zeros((1, *shape, 1), jnp.float32)
    template = jax.eval_shape(JaxModeT(qk_scale=1.0).init, jax.random.PRNGKey(0), vol, vol)
    return convert_state_dict(model.state_dict(), template)


def test_state_dict_keys_follow_the_reference():
    sd = seeded_model().state_dict()
    for key in ["encoder.conv0_0.main.weight", "encoder.conv4_2.main.bias",
                "cwm5.conv.0.main.weight", "cwm5.conv.2.weight", "cwm3.conv.2.bias",
                "projblock5.proj.weight", "projblock5.norm.weight", "projblock1.norm.bias",
                "mdt5.rpb", "mdt1.rpb"]:
        assert key in sd, key
    assert not any(k.startswith(("cwm2", "cwm1")) for k in sd)
    assert len(list(seeded_model().buffers())) == 0
    assert tuple(sd["mdt5.rpb"].shape) == (8, 3, 3, 3)
    assert tuple(sd["projblock5.proj.weight"].shape) == (48, 128)


def test_seeded_init():
    a, b = seeded_model(7).state_dict(), seeded_model(7).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = seeded_model(8).state_dict()
    assert not torch.equal(a["encoder.conv0_0.main.weight"], c["encoder.conv0_0.main.weight"])
    assert float(a["projblock5.proj.weight"].std()) < 2e-5
    assert torch.count_nonzero(a["projblock5.proj.bias"]) == 0
    assert torch.count_nonzero(a["mdt3.rpb"]) == 0
    bound = 1.0 / (1 * 27) ** 0.5  # conv0_0: fan_in = 1 * 3^3
    w = a["encoder.conv0_0.main.weight"]
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.5 * bound


def test_convert_matches_jax_converter_and_round_trips():
    model = seeded_model(1, rpb_seed=2)
    sd = model.state_dict()
    ours = params_from_state_dict(sd)
    theirs = convert_state_dict(sd, jax_params(model, (16, 16, 16)))
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        np.testing.assert_array_equal(a, np.asarray(b))
    back = state_dict_from_jax(theirs)
    assert set(back) == set(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)


def test_forward_matches_jax_at_32():
    shape = (32, 32, 32)
    model = seeded_model(3, rpb_seed=4)
    rng = np.random.default_rng(5)
    moving = rng.random((1, *shape, 1)).astype(np.float32)
    fixed = rng.random((1, *shape, 1)).astype(np.float32)
    with torch.no_grad():
        moved, flow = model(torch.from_numpy(moving), torch.from_numpy(fixed))
    jm = JaxModeT(qk_scale=1.0, attn_impl="xla")
    j_moved, j_flow = jax.jit(jm.apply)(jax_params(model, shape), jnp.asarray(moving),
                                        jnp.asarray(fixed))
    assert flow.shape == (1, *shape, 3) and moved.shape == (1, *shape, 1)
    assert float(flow.abs().max()) > 0.5  # a real deformation, not ~0
    np.testing.assert_allclose(flow.numpy(), np.asarray(j_flow), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(moved.numpy(), np.asarray(j_moved), atol=2e-4, rtol=1e-3)


def test_plain_impl_equals_auto_on_cpu():
    shape = (16, 16, 16)
    rng = np.random.default_rng(6)
    moving = torch.from_numpy(rng.random((1, *shape, 1)).astype(np.float32))
    fixed = torch.from_numpy(rng.random((1, *shape, 1)).astype(np.float32))
    with torch.no_grad():
        auto = seeded_model(9, rpb_seed=1)(moving, fixed)
        plain = seeded_model(9, rpb_seed=1, attn_impl="plain")(moving, fixed)
    for a, b in zip(auto, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="attn_impl"):
        ModeT(attn_impl="xla")


def test_load_torch_checkpoint_drops_buffers(tmp_path):
    src = seeded_model(10, rpb_seed=11)
    sd = dict(src.state_dict())
    sd["spatial_trans.grid"] = torch.zeros(1, 3, 4, 4, 4)  # reference buffers
    sd["transformer.0.grid"] = torch.zeros(1, 3, 2, 2, 2)
    path = tmp_path / "dsc0.700.pth.tar"
    torch.save({"state_dict": sd, "epoch": 3, "best_dsc": np.float64(0.7)}, path)
    dst = load_torch_checkpoint(str(path), seeded_model(12))
    for k, v in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[k], v, rtol=0, atol=0)


def test_registry():
    cfg = InferConfig()
    model = build_model("modet-cu", InferConfig(attn_impl="plain"))
    assert model.attn_impl == "auto"
    assert build_model("modet", InferConfig(attn_impl="plain")).attn_impl == "plain"
    assert type(build_model("pcnet", cfg, device="meta")).__name__ == "PCNet"
    assert type(build_model("prnet++", cfg, device="meta")).__name__ == "PRNetPlusPlus"
    assert type(build_model("rdn-diff", InferConfig(stages=1, levels=(1, 1, 1, 1)))).__name__ == "RDN"
    assert type(build_model("im2grid", cfg)).__name__ == "Im2grid"
    bf16 = build_model("modet", InferConfig(compute_dtype="bfloat16"))
    assert bf16.compute_dtype == torch.bfloat16 and build_model("modet", cfg).compute_dtype is None
    vol = torch.rand(1, 16, 16, 16, 1)
    with torch.no_grad():
        assert all(o.dtype == torch.float32 and bool(o.isfinite().all()) for o in bf16(vol, vol))
    with pytest.raises(ValueError, match="compute_dtype"):
        build_model("modet", InferConfig(compute_dtype="float16"))
    with pytest.raises(ValueError, match="unknown"):
        build_model("nope", cfg)


SHAPE = (16, 16, 16)


@pytest.fixture(scope="module")
def infer_setup(tmp_path_factory):
    """3 synthetic subjects (smooth textures, LPBA labels) and a JAX-format
    checkpoint of seeded port weights, written by the JAX package."""
    root = tmp_path_factory.mktemp("torch_infer")
    test_dir, model_dir = root / "Test", root / "exp"
    test_dir.mkdir()
    rng = np.random.default_rng(13)
    for i in range(3):
        img = torch.nn.functional.interpolate(
            torch.from_numpy(rng.random((1, 1, 4, 4, 4)).astype(np.float32)),
            size=SHAPE, mode="trilinear", align_corners=True)[0, 0].numpy()
        seg = LPBA_SEG_TABLE[(img * 54.99).astype(np.int64)].astype(np.uint16)
        with open(test_dir / f"subject_{i:02d}.pkl", "wb") as f:
            pickle.dump((img, seg), f)
    model = seeded_model(14, rpb_seed=15, rpb_scale=6.0)
    params = jax.tree.map(jnp.asarray, jax_params(model, SHAPE))
    save_checkpoint({"epoch": 1, "params": params, "best_dsc": 0.5,
                     "opt_state": _optax_state(params)}, str(model_dir), "dsc0.500.ckpt")
    torch.save({"state_dict": model.state_dict()}, root / "dsc0.500.pth.tar")
    return test_dir, model_dir, model


def _optax_state(params):
    import optax

    return optax.amsgrad(1e-4).init(params)


def test_infer_main_matches_jax_driver(infer_setup):
    from smilecode_tpu import infer as jax_infer
    from smilecode_tpu.config import InferConfig as JaxInferConfig
    from smilecode_tpu_torch import infer as torch_infer

    test_dir, model_dir, _ = infer_setup
    dsc, fold = torch_infer.main(InferConfig(test_dir=str(test_dir), model_dir=str(model_dir),
                                             device="cpu"))
    j_dsc, j_fold = jax_infer.main(JaxInferConfig(
        test_dir=str(test_dir), model_dir=str(model_dir), img_size=SHAPE,
        fast_path="off", attn_impl="xla"))
    assert 0.0 < dsc < 1.0 and 0.0 < fold < 1.0
    assert dsc == pytest.approx(j_dsc, abs=1e-6)
    assert fold == pytest.approx(j_fold, abs=1e-6)
    # the same weights as a reference-format .pth.tar
    t_dsc, t_fold = torch_infer.main(InferConfig(
        test_dir=str(test_dir), torch_checkpoint=str(model_dir.parent / "dsc0.500.pth.tar"),
        device="cpu"))
    assert (t_dsc, t_fold) == (dsc, fold)


def test_infer_main_rejects_unported_modes(infer_setup):
    """MC uncertainty without dropout exits as the JAX driver does; the
    multi-GPU knobs are training's and still raise there."""
    from smilecode_tpu_torch import infer as torch_infer

    with pytest.raises(SystemExit, match="dropout_rate"):
        torch_infer.main(InferConfig(mc_iter=2, device="cpu"))
    with pytest.raises(SystemExit, match="dropout_rate"):
        torch_infer.main(InferConfig(mc_iter=2, dropout_rate=0.0, dataset="half", device="cpu"))
    with pytest.raises(NotImplementedError, match="item 10"):
        check_train_config(TrainConfig(dp=2))


_NO_JAX = r"""
import ast, importlib, importlib.abc, pathlib, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "smilecode_tpu"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import smilecode_tpu_torch
pkg = pathlib.Path(smilecode_tpu_torch.__file__).parent
for mod in pkgutil.walk_packages([str(pkg)], "smilecode_tpu_torch."):
    importlib.import_module(mod.name)
for path in pkg.rglob("*.py"):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for n in names:
            assert n.split(".")[0] not in ("jax", "flax", "smilecode_tpu"), (path, n)
from smilecode_tpu_torch.convert import state_dict_from_jax
from smilecode_tpu_torch.utils import latest_checkpoint, load_checkpoint
state = load_checkpoint(latest_checkpoint(sys.argv[1]))
sd = state_dict_from_jax(state["params"])
print(state["epoch"], len(sd), sorted(m for m in sys.modules if m.startswith(("jax", "flax"))))
"""


def test_port_imports_and_reads_jax_checkpoints_without_jax(infer_setup):
    _, model_dir, model = infer_setup
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(model_dir)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["1", str(len(model.state_dict())), "[]"]
