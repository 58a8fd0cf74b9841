"""Port baselines (Im2grid, PCNet, PRNet, PR++, VTN, RCN, RDN) vs the JAX
package: module names and weight conversion for every model and variant,
Im2grid's forward and `infer.main`, the models' kernel-wrapper calls per
pair, the VTN/RCN size rule, and the registry against the JAX registry.
VTN/RCN forwards: `test_torch_baselines_rcn.py`; RDN:
`test_torch_baselines_rdn.py`; PCNet: `test_torch_pcnet.py`; PRNet and
PR++: `test_torch_prnet.py`; training: `test_torch_baselines_train.py`.

Forward parity: the JAX model's params (the template of JAX ``init`` by
`jax.eval_shape`, values drawn from a numpy seed in torch's default ranges;
JAX's own init would leave Im2grid's zero-init projections and the
N(0, 1e-5) flow heads near zero and hide a wrong layout) go through
``state_dict_from_jax(params, model)`` into the port; every output, aux
included, within atol 2e-4 / rtol 1e-3 of JAX ``apply`` (the tolerance of
the JAX package's own reference parity tests; float32 convolutions and
warps summed in another order). `infer.main`: equal Dice and fold within 1e-6.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smilecode_tpu.convert import convert_state_dict, renames_for
from smilecode_tpu.models import PCNet as JaxPCNet
from smilecode_tpu.models import PRNet as JaxPRNet
from smilecode_tpu.models import PRNetPlusPlus as JaxPRNetPlusPlus
from smilecode_tpu.models import RCN as JaxRCN
from smilecode_tpu.models import RDN as JaxRDN
from smilecode_tpu.models import VTN as JaxVTN
from smilecode_tpu.models import Im2grid as JaxIm2grid
from smilecode_tpu.models.im2grid import _sincos_pe as jax_sincos_pe
from smilecode_tpu_torch.config import InferConfig
from smilecode_tpu_torch.convert import (
    params_from_state_dict,
    state_dict_from_jax,
    torch_key_to_flax_path,
)
from smilecode_tpu_torch.data.trans import LPBA_SEG_TABLE
from smilecode_tpu_torch.kernels import modet_attn as port_attn
from smilecode_tpu_torch.kernels import warp3d as port_warp3d
from smilecode_tpu_torch.models import build_model
from smilecode_tpu_torch.models.registry import loss_plan
from smilecode_tpu_torch.models.im2grid import _sincos_pe
from smilecode_tpu_torch.models.rcn import RCN, build_vtn
from smilecode_tpu_torch.models.rdn import RDN
from smilecode_tpu_torch.utils import save_checkpoint

torch.set_num_threads(1)
ATOL, RTOL = 2e-4, 1e-3

RDN_SMALL = {"stages": 2, "levels": (2, 1, 1, 2)}
# name -> (JAX module, port InferConfig overrides, test size)
MODELS = {
    "im2grid": (lambda: JaxIm2grid(), {}, (32, 32, 32)),
    "vtn": (lambda: JaxVTN(), {}, (64, 64, 64)),
    "rcn": (lambda: JaxRCN(n_cascade=2), {"n_cascade": 2}, (64, 64, 64)),
    "rdn": (lambda: JaxRDN(share_weights=False, diff=False, **RDN_SMALL), RDN_SMALL, (32, 32, 32)),
    "rdn_share": (lambda: JaxRDN(share_weights=True, diff=False, **RDN_SMALL), RDN_SMALL,
                  (32, 32, 32)),
    "rdn_diff": (lambda: JaxRDN(share_weights=False, diff=True, **RDN_SMALL), RDN_SMALL,
                 (32, 32, 32)),
    "rdn_diff_share": (lambda: JaxRDN(share_weights=True, diff=True, **RDN_SMALL), RDN_SMALL,
                       (32, 32, 32)),
    # PRNet/PR++ at 32^3: at 16^3 their coarsest level is one voxel
    "pcnet": (lambda: JaxPCNet(), {}, (16, 16, 16)),
    "prnet": (lambda: JaxPRNet(), {}, (32, 32, 32)),
    "prnetplusplus": (lambda: JaxPRNetPlusPlus(), {}, (32, 32, 32)),
}


def port_model(name, seed=0, **overrides):
    _, kw, _ = MODELS[name]
    cfg = InferConfig(model=name, **{**kw, **overrides})
    return build_model(name, cfg, generator=torch.Generator().manual_seed(seed)).eval()


def jax_template(name):
    jmodel, _, shape = MODELS[name]
    vol = jnp.zeros((1, *shape, 1), jnp.float32)
    return jax.eval_shape(jmodel().init, jax.random.PRNGKey(0), vol, vol)


# flow heads whose range is widened so that the flows move voxels
HEAD_GAIN = {"Pred0": 20.0, "conv_4": 5.0, "flow": 10.0, "reg_conv3": 5.0, "reg_conv2": 5.0,
             "reg_conv1": 5.0, "reg_conv0_1": 5.0}


def random_jax_params(template, seed):
    """Numpy values in the template's shapes: U(-b, b), b = 1/sqrt(fan_in)
    for kernels and biases (torch's default range; `HEAD_GAIN` times that
    for the flow heads of VTN, RDN, PRNet/PR++ and PCNet), 1 ± 0.5 for alpha."""
    rng = np.random.default_rng(seed)
    fan_in = {}

    def draw(path, leaf):
        names = [p.key for p in path]
        if names[-1] == "alpha":
            return (1 + 0.5 * rng.uniform(-1, 1, leaf.shape)).astype(np.float32)
        owner = tuple(names[:-1])
        if names[-1] == "kernel":
            fan_in[owner] = int(np.prod(leaf.shape[:-1]))
        b = HEAD_GAIN.get(owner[-1], 1.0) / np.sqrt(fan_in.get(owner, leaf.shape[-1]))
        return rng.uniform(-b, b, leaf.shape).astype(np.float32)

    # kernels before biases, so a bias finds its kernel's fan-in
    leaves = jax.tree_util.tree_flatten_with_path(template)[0]
    order = sorted(range(len(leaves)), key=lambda i: leaves[i][0][-1].key != "kernel")
    vals = [None] * len(leaves)
    for i in order:
        vals[i] = draw(*leaves[i])
    return jax.tree.unflatten(jax.tree.structure(template), vals)


def pair(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.random((1, *shape, 1)).astype(np.float32) for _ in range(2)]


def assert_forward_matches_jax(name, seed):
    """Port forward on converted JAX params == JAX apply, every output."""
    jmodel, _, shape = MODELS[name]
    params = random_jax_params(jax_template(name), seed)
    model = port_model(name)
    model.load_state_dict(state_dict_from_jax(params, model), strict=True)
    moving, fixed = pair(shape, seed + 1)
    with torch.no_grad():
        outs = model(torch.from_numpy(moving), torch.from_numpy(fixed))
    j_outs = jax.jit(jmodel().apply)(jax.tree.map(jnp.asarray, params), jnp.asarray(moving),
                                     jnp.asarray(fixed))
    assert len(outs) == len(j_outs)
    assert outs[1].shape == (1, *shape, 3) and outs[0].shape == (1, *shape, 1)
    assert float(outs[1].abs().max()) > 0.5, "the flow must move voxels"
    for i, (a, b) in enumerate(zip(outs, j_outs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name} output {i}")
    return outs


def _square_transposed(model):
    """state_dict keys of ConvTranspose3d weights with Cin == Cout."""
    return {f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, torch.nn.ConvTranspose3d) and m.in_channels == m.out_channels}


@pytest.mark.parametrize("name", list(MODELS))
def test_converters_round_trip_and_match_the_jax_converter(name):
    """A port `state_dict` goes into JAX ``convert_state_dict`` with the
    model's renames (every key consumed, every leaf filled), and
    `params_from_state_dict(sd, model)` gives the same tree and values,
    except for a square transposed conv: JAX's converter picks a layout by
    shape and takes a (Cin, Cout, k, k, k) weight with Cin == Cout for a
    Conv3d, swapping Cin and Cout; the port follows the module type.
    `state_dict_from_jax` inverts `params_from_state_dict` bit-exactly."""
    model = port_model(name, seed=1)
    sd = model.state_dict()
    theirs = convert_state_dict(sd, jax_template(name), renames_for(name))
    ours = params_from_state_dict(sd, model)
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    # VTN's square transposed convs are its Upsamp*, flattened in JAX
    swapped = {torch_key_to_flax_path(k)[:-2] + ("kernel",) for k in _square_transposed(model)}
    flat_ours = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    for path, b in jax.tree_util.tree_flatten_with_path(theirs)[0]:
        a = flat_ours[path]
        names = tuple(p.key for p in path)[1:]
        want = np.asarray(b).swapaxes(3, 4) if names in swapped else np.asarray(b)
        np.testing.assert_array_equal(a, want, err_msg=str(names))
    back = state_dict_from_jax(ours, model)
    assert list(back) == list(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
    assert bool(swapped) == (name in ("vtn", "rcn"))


def test_square_transposed_conv_needs_the_model():
    """VTN's ``Upsamp*`` are ConvTranspose3d(3, 3): without the model a
    converter cannot tell their layout from a Conv3d's by shape."""
    model = port_model("vtn", seed=2)
    sd = model.state_dict()
    w = sd["Upsamp6to5.upconv.weight"].numpy()
    assert w.shape == (3, 3, 4, 4, 4)
    params = params_from_state_dict(sd, model)["params"]
    np.testing.assert_array_equal(params["Upsamp6to5"]["kernel"], w.transpose(2, 3, 4, 0, 1))
    assert "upconv" not in params["Pred0"] and "upconv" in params["Deconv5"]
    wrong = state_dict_from_jax({"params": {"Upsamp6to5": {"kernel": params["Upsamp6to5"]["kernel"]}}})
    assert not np.array_equal(wrong["Upsamp6to5.weight"].numpy(), w)
    with pytest.raises(KeyError, match="not a parameter"):
        state_dict_from_jax({"params": {"nope": {"kernel": np.zeros((3, 3))}}}, model)
    with pytest.raises(KeyError, match="not in the JAX params"):
        state_dict_from_jax({"params": {"Pred0": params["Pred0"]}}, model)


def test_state_dict_keys_follow_the_reference():
    keys = {
        "im2grid": ["encoder.conv0_0.main.weight", "peblock5.proj.weight", "peblock5.alpha",
                    "peblock1.proj.bias"],
        "vtn": ["encoder.conv1.main.weight", "encoder.conv6_1.main.bias", "Pred6.weight",
                "Upsamp6to5.upconv.weight", "Deconv5.upconv.weight", "Deconv1.upconv.bias",
                "Pred0.upconv.weight"],
        "rcn": ["vtn.0.encoder.conv1.main.weight", "vtn.1.Pred0.upconv.weight"],
        "rdn": ["encoder.conv0.main.weight", "est3_0.conv.0.weight", "est0_1.conv.4.bias"],
        "rdn_share": ["est3.conv.2.weight", "est0.conv.4.weight"],
        "pcnet": ["encoder_float.conv0.main.weight", "encoder_fixed.conv3.0.weight",
                  "encoder_float.conv1.1.block.2.weight", "conv_bottleNeck.1.main.bias",
                  "reg_conv3.weight", "reg_conv0.1.bias", "upconv2.upconv.weight",
                  "upconv0.upconv.bias", "dfi_0.conv.1.main.weight",
                  "dfi_0.weight_conv.2.0.weight", "dfi_2.weight_conv.0.0.bias",
                  "nff_1.weight_conv.0.weight", "nff_2.channel_attention.fc.0.weight",
                  "nff_0.channel_attention.fc.2.weight"],
        "prnet": ["net.encoder.block1.main.weight", "net.decoder1.Conv.main.weight",
                  "net.decoder5.main.bias", "prblock1.flow.weight", "prblock5.flow.bias"],
        "prnetplusplus": ["net.encoder.block5.main.weight", "prblock2.conv1.0.weight",
                          "prblock3.conv1.1.bias", "prblock4.conv2.0.weight",
                          "prblock5.conv2.1.bias", "prblock1.flow.weight"],
    }
    for name, want in keys.items():
        sd = port_model(name).state_dict()
        for key in want:
            assert key in sd, (name, key)
        assert not any(k.endswith(("Pred0.upconv.bias", "Upsamp6to5.upconv.bias")) for k in sd)
        assert not any(".conv.3." in k for k in sd)  # the Estimator's LeakyReLU
    assert "est3_1.conv.0.weight" not in port_model("rdn_share").state_dict()
    pcnet = port_model("pcnet").state_dict()
    # bias-free channel-attention MLP; ResBlock's norm and activation hold no weights
    assert not any(k.endswith(("fc.0.bias", "fc.2.bias", "block.0.weight", "block.1.weight"))
                   for k in pcnet)
    assert "dfi_2.weight_conv.1.0.weight" not in pcnet and "dfi_0.weight_conv.2.0.weight" in pcnet


def test_seeded_init():
    a = port_model("vtn", seed=3).state_dict()
    assert float(a["Pred0.upconv.weight"].std()) < 2e-5
    bound = 1.0 / (3 * 4 ** 3) ** 0.5  # ConvTranspose3d fan-in is Cout·k³
    w = a["Upsamp6to5.upconv.weight"]
    assert 0.5 * bound < float(w.abs().max()) <= bound
    r = port_model("rdn", seed=3).state_dict()
    assert float(r["est2_0.conv.4.weight"].std()) < 2e-5
    assert torch.count_nonzero(r["est2_0.conv.4.bias"]) == 0
    g = port_model("im2grid", seed=3).state_dict()
    assert torch.count_nonzero(g["peblock3.proj.weight"]) == 0
    assert torch.equal(g["peblock3.alpha"], torch.ones(1))
    b = port_model("vtn", seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_sincos_pe_matches_jax():
    for shape in ((2, 3, 4), (10, 12, 10)):
        np.testing.assert_array_equal(_sincos_pe(*shape, 2, 6).numpy(), jax_sincos_pe(*shape, 2, 6))
    np.testing.assert_array_equal(_sincos_pe(3, 4, 5, 4, 10).numpy(), jax_sincos_pe(3, 4, 5, 4, 10))


def test_im2grid_forward_matches_jax_at_32():
    assert_forward_matches_jax("im2grid", 10)


@pytest.mark.parametrize("name,attn,warps", [
    ("im2grid", 5, 9), ("vtn", 0, 1), ("rcn", 0, 19),
    ("rdn", 0, 136), ("rdn_share", 0, 136), ("rdn_diff", 0, 644), ("rdn_diff_share", 0, 644),
    ("pcnet", 0, 33), ("prnet", 0, 9), ("prnetplusplus", 0, 9),
])
def test_kernel_wrapper_calls_per_pair(monkeypatch, name, attn, warps):
    """Every attention and bilinear warp of a pair goes through the kernel
    wrappers (on the CPU: their plain versions), at the reference's depth
    (RCN 10 cascades, RDN stages 4 and levels (4, 4, 4, 4)); these are the
    K1 and K2 launches per pair on the card. ``attn_impl="plain"`` reaches
    no wrapper."""
    counts = {"attn": 0, "warp": 0}
    for mod, fn, key in ((port_attn, "modet_attention_plain", "attn"),
                         (port_warp3d, "warp3d_trilinear_plain", "warp")):
        orig = getattr(mod, fn)

        def counted(*a, _orig=orig, _key=key):
            counts[_key] += 1
            return _orig(*a)

        monkeypatch.setattr(mod, fn, counted)
    full = {"n_cascade": 10, "stages": 4, "levels": (4, 4, 4, 4)}
    shape = (64, 64, 64) if name in ("vtn", "rcn") else (32, 32, 32)
    moving, fixed = (torch.from_numpy(v) for v in pair(shape, 11))
    with torch.no_grad():
        port_model(name, **full)(moving, fixed)
        assert counts == {"attn": attn, "warp": warps}
        port_model(name, attn_impl="plain", **full)(moving, fixed)
    assert counts == {"attn": attn, "warp": warps}


def test_vtn_refuses_lpba_size_in_both_packages():
    """Six stride-2 levels need axes that are multiples of 64: at
    160x192x160 the JAX VTN fails at level 5, and the port refuses before
    any compute; 128x192x128 passes both."""
    lpba = jnp.zeros((1, 160, 192, 160, 1), jnp.float32)
    with pytest.raises(TypeError, match="concatenat"):
        jax.eval_shape(JaxVTN().init, jax.random.PRNGKey(0), lpba, lpba)
    crop = jnp.zeros((1, 128, 192, 128, 1), jnp.float32)
    jax.eval_shape(JaxVTN().init, jax.random.PRNGKey(0), crop, crop)
    for model in (build_vtn(device="meta"), RCN(n_cascade=2, device="meta")):
        x = torch.empty((1, 160, 192, 160, 1), device="meta")
        with pytest.raises(ValueError, match=r"multiple of 64.*\(160, 192, 160\)"):
            model(x, x)
    rcn = RCN(n_cascade=2, attn_impl="plain", device="meta")
    x = torch.empty((1, 128, 192, 128, 1), device="meta")
    assert [tuple(o.shape) for o in rcn(x, x)] == [(1, 128, 192, 128, 1)] + [(1, 128, 192, 128, 3)] * 3


def test_registry_and_config():
    """The port's registry takes exactly the JAX registry's names, with the
    JAX loss plans' criterions and output selection; `TrainConfig` carries
    the baselines' knobs, and ``dropout_rate > 0`` raises citing item 9a."""
    from smilecode_tpu.config import TrainConfig as JaxTrainConfig
    from smilecode_tpu.models.registry import build_model as jax_build_model
    from smilecode_tpu_torch.config import TrainConfig, check_train_config

    cfg = InferConfig()
    assert (cfg.n_cascade, cfg.stages, cfg.levels, cfg.dropout_rate) == (10, 4, (4, 4, 4, 4), 0.0)
    tcfg = TrainConfig()
    assert (tcfg.n_cascade, tcfg.stages, tcfg.levels, tcfg.dropout_rate) == (10, 4, (4, 4, 4, 4),
                                                                              0.0)
    rdn = build_model("rdn_diff_share", InferConfig(stages=1, levels=(1, 1, 1, 1)))
    assert isinstance(rdn, RDN) and rdn.share_weights and rdn.diff and rdn.kernels is True
    plain = build_model("rdn", InferConfig(attn_impl="plain", stages=1, levels=(1, 1, 1, 1)))
    assert not plain.share_weights and not plain.diff and plain.kernels is False
    assert len(build_model("rcn", InferConfig(n_cascade=3)).vtn) == 3
    assert build_model("im2grid", InferConfig()).kernels is True

    names = ("modet", "modet-cu", "modet_cu", "modetcu", "im2grid", "pcnet", "prnet",
             "prnetplusplus", "prnet++", "prpp", "vtn", "rcn", "rdn", "rdn_share", "rdn_diff",
             "rdn_diff_share")
    outs = tuple(f"out{i}" for i in range(8))
    for name in names:
        for knobs in ({}, {"n_cascade": 3, "stages": 2, "levels": (2, 1, 1, 2)}):
            spec = jax_build_model(name, JaxTrainConfig(model=name, **knobs))
            plan = loss_plan(name, TrainConfig(model=name, **knobs))
            assert plan.criterions == tuple(spec.criterions), (name, knobs)
            assert plan.select_train_outputs(outs) == tuple(spec.select_train_outputs(outs))
        model = build_model(name, InferConfig(attn_impl="plain", stages=1, levels=(1, 1, 1, 1),
                                              n_cascade=1), device="meta")
        assert type(model).__name__.lower() == type(spec.module).__name__.lower(), name
    for bad in ("nope", "pcnet2", "prnet+"):
        with pytest.raises(ValueError, match="unknown"):
            build_model(bad, cfg, device="meta")
        with pytest.raises(ValueError, match="unknown"):
            loss_plan(bad)

    # the MC-dropout head is ported: RDN takes dropout_rate > 0 and so does training
    rdn = build_model("rdn", InferConfig(dropout_rate=0.1, stages=1, levels=(1, 1, 1, 1)),
                      device="meta")
    assert {m.dropout_rate for m in rdn.modules() if hasattr(m, "dropout_rate")} == {0.1}
    check_train_config(TrainConfig(model="rdn", dropout_rate=0.1))
    with pytest.raises(NotImplementedError, match="bf16"):
        build_model("pcnet", InferConfig(compute_dtype="bfloat16"))
    with pytest.raises(ValueError, match="attn_impl"):
        build_model("vtn", InferConfig(attn_impl="xla"))


@pytest.mark.parametrize("attn_impl", ["auto", "plain"])
@pytest.mark.parametrize("name", ["modet", "modet-cu", "im2grid", "pcnet", "prnet",
                                  "prnetplusplus", "vtn", "rcn", "rdn", "rdn_share", "rdn_diff",
                                  "rdn_diff_share"])
def test_every_submodule_carries_the_kernel_switch(name, attn_impl):
    """A registry model carries its kernel switch as ``kernels`` on every
    submodule, the model included, at the value ``attn_impl`` parses to
    ("modet-cu" on whatever ``attn_impl``), and no other encoding of it."""
    cfg = InferConfig(attn_impl=attn_impl, n_cascade=2, stages=2, levels=(1, 1, 1, 1))
    model = build_model(name, cfg, device="meta")
    want = attn_impl == "auto" or name == "modet-cu"
    assert {m.kernels for m in model.modules()} == {want}
    assert not [key for m in model.modules() for key in vars(m) if key.endswith("_impl")]


def write_subjects(test_dir, shape, n=3, seed=13):
    """Smooth textures with LPBA labels, as the reference .pkl subjects."""
    os.makedirs(test_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = torch.nn.functional.interpolate(
            torch.from_numpy(rng.random((1, 1, 4, 4, 4)).astype(np.float32)),
            size=shape, mode="trilinear", align_corners=True)[0, 0].numpy()
        seg = LPBA_SEG_TABLE[(img * 54.99).astype(np.int64)].astype(np.uint16)
        with open(os.path.join(test_dir, f"subject_{i:02d}.pkl"), "wb") as f:
            pickle.dump((img, seg), f)


def assert_infer_mains_agree(tmp_path, name, seed, **cfg_kw):
    """`smilecode_tpu_torch.infer.main` and `smilecode_tpu.infer.main` on the
    same subjects and JAX-format checkpoint give equal Dice and fold."""
    from smilecode_tpu import infer as jax_infer
    from smilecode_tpu.config import InferConfig as JaxInferConfig
    from smilecode_tpu_torch import infer as torch_infer

    shape = MODELS[name][2]
    test_dir, model_dir = str(tmp_path / "Test"), str(tmp_path / "exp")
    write_subjects(test_dir, shape)
    save_checkpoint({"epoch": 1, "params": random_jax_params(jax_template(name), seed),
                     "best_dsc": 0.5}, model_dir, "dsc0.500.ckpt")
    kw = dict(model=name, test_dir=test_dir, model_dir=model_dir, **cfg_kw)
    dsc, fold = torch_infer.main(InferConfig(device="cpu", **kw))
    j_dsc, j_fold = jax_infer.main(JaxInferConfig(img_size=shape, **kw))
    assert 0.0 < dsc < 1.0 and 0.0 <= fold < 1.0
    assert dsc == pytest.approx(j_dsc, abs=1e-6)
    assert fold == pytest.approx(j_fold, abs=1e-6)


def test_infer_main_im2grid_matches_jax_infer_main(tmp_path):
    assert_infer_mains_agree(tmp_path, "im2grid", 12)
