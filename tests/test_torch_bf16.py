"""ModeT's bf16 feature path (`compute_dtype="bfloat16"`) in the port vs the
JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do:
ModeT with ``attn_impl="pallas"`` (the registry's "modet-cu": kernel A and its
B/C backward on bf16 q and k; not the "xla" oracle, whose bf16 logits no
kernel computes), and the planes warp `_warp_planes_hw` (kernels D and G)
with the v4-first switch forced at test sizes. The port runs its plain
versions, the kernels' oracles on the card. Inputs come from numpy seeds.

Tolerances (each test states its own):
* attention forward, bf16 out on the same bf16 inputs: 2 bf16 ulps,
  2^-7 * max|ref| (both compute in float32 and round once);
* attention gradients dq, dk, drpb: 5e-2 of each gradient's largest
  magnitude, the JAX package's own bf16 bound (tests/test_pallas_attn.py);
* warp: bf16 out within 2 ulps; d_flow and d_src within 0.03, the bound of
  tests/test_modet_planes.py::test_bf16_vs_f32_warp_kernel;
* ModeT forward at 32^3, excited weights: the port's bf16 flow against JAX
  bf16, mean and p99 of the per-component endpoint error no larger than JAX's
  own bf16-vs-f32 error and below 0.06 / 0.3 voxel, moved p99 < 0.1
  (tests/test_modet.py::test_bf16_compute_matches_f32, bench.py's gate):
  bf16 rounds in other places in the two frameworks (fused vs unfused norms),
  and the attention cascade amplifies a flipped ulp, so the bound is
  statistical;
* the training step at 16^3 is in tests/test_torch_bf16_step.py (its JAX
  compile takes minutes, so it is a file of its own for the test workers).
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smilecode_tpu.kernels.modet_attn import modet_attention_pallas
from smilecode_tpu.models import ModeT as JaxModeT
from smilecode_tpu.ops.warp import warp as jax_warp
from smilecode_tpu.utils.checkpoint import save_checkpoint
from smilecode_tpu_torch.config import InferConfig, TrainConfig
from smilecode_tpu_torch.data.trans import LPBA_SEG_TABLE
from smilecode_tpu_torch.kernels import modet_attn, warp3d
from smilecode_tpu_torch.kernels.modet_attn import modet_attention_bwd_plain, modet_attention_plain
from smilecode_tpu_torch.kernels.warp3d import warp3d_trilinear_bwd_plain, warp3d_trilinear_plain
from smilecode_tpu_torch.models import ModeT
from smilecode_tpu_torch.models.registry import loss_plan
from smilecode_tpu_torch.ops.blocks import ConvInsBlock, conv3d_ndhwc
from smilecode_tpu_torch.ops.resize import avg_pool2, upsample2_trilinear
from smilecode_tpu_torch.ops.warp import warp
from smilecode_tpu_torch.train import make_loss_and_grads
from test_torch_modet import jax_params

torch.set_num_threads(1)
BF16 = torch.bfloat16
ULP2 = 2.0 ** -7  # 2 bf16 ulps of the largest magnitude


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def to_np(t):
    return t.detach().float().numpy()


def smooth_vol(shape, seed):
    """Sum of random Gaussian blobs in [0, 1] (tests/test_modet.py)."""
    g = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    r = np.random.default_rng(seed)
    v = np.zeros(shape, np.float32)
    for _ in range(30):
        c, s, a = r.uniform(4, max(shape) - 4, 3), r.uniform(2, 6), r.uniform(0.3, 1.0)
        v += a * np.exp(-np.sum((g - c) ** 2, -1) / (2 * s * s))
    return ((v - v.min()) / (v.max() - v.min())).astype(np.float32)[None, ..., None]


def excited_model(seed, **kw):
    """Seeded port ModeT with 0.1 N(0, 1) added to the projection kernels and
    the rpb (tests/test_modet.py), so that flows are not near zero."""
    model = ModeT(qk_scale=1.0, generator=torch.Generator().manual_seed(seed), **kw).eval()
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("proj.weight", "rpb")):
                p.add_(torch.from_numpy(0.1 * rng.standard_normal(p.shape).astype(np.float32)))
    return model


def endpoint_stats(a, b):
    err = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return float(err.mean()), float(np.percentile(err, 99))


# ---------------------------------------------------------------- layers


def test_bf16_layers_keep_dtype_and_give_float32_grads():
    x = torch.from_numpy(rand((1, 8, 8, 8, 4), 1)).to(BF16).requires_grad_()
    block = ConvInsBlock(4, 8)
    y = block(x)
    assert y.dtype == BF16 and block.main.weight.dtype == torch.float32
    assert upsample2_trilinear(y).dtype == BF16 and avg_pool2(y).dtype == BF16
    y.float().sum().backward()
    assert block.main.weight.grad.dtype == torch.float32 and x.grad.dtype == BF16
    # a float32 activation takes the float32 path untouched
    x32 = x.detach().float()
    torch.testing.assert_close(conv3d_ndhwc(block.main, x32),
                               block.main(x32.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1),
                               rtol=0, atol=0)


# ------------------------------------------------------------- attention


@pytest.mark.parametrize("shape,heads,scale", [((4, 5, 6), 1, 1.0), ((3, 4, 5), 2, 0.5)])
def test_attention_forward_bf16_matches_jax_kernel_a(shape, heads, scale):
    """2 bf16 ulps: both sides scale q in bf16 and compute in float32."""
    q = rand((1, *shape, heads, 6), 2)
    k = rand((1, *shape, heads, 6), 3)
    rpb = rand((heads, 3, 3, 3), 4)
    out = modet_attention_plain(torch.from_numpy(q).to(BF16), torch.from_numpy(k).to(BF16),
                                torch.from_numpy(rpb), scale)
    ref = modet_attention_pallas(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                                 jnp.asarray(rpb), scale, True)
    assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(to_np(out), ref, rtol=0, atol=ULP2 * np.abs(ref).max())


def test_attention_grads_bf16_match_jax_kernels_b_c():
    """dq, dk, drpb through autograd of the plain version and through the
    written-out backward (K3/K4's oracle, dl rounded to bf16 before dk as
    kernel B stores it) against jax.grad of kernel A (B/C backward),
    interpret mode: within 5e-2 of each gradient's largest magnitude."""
    shape, heads = (4, 6, 5), 2
    q, k = rand((1, *shape, heads, 6), 5), rand((1, *shape, heads, 6), 6)
    rpb, g = rand((heads, 3, 3, 3), 7), rand((1, *shape, heads * 3), 8)

    def loss(q_, k_, r_):
        out = modet_attention_pallas(q_.astype(jnp.bfloat16), k_.astype(jnp.bfloat16), r_, 1.0, True)
        return jnp.sum(out.astype(jnp.float32) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(rpb))
    want = [np.asarray(w, np.float32) for w in want]

    leaves = [torch.from_numpy(q).to(BF16).requires_grad_(), torch.from_numpy(k).to(BF16)
              .requires_grad_(), torch.from_numpy(rpb).requires_grad_()]
    (modet_attention_plain(*leaves, 1.0).float() * torch.from_numpy(g)).sum().backward()
    by_autograd = [leaf.grad for leaf in leaves]
    written = modet_attention_bwd_plain(*(leaf.detach() for leaf in leaves), 1.0,
                                        torch.from_numpy(g).to(BF16))
    assert [t.dtype for t in written] == [BF16, BF16, torch.float32]
    for how, got in (("autograd", by_autograd), ("written-out", written)):
        for name, a, w in zip(("dq", "dk", "drpb"), got, want):
            rel = float(np.abs(to_np(a) - w).max() / np.abs(w).max())
            print(f"{how} {name}: max err / max |grad| = {rel:.2e}")
            assert rel <= 5e-2, (how, name, rel)


# ------------------------------------------------------------------ warp


@pytest.fixture
def hw_warp_interpret(monkeypatch):
    """`_warp_planes_hw`'s kernels in interpret mode, the v4-first switch
    forced at test sizes (tests/test_modet_planes.py)."""
    import smilecode_tpu.models.modet_planes as MP

    monkeypatch.setattr(MP, "_V3_INTERPRET", True)
    monkeypatch.setattr(MP, "_V4_MIN_VOXELS", 1)
    return MP


def smooth_flow(shape, amp=1.5):
    g = np.stack(np.meshgrid(*[np.linspace(0, 2 * np.pi, s) for s in shape], indexing="ij"), -1)
    return (amp * np.stack([np.sin(g[..., 0] + i) * np.cos(g[..., 1] - i) for i in range(3)],
                           -1)).astype(np.float32)[None]


def test_warp_bf16_and_its_adjoint_match_jax_kernels_d_g(hw_warp_interpret):
    """A bf16 source, a float32 flow: the output (bf16) within 2 ulps of JAX
    D on the same bf16 source, d_flow (float32) and d_src (bf16) within
    0.03 of JAX G and its scatter (jax.grad), by autograd of the plain
    version and by K5's written-out plain version."""
    MP = hw_warp_interpret
    shape, c = (8, 12, 8), 3
    src, flow, g = rand((1, *shape, c), 9), smooth_flow(shape), rand((1, *shape, c), 10)

    def jax_loss(s, f):
        out = MP._warp_planes_hw(s.astype(jnp.bfloat16), f, True)
        return jnp.sum(out.astype(jnp.float32) * g.transpose(0, 4, 1, 2, 3)), out

    (_, ref), (d_src, d_flow) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(src.transpose(0, 4, 1, 2, 3)), jnp.asarray(flow.transpose(0, 4, 1, 2, 3)))
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref, np.float32).transpose(0, 2, 3, 4, 1)
    want = {"d_src": np.asarray(d_src, np.float32).transpose(0, 2, 3, 4, 1),
            "d_flow": np.asarray(d_flow).transpose(0, 2, 3, 4, 1)}

    s = torch.from_numpy(src).to(BF16).requires_grad_()
    f = torch.from_numpy(flow).requires_grad_()
    out = warp(s, f)
    assert out.dtype == BF16
    np.testing.assert_allclose(to_np(out), ref, rtol=0, atol=ULP2 * np.abs(ref).max())
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert s.grad.dtype == BF16 and f.grad.dtype == torch.float32
    written = warp3d_trilinear_bwd_plain(s.detach(), f.detach(), torch.from_numpy(g).to(BF16))
    for how, (gs, gf) in (("autograd", (s.grad, f.grad)), ("written-out", written)):
        for name, a in (("d_src", gs), ("d_flow", gf)):
            err = float(np.abs(to_np(a) - want[name]).max())
            print(f"{how} {name}: max abs err {err:.2e} (max |grad| {np.abs(want[name]).max():.2f})")
            assert err < 0.03, (how, name, err)


@pytest.mark.parametrize("src_shape,flow_shape", [((8, 10, 6), (8, 10, 6)),
                                                  ((9, 11, 7), (5, 6, 4))])  # shape mismatch
def test_warp_bf16_matches_jax_ops_warp_and_f_entries(src_shape, flow_shape):
    """The port's ``warp`` of a bf16 source with the kernel switch on (the
    K2 wrapper, the counterpart of F's entries "pallas" and "guarded"),
    against JAX's packed warp and its kernel F in interpret mode: bf16 out
    within 2 ulps."""
    src, flow = rand((1, *src_shape, 4), 11), smooth_flow(flow_shape, 1.2)
    js, jf = jnp.asarray(src, jnp.bfloat16), jnp.asarray(flow)
    refs = {"packed": jax_warp(js, jf), "pallas": jax_warp(js, jf, impl="pallas"),
            "guarded": jax_warp(js, jf, impl="guarded")}
    plain = warp3d_trilinear_plain(torch.from_numpy(src).to(BF16), torch.from_numpy(flow))
    out = warp(torch.from_numpy(src).to(BF16), torch.from_numpy(flow), kernels=True)
    assert out.dtype == BF16 and out.shape == (1, *flow_shape, 4)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    for name, ref in refs.items():
        assert ref.dtype == jnp.bfloat16, name
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(to_np(plain), ref, rtol=0, atol=ULP2 * np.abs(ref).max(),
                                   err_msg=name)


# ----------------------------------------------------------------- model

FWD_SHAPE = (32, 32, 32)
STEP_SHAPE = (16, 16, 16)


def test_modet_bf16_forward_matches_jax_at_32():
    """The float32 reference is the port's float32 forward, which equals
    JAX's within 2e-4 (tests/test_torch_modet.py)."""
    model = excited_model(20)
    moving, fixed = smooth_vol(FWD_SHAPE, 1), smooth_vol(FWD_SHAPE, 2)
    jm = JaxModeT(qk_scale=1.0, attn_impl="pallas", compute_dtype="bfloat16")
    j_moved16, j_flow16 = jax.jit(jm.apply)(jax_params(model, FWD_SHAPE), jnp.asarray(moving),
                                            jnp.asarray(fixed))
    bf16 = ModeT(qk_scale=1.0, compute_dtype="bfloat16").eval()
    bf16.load_state_dict(model.state_dict())
    with torch.no_grad():
        moved, flow = bf16(torch.from_numpy(moving), torch.from_numpy(fixed))
        _, flow32 = model(torch.from_numpy(moving), torch.from_numpy(fixed))
    assert moved.dtype == flow.dtype == torch.float32 and flow.shape == (1, *FWD_SHAPE, 3)
    assert j_flow16.dtype == jnp.float32 and float(flow32.abs().max()) > 0.05
    jax_own = endpoint_stats(j_flow16, flow32.numpy())
    ours = endpoint_stats(flow.numpy(), j_flow16)
    ours_vs_f32 = endpoint_stats(flow.numpy(), flow32.numpy())
    moved_p99 = float(np.percentile(np.abs(moved.numpy() - np.asarray(j_moved16)), 99))
    print(f"flow endpoint error (mean, p99): port bf16 vs JAX bf16 {ours}, JAX bf16 vs f32 "
          f"{jax_own}, port bf16 vs port f32 {ours_vs_f32}; moved p99 {moved_p99:.4f}")
    assert ours[0] <= jax_own[0] and ours[1] <= jax_own[1], (ours, jax_own)
    for mean, p99 in (ours, ours_vs_f32):
        assert mean < 0.06 and p99 < 0.3
    assert moved_p99 < 0.1


def test_wrapper_calls_by_dtype_per_pair_and_per_step(monkeypatch):
    """The kernel wrappers' calls on the bf16 path, counted by dtype through
    their plain versions (what the card's counters count): per pair K1 5
    bf16, K2 4 bf16 + 5 float32; per training step also K3/K4 5 bf16 (one
    attention backward each) and K5 4 bf16 + 5 float32 backward warps, 8 of
    them with a source that needs a gradient (the d_src scatter)."""
    calls = []

    def counted(kernel, plain):
        def fn(*args):
            out = plain(*args)
            src = args[0]
            calls.append((kernel, src.dtype, "fwd"))
            if out.requires_grad:
                scatter = kernel == "K2" and src.requires_grad
                out.register_hook(lambda g: calls.append((kernel, src.dtype,
                                                          "bwd+scatter" if scatter else "bwd")))
            return out
        return fn

    monkeypatch.setattr(modet_attn, "modet_attention_plain",
                        counted("K1", modet_attn.modet_attention_plain))
    monkeypatch.setattr(warp3d, "warp3d_trilinear_plain",
                        counted("K2", warp3d.warp3d_trilinear_plain))
    model = ModeT(qk_scale=1.0, compute_dtype="bfloat16", generator=torch.Generator().manual_seed(1))
    x, y = torch.from_numpy(smooth_vol(STEP_SHAPE, 5)), torch.from_numpy(smooth_vol(STEP_SHAPE, 6))

    def tally():
        out = {}
        for key in calls:
            out[key] = out.get(key, 0) + 1
        calls.clear()
        return out

    with torch.no_grad():
        model(x, y)
    f32 = torch.float32
    assert tally() == {("K1", BF16, "fwd"): 5, ("K2", BF16, "fwd"): 4, ("K2", f32, "fwd"): 5}
    make_loss_and_grads(model, loss_plan("modet"), (1.0, 1.0))(x, y)
    assert tally() == {("K1", BF16, "fwd"): 5, ("K1", BF16, "bwd"): 5,
                       ("K2", BF16, "fwd"): 4, ("K2", f32, "fwd"): 5,
                       ("K2", BF16, "bwd+scatter"): 4, ("K2", f32, "bwd+scatter"): 4,
                       ("K2", f32, "bwd"): 1}


# ---------------------------------------------------------- entry points


@pytest.fixture(scope="module")
def subjects_16(tmp_path_factory):
    """3 synthetic 16^3 subjects (smooth textures, LPBA labels), a JAX-format
    checkpoint of excited seeded weights, train/val splits."""
    root = tmp_path_factory.mktemp("torch_bf16")
    rng = np.random.default_rng(40)
    for split, n in (("Test", 3), ("Train", 3), ("Val", 2)):
        (root / split).mkdir()
        for i in range(n):
            img = torch.nn.functional.interpolate(
                torch.from_numpy(rng.random((1, 1, 4, 4, 4)).astype(np.float32)),
                size=STEP_SHAPE, mode="trilinear", align_corners=True)[0, 0].numpy()
            seg = LPBA_SEG_TABLE[(img * 54.99).astype(np.int64)].astype(np.uint16)
            with open(root / split / f"subject_{i:02d}.pkl", "wb") as f:
                pickle.dump((img, seg), f)
    model = excited_model(41)
    params = jax.tree.map(jnp.asarray, jax_params(model, STEP_SHAPE))
    save_checkpoint({"epoch": 1, "params": params, "best_dsc": 0.5}, str(root / "exp"),
                    "dsc0.500.ckpt")
    return root


def test_infer_main_bf16_matches_jax_infer_main(subjects_16):
    """Dice within 1e-2 and fold within 1e-3 of JAX's `infer.main` with
    model=modet-cu (kernel A in interpret mode) and the same float32
    checkpoint."""
    from smilecode_tpu import infer as jax_infer
    from smilecode_tpu.config import InferConfig as JaxInferConfig
    from smilecode_tpu_torch import infer as torch_infer

    kw = dict(test_dir=str(subjects_16 / "Test"), model_dir=str(subjects_16 / "exp"),
              compute_dtype="bfloat16")
    dsc, fold = torch_infer.main(InferConfig(device="cpu", **kw))
    j_dsc, j_fold = jax_infer.main(JaxInferConfig(model="modet-cu", img_size=STEP_SHAPE,
                                                  fast_path="off", **kw))
    f32_dsc, f32_fold = torch_infer.main(InferConfig(device="cpu", test_dir=kw["test_dir"],
                                                     model_dir=kw["model_dir"]))
    print(f"bf16 dsc {dsc:.5f} fold {fold:.6f}; JAX bf16 {j_dsc:.5f} {j_fold:.6f}; "
          f"port f32 {f32_dsc:.5f} {f32_fold:.6f}")
    assert 0.0 < dsc < 1.0 and 0.0 <= fold < 1.0
    assert dsc == pytest.approx(j_dsc, abs=1e-2)
    assert fold == pytest.approx(j_fold, abs=1e-3)


def test_train_main_bf16_two_epochs_resume_and_load_in_float32(subjects_16, capsys):
    from smilecode_tpu_torch import infer as torch_infer
    from smilecode_tpu_torch import train
    from smilecode_tpu_torch.utils import latest_checkpoint, load_checkpoint

    root = subjects_16
    cfg = TrainConfig(train_dir=str(root / "Train"), val_dir=str(root / "Val"),
                      save_root=str(root / "experiments"), log_root=str(root / "logs"),
                      max_epoch=2, lr=1e-3, num_workers=0, compute_dtype="bfloat16",
                      device="cpu")
    train.main(cfg)
    out = capsys.readouterr().out
    assert "compute dtype: bfloat16" in out
    with open(os.path.join(cfg.log_root, cfg.save_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if '"iter"' in line]
    losses = np.array([r["loss"] for r in rows])
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert losses[6:].mean() < losses[:6].mean(), losses
    exp_dir = os.path.join(cfg.save_root, cfg.save_dir)
    state = load_checkpoint(latest_checkpoint(exp_dir))
    assert all(v.dtype == np.float32 for v in jax.tree.leaves(state["params"]))

    cfg.cont_training, cfg.max_epoch = True, 3
    train.main(cfg)
    assert "at epoch 2" in capsys.readouterr().out
    # a bf16-trained checkpoint serves in float32 and in bf16
    for dtype in ("", "bfloat16"):
        dsc, fold = torch_infer.main(InferConfig(test_dir=str(root / "Val"), model_dir=exp_dir,
                                                 compute_dtype=dtype, device="cpu"))
        assert 0.0 < dsc < 1.0 and np.isfinite(fold)
