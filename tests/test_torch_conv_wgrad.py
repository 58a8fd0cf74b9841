"""K6's plain version and the rule that sends a convolution's weight
gradient to K6 (`kernels/conv3d_wgrad.py`), on the CPU.

The plain version is held to torch autograd's conv3d weight and bias
gradients in float64. The rule is a pure function of what a call can
observe and of the model's kernel switch; on the CPU it never routes to K6,
so every CPU step runs exactly as before, and a model on the plain path
(attn_impl "plain") keeps every weight gradient on cuDNN on the card too. K6 itself is held to a float64 reference on the card
(`tests/test_torch_cuda.py`).
"""

import collections
import copy
import math

import pytest
import torch
import torch.nn.functional as F
from torch import nn

import chip_smoke
from smilecode_tpu_torch import train
from smilecode_tpu_torch.config import InferConfig, TrainConfig
from smilecode_tpu_torch.kernels import conv3d_wgrad as k6
from smilecode_tpu_torch.kernels import launch_counters
from smilecode_tpu_torch.models.modet import ModeT
from smilecode_tpu_torch.models.registry import build_model, loss_plan
from smilecode_tpu_torch.ops import blocks


def _autograd_grads(x, dy, bias=True):
    """torch autograd's dW and db of a 3x3x3 s1 p1 conv3d at x, dy (NDHWC)."""
    cin, cout = x.shape[-1], dy.shape[-1]
    w = torch.randn((cout, cin, 3, 3, 3), dtype=x.dtype, requires_grad=True)
    b = torch.zeros(cout, dtype=x.dtype, requires_grad=True) if bias else None
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, 1, 1)
    y.backward(dy.permute(0, 4, 1, 2, 3))
    return w.grad, None if b is None else b.grad


def _pair(batch, shape, cin, cout, seed=0, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((batch, *shape, cin), generator=gen, dtype=dtype),
            torch.randn((batch, *shape, cout), generator=gen, dtype=dtype))


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("cout", [2, 4, 12])
@pytest.mark.parametrize("cin", [1, 3, 8])
@pytest.mark.parametrize("shape", [(7, 9, 5), (5, 6, 11)])
def test_plain_matches_autograd_in_float64(shape, cin, cout, batch):
    x, dy = _pair(batch, shape, cin, cout, seed=cin * 100 + cout)
    dw, db = k6.conv3d_wgrad_plain(x, dy)
    ref_w, ref_b = _autograd_grads(x, dy)
    torch.testing.assert_close(dw, ref_w, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(db, ref_b, rtol=1e-12, atol=1e-12)


# (Cin, Cout): the odd widths of PR++'s conv stacks (2c + 27 at c = 8, 16,
# 32), 3-wide flow heads and the widest odd count K6 takes
RAGGED_CHANNELS = [(43, 43), (43, 8), (59, 59), (59, 16), (91, 32), (3, 127), (127, 3),
                   (91, 91), (127, 127)]


@pytest.mark.parametrize("cin,cout", RAGGED_CHANNELS)
def test_plain_and_function_match_autograd_at_ragged_channel_counts(cin, cout):
    """K6's plain version, and `Conv3dWgradFunction` (the module's forward
    bit for bit, dx, dW and db) at the channel counts whose K6 tiles are
    ragged, against autograd in float64."""
    x, dy = _pair(1, (3, 4, 5), cin, cout, seed=cin * 100 + cout)
    dw, db = k6.conv3d_wgrad_plain(x, dy)
    ref_w, ref_b = _autograd_grads(x, dy)
    torch.testing.assert_close(dw, ref_w, rtol=1e-12, atol=1e-10)
    torch.testing.assert_close(db, ref_b, rtol=1e-12, atol=1e-12)
    torch.manual_seed(cin + cout)
    conv = nn.Conv3d(cin, cout, 3, 1, 1).double().to(memory_format=torch.channels_last_3d)
    xc = x.permute(0, 4, 1, 2, 3).requires_grad_()
    y = conv(xc)
    y.backward(dy.permute(0, 4, 1, 2, 3))
    ref = [p.grad.clone() for p in (xc, conv.weight, conv.bias)]
    conv.zero_grad()
    xc2 = x.permute(0, 4, 1, 2, 3).requires_grad_()
    y2 = k6.Conv3dWgradFunction.apply(xc2, conv.weight, conv.bias)
    assert torch.equal(y2, y)
    y2.backward(dy.permute(0, 4, 1, 2, 3))
    for got, want in zip((xc2.grad, conv.weight.grad, conv.bias.grad), ref):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-10)


def test_plain_without_bias_gives_none():
    x, dy = _pair(1, (3, 4, 5), 2, 3)
    dw, db = k6.conv3d_wgrad_plain(x, dy, want_bias=False)
    assert db is None and dw.shape == (3, 2, 3, 3, 3)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    x, dy = _pair(2, (4, 5, 3), 4, 6, dtype=torch.float32)
    before = k6.conv3d_wgrad.launches
    dw, db = k6.conv3d_wgrad(x, dy)
    ref_w, ref_b = k6.conv3d_wgrad_plain(x, dy)
    assert k6.conv3d_wgrad.launches == before
    assert dw.is_contiguous(memory_format=torch.channels_last_3d)
    assert torch.equal(dw, ref_w) and torch.equal(db, ref_b)


def test_function_gives_a_contiguous_weight_its_gradient_in_its_strides():
    """The Function's dW is channels_last_3d; autograd stores it in the
    strides of a weight that is not."""
    torch.manual_seed(5)
    conv = nn.Conv3d(2, 3, 3, 1, 1).double()
    x, dy = _pair(1, (3, 4, 5), 2, 3, seed=6)
    k6.Conv3dWgradFunction.apply(x.permute(0, 4, 1, 2, 3), conv.weight, conv.bias).backward(
        dy.permute(0, 4, 1, 2, 3))
    ref_w, ref_b = _autograd_grads(x, dy)
    assert conv.weight.grad.is_contiguous()
    torch.testing.assert_close(conv.weight.grad, ref_w, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(conv.bias.grad, ref_b, rtol=1e-12, atol=1e-12)


def test_wrapper_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="must share"):
        k6.conv3d_wgrad(torch.zeros((1, 3, 3, 3, 2)), torch.zeros((1, 3, 3, 4, 2)))


@pytest.mark.parametrize("input_grad", [True, False], ids=["dx", "no-dx"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
def test_function_matches_the_module_and_its_autograd(bias, input_grad):
    """`Conv3dWgradFunction` on CPU tensors: the module's forward, bit for
    bit; dx from aten's convolution backward and dW, db from the plain
    version, against autograd through the module."""
    torch.manual_seed(3)
    conv = nn.Conv3d(3, 5, 3, 1, 1, bias=bias).double().to(memory_format=torch.channels_last_3d)
    x, dy = _pair(2, (4, 6, 5), 3, 5, seed=4)
    xc = x.permute(0, 4, 1, 2, 3).requires_grad_(input_grad)
    y = conv(xc)
    y.backward(dy.permute(0, 4, 1, 2, 3))
    ref = [None if p is None or p.grad is None else p.grad.clone()
           for p in (xc, conv.weight, conv.bias)]
    conv.zero_grad()
    xc2 = x.permute(0, 4, 1, 2, 3).requires_grad_(input_grad)
    y2 = k6.Conv3dWgradFunction.apply(xc2, conv.weight, conv.bias)
    assert torch.equal(y2, y)
    y2.backward(dy.permute(0, 4, 1, 2, 3))
    assert (xc2.grad is None) == (not input_grad)
    if input_grad:
        torch.testing.assert_close(xc2.grad, ref[0], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(conv.weight.grad, ref[1], rtol=1e-12, atol=1e-12)
    assert conv.weight.grad.stride() == conv.weight.stride()
    if bias:
        torch.testing.assert_close(conv.bias.grad, ref[2], rtol=1e-12, atol=1e-12)


def _modet():
    return ModeT(qk_scale=1.0, generator=torch.Generator().manual_seed(0))


def test_modet_training_applies_31_bare_convs_that_the_rule_sends_to_k6():
    """A ModeT forward applies its 20 bare Conv3d modules 31 times (the
    encoder's 11 on the moving and on the fixed image, CWM5-3's 9); each
    is one the rule sends to K6 for a float32 activation on the card."""
    model = _modet()
    convs = [m for m in model.modules() if isinstance(m, nn.Conv3d)]
    assert len(convs) == 20
    calls = []
    for m in convs:
        m.register_forward_pre_hook(lambda mod, args: calls.append(mod))
    vol = torch.rand((1, 16, 16, 16, 1), generator=torch.Generator().manual_seed(1))
    model(vol, vol)
    assert len(calls) == 31
    assert all(k6.wgrad_route(m, torch.float32, "cuda", True) == "K6" for m in calls)


@pytest.mark.parametrize("case,want", [
    ("stride 2", "declined"),
    ("padding (0, 1, 1)", "declined"),
    ("groups 2", "declined"),
    ("dilation 2", "declined"),
    ("kernel 1", "declined"),
    ("129 input channels", "declined"),
    ("ConvTranspose3d", None),
    ("Sequential", None),
    ("bf16 activation", None),
    ("no gradient wanted", None),
    ("weight frozen", None),
    ("bf16 weight", None),
    ("on the CPU", None),
    ("a plain model's", None),
])
def test_rule_leaves_other_convolutions_to_cudnn(case, want):
    conv, dtype, device, grad = nn.Conv3d(4, 8, 3, 1, 1), torch.float32, "cuda", True
    if case == "stride 2":
        conv = nn.Conv3d(4, 8, 3, 2, 1)
    elif case == "padding (0, 1, 1)":
        conv = nn.Conv3d(4, 8, 3, 1, (0, 1, 1))
    elif case == "groups 2":
        conv = nn.Conv3d(4, 8, 3, 1, 1, groups=2)
    elif case == "dilation 2":
        conv = nn.Conv3d(4, 8, 3, 1, 2, dilation=2)
    elif case == "kernel 1":
        conv = nn.Conv3d(4, 8, 1, 1, 0)
    elif case == "129 input channels":
        conv = nn.Conv3d(129, 8, 3, 1, 1)
    elif case == "ConvTranspose3d":
        conv = nn.ConvTranspose3d(4, 8, 4, 2)
    elif case == "Sequential":
        conv = nn.Sequential(nn.Conv3d(4, 8, 3, 1, 1))
    elif case == "bf16 activation":
        dtype = torch.bfloat16
    elif case == "no gradient wanted":
        grad = False
    elif case == "weight frozen":
        conv.weight.requires_grad_(False)
    elif case == "bf16 weight":
        conv = conv.to(torch.bfloat16)
        dtype = torch.bfloat16
    elif case == "on the CPU":
        device = "cpu"
    elif case == "a plain model's":
        blocks.mark_model_(conv, "plain")
    assert k6.wgrad_route(conv, dtype, device, grad) == want


def _stack(attn_impl="auto"):
    """A Sequential as the models hold them: a k3 s1 conv K6 takes, a
    LeakyReLU, a stride-2 conv, a 256-wide conv and a k3 s1 conv to 3."""
    seq = nn.Sequential(nn.Conv3d(4, 8, 3, 1, 1), nn.LeakyReLU(0.1), nn.Conv3d(8, 256, 3, 2, 1),
                        nn.Conv3d(256, 8, 3, 1, 1), nn.Conv3d(8, 3, 3, 1, 1))
    blocks.mark_model_(seq, attn_impl)
    return seq


def _routes_through(monkeypatch, seq, x, device_type="cuda", grad=True):
    """The rule's answer for each child that `conv3d_ndhwc` asks about, as it
    would be on ``device_type`` (the call itself runs on the CPU)."""
    rule, asked = k6.wgrad_route, []

    def as_on(conv, dtype, _device_type, grad_mode, voxels=0):
        asked.append((type(conv).__name__, rule(conv, dtype, device_type, grad_mode, voxels)))
        return None

    monkeypatch.setattr(blocks, "wgrad_route", as_on)
    with torch.set_grad_enabled(grad):
        blocks.conv3d_ndhwc(seq, x)
    return asked


def test_rule_routes_each_child_of_a_sequential(monkeypatch):
    """`conv3d_ndhwc` asks the rule about every child of a Sequential, in
    order: K6 for the k3 s1 convs, declined for the stride-2 and the
    256-wide ones, None for the LeakyReLU between them."""
    x = torch.rand((1, 4, 6, 8, 4))
    assert _routes_through(monkeypatch, _stack(), x) == [
        ("Conv3d", "K6"), ("LeakyReLU", None), ("Conv3d", "declined"), ("Conv3d", "declined"),
        ("Conv3d", "K6")]


@pytest.mark.parametrize("case", ["no gradient wanted", "on the CPU", "a plain model's"])
def test_rule_leaves_every_child_of_a_sequential_to_cudnn(monkeypatch, case):
    x = torch.rand((1, 4, 6, 8, 4))
    asked = _routes_through(monkeypatch, _stack("plain" if case == "a plain model's" else "auto"), x,
                            device_type="cpu" if case == "on the CPU" else "cuda",
                            grad=case != "no gradient wanted")
    assert [name for name, _ in asked] == ["Conv3d", "LeakyReLU", "Conv3d", "Conv3d", "Conv3d"]
    assert {route for _, route in asked} == {None}


def test_sequential_through_k6s_function_matches_the_sequential(monkeypatch):
    """`conv3d_ndhwc` over a Sequential with the rule answering as on the
    card for its float32 twin, so that its k3 s1 children run through
    `Conv3dWgradFunction` (dW and db from the plain version on the CPU): the
    Sequential's own output, bit for bit, and every gradient as autograd
    through the Sequential gives it, in float64; the declined convs
    counted."""
    twin = _stack()
    seq = copy.deepcopy(twin).double()
    answers = {id(c): k6.wgrad_route(t, torch.float32, "cuda", True) for t, c in zip(twin, seq)}
    monkeypatch.setattr(blocks, "wgrad_route",
                        lambda conv, _dtype, _device, grad, _voxels: answers[id(conv)] if grad
                        else None)
    x = torch.rand((1, 4, 6, 8, 4), dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    xc = x.permute(0, 4, 1, 2, 3).requires_grad_()
    want = seq(xc)
    g = torch.rand(want.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    want.backward(g)
    ref = [xc.grad] + [p.grad.clone() for p in seq.parameters()]
    seq.zero_grad()
    applied = []
    monkeypatch.setattr(k6.Conv3dWgradFunction, "apply",
                        lambda *a, fn=k6.Conv3dWgradFunction.apply: applied.append(1) or fn(*a))
    x2 = x.clone().requires_grad_()
    declined = k6.conv3d_wgrad.declined
    y = blocks.conv3d_ndhwc(seq, x2)
    assert len(applied) == 2 and k6.conv3d_wgrad.declined == declined + 2
    assert torch.equal(y, want.permute(0, 2, 3, 4, 1))
    y.backward(g.permute(0, 2, 3, 4, 1))
    for got, exp in zip([x2.grad.permute(0, 4, 1, 2, 3)] + [p.grad for p in seq.parameters()], ref):
        torch.testing.assert_close(got, exp, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cin,cout,voxels,want", [
    (91, 91, 20 * 24 * 20, "declined"), (128, 128, 20 * 24 * 20, "declined"),
    (65, 65, 4096, "declined"), (91, 91, 40 * 48 * 40, "declined"),
    (128, 128, 10 * 12 * 10, "K6"), (65, 65, 4095, "K6"), (64, 128, 20 * 24 * 20, "K6"),
    (128, 3, 20 * 24 * 20, "K6"), (91, 32, 40 * 48 * 40, "K6"), (59, 59, 160 * 192 * 160, "K6"),
])
def test_rule_declines_convs_wide_on_both_sides_over_large_volumes(cin, cout, voxels, want):
    """Both channel counts above WIDE_CHANNELS over WIDE_VOXELS voxels or
    more go to cuDNN; a narrower side or a smaller volume keeps K6."""
    conv = nn.Conv3d(cin, cout, 3, 1, 1)
    assert k6.wgrad_route(conv, torch.float32, "cuda", True, voxels) == want


def test_rule_never_routes_to_k6_on_the_cpu():
    assert all(k6.wgrad_route(m, torch.float32, "cpu", True) is None
               for m in _modet().modules() if isinstance(m, nn.Conv3d))


# (family, test volume, knobs): the depth chip_smoke.py trains each at
STEP_FAMILIES = [("modet", (16, 16, 16), {}), ("im2grid", (32, 32, 32), {}),
                 ("pcnet", (16, 16, 16), {}), ("prnet", (32, 32, 32), {}),
                 ("prnetplusplus", (32, 32, 32), {}), ("rcn", (64, 64, 64), {"n_cascade": 10}),
                 ("rdn", (32, 32, 32), {"stages": 4, "levels": (4, 4, 4, 4)}),
                 ("rdn_diff_share", (32, 32, 32), {"stages": 4, "levels": (4, 4, 4, 4)})]


def _routes_per_training_step(monkeypatch, name, shape, attn_impl, knobs):
    """The rule's answer for each convolution of one loss-and-gradients pass
    of ``name``, as it would be on the card at the volume chip_smoke.py
    trains it at (every level's voxels scaled from ``shape`` to it; the pass
    itself runs on the CPU, where the rule sends nothing to K6)."""
    rule, routes = k6.wgrad_route, collections.Counter()
    card = chip_smoke.ZOO[name][0] if name in chip_smoke.ZOO else chip_smoke.SIZE
    scale = math.prod(card) // math.prod(shape)

    def on_the_card(conv, dtype, device_type, grad_mode, voxels=0):
        routes[rule(conv, dtype, "cuda", grad_mode, voxels * scale)] += 1
        return rule(conv, dtype, device_type, grad_mode, voxels)

    monkeypatch.setattr(blocks, "wgrad_route", on_the_card)
    model = build_model(name, InferConfig(model=name, attn_impl=attn_impl, **knobs),
                        generator=torch.Generator().manual_seed(0)).train()
    gen = torch.Generator().manual_seed(1)
    x, y = (torch.rand((1, *shape, 1), generator=gen) for _ in range(2))
    train.make_loss_and_grads(model, loss_plan(name, TrainConfig(model=name, **knobs)),
                              (1.0, 1.0))(x, y)
    return routes


@pytest.mark.parametrize("name,shape,knobs", STEP_FAMILIES, ids=[f[0] for f in STEP_FAMILIES])
def test_k6_launches_and_declines_per_training_step_are_chip_smokes(monkeypatch, name, shape,
                                                                     knobs):
    """K6's launches and declined weight gradients per training step of each
    family, as chip_smoke.py requires them on the card (``ZOO``; ModeT's 31
    and none declined), and none at all on the plain path."""
    step = dict(zip(chip_smoke.STEP_KEYS, chip_smoke.ZOO[name][2])) if name != "modet" else {}
    want = (31, 0) if name == "modet" else (step["K6"], step["K6 declined"])
    routes = _routes_per_training_step(monkeypatch, name, shape, "auto", knobs)
    assert (routes["K6"], routes["declined"]) == want, routes
    plain = _routes_per_training_step(monkeypatch, name, shape, "plain", knobs)
    assert set(plain) == {None}, plain


def test_cpu_training_forward_takes_todays_path(monkeypatch):
    """On the CPU, `conv3d_ndhwc` with gradients on applies the module
    itself: the K6 Function is never entered and nothing is declined."""
    def refuse(*args):
        raise AssertionError("K6's Function on the CPU")

    monkeypatch.setattr(k6.Conv3dWgradFunction, "apply", refuse)
    conv = nn.Conv3d(4, 8, 3, 1, 1).to(memory_format=torch.channels_last_3d)
    x = torch.rand((1, 5, 6, 7, 4), requires_grad=True)
    declined = k6.conv3d_wgrad.declined
    y = blocks.conv3d_ndhwc(conv, x)
    y.sum().backward()
    assert torch.equal(y, conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1))
    assert conv.weight.grad is not None and k6.conv3d_wgrad.declined == declined


def test_launch_counters_report_k6():
    counters = launch_counters()
    assert "K6 launches" in counters and "K6 declined" in counters
