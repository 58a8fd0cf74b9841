"""K8's rule, its wrapper's checks and the LayerNorm paths that run on the CPU.

K8 itself (`csrc/layer_norm.cu`) runs on the card only: tests/test_torch_cuda.py
holds it against LayerNorm in float64 there. Here: `k8_route`'s table, the
checks the wrapper makes before a launch, `layer_norm_plain` (K8's oracle)
against ``nn.LayerNorm`` bit for bit, and `ops.blocks.layer_norm`'s CPU
paths: float32 through the plain version, bfloat16 as the JAX layer's
separate ops, unchanged.
"""

import itertools

import pytest
import torch
from torch import nn

from smilecode_tpu_torch.kernels import launch_counters
from smilecode_tpu_torch.kernels import layer_norm as k8
from smilecode_tpu_torch.models.modet import ProjectionLayer
from smilecode_tpu_torch.ops import blocks


def _rand(shape, seed, scale=1.0, shift=0.0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * scale + shift


@pytest.mark.parametrize("dtype,device,kernels", list(itertools.product(
    (torch.float32, torch.bfloat16), ("cuda", "cpu"), (True, False))))
def test_k8_route_sends_float32_on_the_card_in_a_kernel_model(dtype, device, kernels):
    want = dtype == torch.float32 and device == "cuda" and kernels
    assert k8.k8_route(dtype, device, kernels) is want


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_k8_route_refuses_other_dtypes_on_the_card(dtype):
    with pytest.raises(ValueError, match="K8 takes float32"):
        k8.k8_route(dtype, "cuda", True)
    assert k8.k8_route(dtype, "cuda", False) is False
    assert k8.k8_route(dtype, "cpu", True) is False


@pytest.mark.parametrize("n,rows", [(1, 512), (6, 512), (7, 512), (12, 320), (24, 160),
                                    (48, 64), (129, 32), (256, 32)])
def test_tile_rows_are_whole_warps_of_about_4096_values(n, rows):
    """The rows of a tile that the C entry points accept
    (`csrc/layer_norm.cu:valid_rows`): 32 to 512, a multiple of 32, at most
    8192 values."""
    t = k8.tile_rows(n)
    assert t == rows and t % 32 == 0 and 32 <= t <= 512 and t * n <= 8192


@pytest.mark.parametrize("shape,w,b,match", [
    ((4, 6), (5,), (6,), "weight must be"),
    ((4, 6), (6,), (6, 1), "bias must be"),
    ((4, 6), None, (6,), "weight must be"),
    ((4, 0), (0,), (0,), "rows 1 to 256"),
    ((2, 257), (257,), (257,), "rows 1 to 256"),
])
def test_k8_wrapper_checks_the_rows_and_parameters(shape, w, b, match):
    weight = None if w is None else torch.ones(w)
    with pytest.raises(ValueError, match=match):
        k8._check(torch.zeros(shape), weight, torch.zeros(b))


def test_k8_wrapper_checks_the_parameters_dtype():
    with pytest.raises(ValueError, match="K8 takes all three float32"):
        k8._check(torch.zeros((4, 6)), torch.ones(6, dtype=torch.float64), torch.zeros(6))


@pytest.mark.parametrize("call", ["fwd", "bwd"])
def test_k8_launches_no_cpu_tensor(call):
    """The launch refuses a tensor off the card before building anything."""
    z, w = torch.rand((3, 6)), torch.ones(6)
    before = launch_counters()
    with pytest.raises(ValueError, match="CUDA tensors"):
        if call == "fwd":
            k8.layer_norm_fwd(z, w, torch.zeros(6), 1e-5)
        else:
            k8.layer_norm_bwd(torch.rand((3, 6)), z, w, 1e-5)
    assert launch_counters() == before


@pytest.mark.parametrize("shape", [(1, 4, 5, 6, 6), (2, 3, 12), (7, 48)])
def test_layer_norm_plain_is_nn_layer_norm_bit_for_bit(shape):
    """K8's oracle: the forward and every gradient equal ``nn.LayerNorm``'s."""
    n = shape[-1]
    norm = nn.LayerNorm(n, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(_rand(n, 1, 0.1, 1.0))
        norm.bias.copy_(_rand(n, 2, 0.1))
    x = _rand(shape, 3, 2.0, 0.5).requires_grad_()
    g = _rand(shape, 4)
    want = norm(x)
    ref = torch.autograd.grad(want, (x, norm.weight, norm.bias), g)
    got = k8.layer_norm_plain(x, norm.weight, norm.bias, norm.eps)
    grads = torch.autograd.grad(got, (x, norm.weight, norm.bias), g)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))


@pytest.mark.parametrize("kernels", [True, False])
def test_float32_layer_norm_on_the_cpu_is_torchs(kernels):
    """`ops.blocks.layer_norm` of a float32 activation on the CPU: the plain
    version, the same bits as ``nn.LayerNorm``, whatever the kernel switch;
    no kernel launches."""
    layer = ProjectionLayer(8, 6)
    layer.norm.kernels = kernels
    with torch.no_grad():
        layer.norm.weight.copy_(_rand(6, 5, 0.1, 1.0))
    x = _rand((1, 3, 4, 5, 6), 6).requires_grad_()
    before = launch_counters()
    got = blocks.layer_norm(layer.norm, x)
    dx = torch.autograd.grad(got.sum(), x)[0]
    assert launch_counters() == before
    assert torch.equal(got, layer.norm(x))
    assert torch.equal(dx, torch.autograd.grad(layer.norm(x).sum(), x)[0])


def test_bf16_layer_norm_keeps_the_jax_layers_separate_ops():
    """A bfloat16 activation under float32 parameters (ModeT's bf16 path):
    the variance, the mean, the normalisation and the affine as separate
    bfloat16 ops, as the JAX layer rounds them, and no K8."""
    norm = nn.LayerNorm(6, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(_rand(6, 7, 0.1, 1.0))
        norm.bias.copy_(_rand(6, 8, 0.1))
    x = _rand((1, 3, 4, 5, 6), 9, 2.0, 0.5).to(torch.bfloat16)
    before = launch_counters()
    got = blocks.layer_norm(norm, x)
    var, mean = torch.var_mean(x, dim=-1, correction=0, keepdim=True)
    want = ((x - mean) * torch.rsqrt(var + norm.eps)) * norm.weight.to(x.dtype) \
        + norm.bias.to(x.dtype)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert launch_counters() == before
