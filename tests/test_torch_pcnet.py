"""Port PCNet vs the JAX package: `UpConvBlockP1` and `ChannelAttention`
alone, the forward at 16^3 (JAX's own test size), one training step
(loss and every gradient vs ``jax.value_and_grad``), and `train.main`
followed by both packages' `infer.main` on its checkpoint. Helpers and
tolerances: `test_torch_baselines.py`, `test_torch_baselines_train.py`."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from smilecode_tpu.models.pcnet import ChannelAttention as JaxChannelAttention
from smilecode_tpu.models.pcnet import UpConvBlockP1 as JaxUpConvBlockP1
from smilecode_tpu_torch.convert import params_from_state_dict
from smilecode_tpu_torch.models.pcnet import ChannelAttention, UpConvBlockP1
from test_torch_baselines import assert_forward_matches_jax, port_model
from test_torch_baselines_train import (
    assert_step_matches_jax,
    assert_trained_checkpoint_infers_as_jax,
)

torch.set_num_threads(1)


def test_upconv_block_p1_is_conv_transpose_without_crop_or_flip():
    """JAX's block is an lhs-dilated convolution with the flipped raw
    kernel (k, k, k, Cin, Cout), padding 2; the port's is
    ``nn.ConvTranspose3d(k4, s2, padding 1)`` with that kernel moved to
    (Cin, Cout, k, k, k) and not flipped. Odd, unequal input axes, Cin !=
    Cout and Cin == Cout; the output doubles each axis (no crop). The
    converter of a PCNet maps ``upconvN/kernel`` by the same transpose."""
    rng = np.random.default_rng(60)
    for cin, cout in ((6, 5), (4, 4)):
        x = rng.standard_normal((1, 3, 4, 5, cin)).astype(np.float32)
        kernel = rng.standard_normal((4, 4, 4, cin, cout)).astype(np.float32)
        bias = rng.standard_normal((cout,)).astype(np.float32)
        want = JaxUpConvBlockP1(cout).apply({"params": {"kernel": kernel, "bias": bias}},
                                            jnp.asarray(x))
        block = UpConvBlockP1(cin, cout)
        block.load_state_dict({"upconv.weight": torch.from_numpy(kernel.transpose(3, 4, 0, 1, 2)),
                               "upconv.bias": torch.from_numpy(bias)})
        with torch.no_grad():
            got = block(torch.from_numpy(x))
        assert got.shape == (1, 6, 8, 10, cout) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)

    model = port_model("pcnet")
    weight = model.state_dict()["upconv1.upconv.weight"].numpy()
    params = params_from_state_dict(model.state_dict(), model)["params"]
    assert weight.shape == (12 * 16, 2 * 16, 4, 4, 4) and "upconv" not in params["upconv1"]
    np.testing.assert_array_equal(params["upconv1"]["kernel"], weight.transpose(2, 3, 4, 0, 1))


def test_channel_attention_matches_jax_with_tied_maxima():
    """Mean and max pooling through the shared bias-free MLP; the reference
    keys ``fc.0.weight`` and ``fc.2.weight`` hold JAX's ``fc1`` and ``fc2``
    transposed. The input has tied maxima in every channel: ``torch.amax``
    splits the gradient among them as ``jnp.max`` does."""
    rng = np.random.default_rng(61)
    c = 24
    x = rng.standard_normal((2, 3, 4, 5, c)).astype(np.float32)
    x[:, 0, 0, 0] = x[:, 2, 3, 4] = np.abs(x).max() + 1.0  # two maxima per channel
    fc1 = rng.uniform(-0.5, 0.5, (c, c // 8)).astype(np.float32)
    fc2 = rng.uniform(-0.5, 0.5, (c // 8, c)).astype(np.float32)
    g = rng.standard_normal((2, 1, 1, 1, c)).astype(np.float32)
    jmod = JaxChannelAttention()
    params = {"params": {"fc1": jnp.asarray(fc1), "fc2": jnp.asarray(fc2)}}
    want, vjp = jax.vjp(lambda p, v: jmod.apply(p, v), params, jnp.asarray(x))
    d_params, d_x = vjp(jnp.asarray(g))

    port = ChannelAttention(c)
    port.load_state_dict({"fc.0.weight": torch.from_numpy(fc1.T.copy()),
                          "fc.2.weight": torch.from_numpy(fc2.T.copy())})
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(d_x), atol=1e-6, rtol=1e-5)
    tied = xt.grad.numpy()[:, 0, 0, 0]
    np.testing.assert_allclose(tied, xt.grad.numpy()[:, 2, 3, 4], rtol=0, atol=0)
    np.testing.assert_allclose(port.fc[0].weight.grad.numpy().T,
                               np.asarray(d_params["params"]["fc1"]), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(port.fc[2].weight.grad.numpy().T,
                               np.asarray(d_params["params"]["fc2"]), atol=1e-6, rtol=1e-5)


def test_pcnet_forward_matches_jax_at_16():
    outs = assert_forward_matches_jax("pcnet", 62)
    assert len(outs) == 2


def test_pcnet_step_matches_jax_value_and_grad():
    vals = assert_step_matches_jax("pcnet", 63)
    assert len(vals) == 2


def test_train_main_pcnet_then_infer_main_matches_jax(tmp_path):
    assert_trained_checkpoint_infers_as_jax(tmp_path, "pcnet", 64)
