"""Port `losses/extended.py` vs the JAX package: every function's value and
every gradient against ``jax.value_and_grad`` (the MIND-SSC descriptor
itself against ``jax.vjp`` with a random cotangent), on the same numpy
inputs at 15x14x17 (no axis a multiple of local MI's patch size 5).

The inputs hold ties where the port must take JAX's derivative: images
min-max normalised to exact 0s (a zero background slab) and an exact 1,
with values beyond [0, 1] that the MI losses clip (``jnp.clip`` splits the
gradient at a bound, ``torch.clamp`` does not); a block that is a dyadic
linear ramp, on which MIND's 12 channels tie exactly in pairs
(``jnp.min`` splits the gradient among tied channels, ``torch.min(dim)``
does not); flows with constant slabs, so that forward and central
differences are exactly 0 (``jnp.abs``'s derivative there is +1,
``torch.abs``'s is 0).

Tolerances (float32 on both sides): values 1e-5 relative, gradients 1e-4
of their largest magnitude (measured at most 6.8e-6 and 2.1e-6). MIND's
descriptor 1e-5 relative (its 5^3 box mean is summed one axis at a time
where JAX adds 125 shifted slices; measured 4.5e-6), `mind_loss`'s value
1e-4 (the difference of two descriptors cancels; measured 1.6e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smilecode_tpu.losses import extended as jax_ext
from smilecode_tpu_torch.losses import extended as ext

torch.set_num_threads(1)

SHAPE = (15, 14, 17)
VALUE_RTOL, GRAD_TOL = 1e-5, 1e-4


def smooth(shape, c, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((1, *shape, c))
    for axis in (1, 2, 3):
        a = np.cumsum(a, axis=axis)
    return a


def image(seed, beyond=False):
    """Min-max normalised (exact 0 and 1) smooth volume with a zero
    background slab and a dyadic ramp block; ``beyond`` adds values the MI
    losses clip."""
    a = smooth(SHAPE, 1, seed)
    a = (a - a.min()) / (a.max() - a.min())
    a[:, :3] = 0.0
    d, h, w = np.meshgrid(*(np.arange(n) for n in (10, 10, 11)), indexing="ij")
    a[0, 4:14, 2:12, 3:14, 0] = (d + 2 * h + 4 * w) / 128.0
    if beyond:
        a[0, 1, 1, :4, 0] = (-0.25, 1.5, 0.0, 1.0)
    return a.astype(np.float32)


def flow(seed, c=3):
    """Smooth flow with constant slabs (zero and not)."""
    f = smooth(SHAPE, c, seed)
    f = 2.0 * f / np.abs(f).max()
    f[:, :2] = 0.0
    f[:, 6:9, 3:10] = 0.5
    f[:, :, :, 12:] = f[:, :, :, 12:13]
    return f.astype(np.float32)


def torch_value_and_grads(fn, arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    val = fn(*ts)
    val.backward()
    return float(val.detach()), [t.grad.numpy() for t in ts]


def assert_matches_jax(port_fn, jax_fn, arrays, rtol=VALUE_RTOL, grad_tol=GRAD_TOL):
    val, grads = torch_value_and_grads(port_fn, arrays)
    argnums = tuple(range(len(arrays)))
    jval, jgrads = jax.jit(jax.value_and_grad(jax_fn, argnums=argnums))(
        *map(jnp.asarray, arrays))
    np.testing.assert_allclose(val, float(jval), rtol=rtol)
    for g, jg in zip(grads, jgrads):
        jg = np.asarray(jg)
        assert np.abs(jg).max() > 0
        np.testing.assert_allclose(g, jg, rtol=0, atol=grad_tol * np.abs(jg).max())
    return val


@pytest.mark.parametrize("dims,win", [(2, 11), (3, 11), (3, 7)])
def test_ssim_matches_jax(dims, win):
    """SSIM's 2D form on (B, H, W, C) slices and its 3D form, and 1 - SSIM;
    two channels in 2D (the window is depthwise)."""
    a, b = image(1), image(2)
    if dims == 2:
        a = np.concatenate([a[:, 7], a[:, 9]], axis=-1)  # (1, H, W, 2)
        b = np.concatenate([b[:, 7], b[:, 9]], axis=-1)
        val = assert_matches_jax(lambda x, y: ext.ssim2d(x, y, win),
                                 lambda x, y: jax_ext.ssim2d(x, y, win), [a, b])
    else:
        val = assert_matches_jax(lambda x, y: ext.ssim3d(x, y, win),
                                 lambda x, y: jax_ext.ssim3d(x, y, win), [a, b])
        loss = assert_matches_jax(lambda x, y: ext.ssim3d_loss(x, y, win),
                                  lambda x, y: jax_ext.ssim3d_loss(x, y, win), [a, b])
        np.testing.assert_allclose(loss, 1.0 - val, rtol=1e-6)
    assert 0.0 < val < 1.0


@pytest.mark.parametrize("penalty,loss_mult", [("l1", None), ("l2", None), ("l1", 3.0)])
def test_grad2d_matches_jax(penalty, loss_mult):
    f = flow(3, c=2)[:, 5]  # (1, H, W, 2), constant slabs along W and a block
    assert_matches_jax(lambda x: ext.grad2d(x, penalty, loss_mult),
                       lambda x: jax_ext.grad2d(x, penalty, loss_mult), [f])


def test_grad3d_itv_matches_jax():
    assert_matches_jax(ext.grad3d_itv, jax_ext.grad3d_itv, [flow(4)])


@pytest.mark.parametrize("energy", ["gradient-l1", "gradient-l2", "bending"])
def test_displacement_regularizer_matches_jax(energy):
    assert_matches_jax(lambda x: ext.displacement_regularizer(x, energy),
                       lambda x: jax_ext.displacement_regularizer(x, energy), [flow(5)])


def test_displacement_regularizer_rejects_an_unknown_energy():
    f = torch.from_numpy(flow(5))
    with pytest.raises(ValueError, match="Not recognised"):
        ext.displacement_regularizer(f, "gradient-l3")
    with pytest.raises(ValueError, match="Not recognised"):
        jax_ext.displacement_regularizer(jnp.asarray(flow(5)), "gradient-l3")


@pytest.mark.parametrize("radius,dilation", [(2, 2), (1, 3)])
def test_mind_ssc_descriptor_matches_jax(radius, dilation):
    """The descriptor and its vector-Jacobian product with a random
    cotangent, on an image whose ramp block ties MIND's channels in pairs."""
    img = image(6)
    cot = np.random.default_rng(7).standard_normal((1, *SHAPE, 12)).astype(np.float32)
    x = torch.from_numpy(img).requires_grad_()
    desc = ext.mind_ssc(x, radius, dilation)
    (g,) = torch.autograd.grad(desc, x, torch.from_numpy(cot))
    jdesc, vjp = jax.vjp(jax.jit(lambda v: jax_ext.mind_ssc(v, radius, dilation)),
                         jnp.asarray(img))
    (jg,) = vjp(jnp.asarray(cot))
    jdesc, jg = np.asarray(jdesc), np.asarray(jg)
    assert desc.shape == jdesc.shape == (1, *SHAPE, 12)
    np.testing.assert_allclose(desc.detach().numpy(), jdesc, rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=GRAD_TOL * np.abs(jg).max())


def test_mind_loss_matches_jax():
    assert_matches_jax(ext.mind_loss, jax_ext.mind_loss, [image(8), image(9)], rtol=1e-4)


@pytest.mark.parametrize("local,kw", [
    (False, {}), (True, {}),
    (False, {"num_bin": 16, "sigma_ratio": 0.5, "minval": 0.25, "maxval": 0.75}),
    (True, {"patch_size": 4, "num_bin": 24, "maxval": 0.5})])
def test_mutual_information_matches_jax(local, kw):
    """Global MI and local MI (patch 5 or 4: every axis padded, or two of
    them), on inputs with exact 0s and 1s and values beyond [0, 1]; narrower
    ranges clip more of them."""
    port = ext.local_mutual_information if local else ext.mutual_information
    ref = jax_ext.local_mutual_information if local else jax_ext.mutual_information
    val = assert_matches_jax(lambda x, y: port(x, y, **kw), lambda x, y: ref(x, y, **kw),
                             [image(10, beyond=True), image(11, beyond=True)])
    assert val < 0
