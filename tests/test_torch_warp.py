"""Port warp (plain path) vs the JAX package: the v4 Pallas warp kernel in
interpret mode on smooth flows within its window budget, and the naive
gather oracle `_warp_simple` on every flow, including a wild one the TPU
kernels' budgets could not take. Kernel F's entries: the port's
``warp(kernels=True)`` vs JAX ``warp(impl="pallas")`` (F in interpret
mode) on smooth flows within F's window, and vs JAX ``impl="guarded"`` on
smooth and wild flows, with a shape mismatch; the kernel switch's routes.
The written-out adjoint (`warp3d_trilinear_bwd_plain`, K5's oracle) vs the
VJPs of the JAX oracle and of JAX `ops.warp`, the v3 d_coords kernel in
interpret mode, and torch autograd.

Tolerance 1e-5 absolute on unit-scale sources: 8 float32 products summed in
the same corner order on both sides. Adjoints 2e-5 times their largest
magnitude (the scatter and the per-corner reductions sum in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smilecode_tpu.kernels.warp3d import warp_window_violations
from smilecode_tpu.kernels.warp3d_v3 import warp3d_planes_v3_dflow
from smilecode_tpu.kernels.warp3d_v4 import warp3d_planes_v4
from smilecode_tpu.ops.warp import _warp_simple as jax_warp_simple
from smilecode_tpu.ops.warp import base_grid as jax_base_grid
from smilecode_tpu.ops.warp import warp as jax_warp
from smilecode_tpu_torch.kernels.warp3d import (
    warp3d_trilinear,
    warp3d_trilinear_bwd,
    warp3d_trilinear_bwd_plain,
    warp3d_trilinear_plain,
)
from smilecode_tpu_torch.kernels import warp3d as port_warp3d
from smilecode_tpu_torch.ops.warp import _warp_simple, base_grid, warp

torch.set_num_threads(1)
TOL = 1e-5


def smooth_flow(shape, amp, freq):
    g = np.stack(np.meshgrid(*[np.linspace(0, freq * np.pi, s) for s in shape], indexing="ij"), -1)
    fl = amp * np.stack(
        [np.sin(g[..., 0] + i) * np.cos(g[..., 1] - i) * np.sin(g[..., 2] + 2 * i) for i in range(3)],
        -1,
    )
    return fl[None].astype(np.float32)


def wild_flow(shape, amp, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-amp, amp, (1, *shape, 3)).astype(np.float32)


def source(shape, c, seed):
    return np.random.default_rng(seed).standard_normal((1, *shape, c)).astype(np.float32)


def jax_v4(src, fl):
    b, d, h, w, c = src.shape
    coords = jax_base_grid(d, h, w, jnp.float32)[None] + jnp.asarray(fl)
    planes = jnp.asarray(src).transpose(0, 4, 1, 2, 3).reshape(b * c, d, h, w)
    out = warp3d_planes_v4(planes, coords[..., 0], coords[..., 1], coords[..., 2], c,
                           interpret=True)
    return np.asarray(out.reshape(b, c, d, h, w).transpose(0, 2, 3, 4, 1))


@pytest.mark.parametrize(
    "shape,c,amp,freq",
    [((8, 16, 16), 1, 0.8, 1), ((10, 12, 10), 3, 2.0, 2), ((8, 12, 8), 8, 1.5, 2)],
)
def test_plain_matches_jax_v4_interpret(shape, c, amp, freq):
    src, fl = source(shape, c, 1), smooth_flow(shape, amp, freq)
    out = warp3d_trilinear_plain(torch.from_numpy(src), torch.from_numpy(fl))
    np.testing.assert_allclose(out.numpy(), jax_v4(src, fl), atol=TOL, rtol=0)


@pytest.mark.parametrize(
    "shape,c,kind,amp",
    [((8, 10, 9), 1, "smooth", 5.0), ((8, 10, 9), 3, "wild", 20.0), ((6, 8, 7), 16, "wild", 20.0),
     ((7, 9, 8), 2, "wild", 3.0)],
)
def test_plain_matches_jax_warp_simple(shape, c, kind, amp):
    src = source(shape, c, 2)
    fl = smooth_flow(shape, amp, 2) if kind == "smooth" else wild_flow(shape, amp, 3)
    ref = np.asarray(jax_warp_simple(jnp.asarray(src), jnp.asarray(fl)))
    out = _warp_simple(torch.from_numpy(src), torch.from_numpy(fl))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)


def test_nearest_matches_jax_including_half_voxels():
    shape = (6, 7, 5)
    rng = np.random.default_rng(4)
    seg = rng.integers(0, 55, (1, *shape, 1)).astype(np.float32)
    fl = wild_flow(shape, 3.0, 5)
    fl[0, ::2, :, :, 1] = 0.5  # exact halves: round half to even
    fl[0, 1::2, :, :, 2] = -1.5
    ref = np.asarray(jax_warp_simple(jnp.asarray(seg), jnp.asarray(fl), "nearest"))
    out = warp(torch.from_numpy(seg), torch.from_numpy(fl), mode="nearest")
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_shape_mismatch_rescale_matches_jax(mode):
    src = source((9, 11, 7), 2, 6)
    fl = smooth_flow((5, 6, 4), 1.0, 1)
    ref = np.asarray(jax_warp_simple(jnp.asarray(src), jnp.asarray(fl), mode))
    out = warp(torch.from_numpy(src), torch.from_numpy(fl), mode=mode)
    assert out.shape == (1, 5, 6, 4, 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)


def test_wrapper_on_cpu_runs_plain_without_launch():
    src, fl = torch.from_numpy(source((5, 6, 7), 3, 7)), torch.from_numpy(wild_flow((5, 6, 7), 4, 8))
    before = warp3d_trilinear.launches, warp3d_trilinear.launches_vector
    out = warp(src, fl)
    assert (warp3d_trilinear.launches, warp3d_trilinear.launches_vector) == before
    torch.testing.assert_close(out, _warp_simple(src, fl), rtol=0, atol=0)


@pytest.mark.parametrize("c,itemsize,ptrs,lanes", [
    # f32 rows of 1..32 whole 16-byte vectors: C * 4 / 16 lanes per voxel
    (4, 4, (0, 4096), 1), (8, 4, (0, 4096), 2), (16, 4, (256,), 4), (32, 4, (16,), 8),
    (64, 4, (0, 16), 16), (128, 4, (0,), 32),
    (256, 4, (0,), 32),  # 64 vectors: 32 lanes take two each
    (12, 4, (0,), 1),  # 3 vectors: one lane takes all three
    # bf16
    (8, 2, (0, 64), 1), (16, 2, (0,), 2), (32, 2, (0,), 4), (64, 2, (0, 16, 32), 8),
    # the scalar path: rows that are not whole vectors, misaligned pointers
    (1, 4, (0,), 0), (3, 4, (0,), 0), (5, 4, (0,), 0), (4, 2, (0,), 0), (3, 2, (0,), 0),
    (8, 4, (0, 4), 0), (64, 4, (8, 0), 0), (16, 2, (0, 0, 2), 0),
])
def test_lanes_per_voxel_picks_the_vector_path(c, itemsize, ptrs, lanes):
    """K2's and K5's lanes per output voxel (0: the scalar path) from C, the
    element size and the data pointers, as the wrappers pass it."""
    assert port_warp3d._lanes_per_voxel(c, itemsize, *ptrs) == lanes


def test_wrapper_never_takes_the_plain_path_off_the_cpu():
    src, fl = torch.zeros((1, 4, 4, 4, 2)), torch.zeros((1, 4, 4, 4, 3))
    before = warp3d_trilinear.launches
    with pytest.raises(ValueError, match="CUDA device"):
        warp(src.to("meta"), fl.to("meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        warp3d_trilinear(src, fl.to("meta"))
    assert warp3d_trilinear.launches == before


def test_out_of_volume_and_nan_flows_give_zeros():
    src = torch.ones((1, 4, 4, 4, 2))
    far = torch.full((1, 4, 4, 4, 3), 100.0)
    assert torch.count_nonzero(warp(src, far)) == 0
    nan = torch.full((1, 4, 4, 4, 3), float("nan"))
    assert torch.count_nonzero(warp(src, nan)) == 0
    assert torch.count_nonzero(warp(src, nan, mode="nearest")) == 0


def test_identity_flow_and_base_grid():
    src = torch.from_numpy(source((4, 5, 6), 2, 9))
    torch.testing.assert_close(warp(src, torch.zeros((1, 4, 5, 6, 3))), src, rtol=0, atol=0)
    np.testing.assert_array_equal(base_grid(3, 4, 5).numpy(), np.asarray(jax_base_grid(3, 4, 5)))


BWD_TOL = 2e-5  # times the largest |gradient|: 8-corner float32 sums, another order


def jax_warp_vjp(warp_fn, src, fl, g):
    """(d_src, d_flow) of a JAX warp for the output cotangent g (jitted vjp)."""
    return jax.jit(lambda s, f, gg: jax.vjp(warp_fn, s, f)[1](gg))(
        jnp.asarray(src), jnp.asarray(fl), jnp.asarray(g))


def assert_close_scaled(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=BWD_TOL * max(np.abs(want).max(), 1e-3), err_msg=what)


@pytest.mark.parametrize("src_shape,flow_shape,c,kind,amp", [
    ((8, 10, 9), (8, 10, 9), 1, "smooth", 5.0),
    ((7, 9, 8), (7, 9, 8), 3, "wild", 20.0),
    ((6, 8, 7), (6, 8, 7), 16, "wild", 3.0),
    ((9, 11, 7), (5, 6, 4), 2, "smooth", 1.0),  # shape mismatch: rescaled coordinates
])
def test_bwd_plain_matches_jax_vjps(src_shape, flow_shape, c, kind, amp):
    """d_flow and d_src vs the VJP of the JAX oracle `_warp_simple`; d_flow
    also vs the VJP of JAX `ops.warp` (the packed warp the JAX ModeT trains
    through)."""
    src = source(src_shape, c, 20)
    fl = smooth_flow(flow_shape, amp, 2) if kind == "smooth" else wild_flow(flow_shape, amp, 21)
    g = source(flow_shape, c, 22)
    d_src, d_flow = warp3d_trilinear_bwd_plain(torch.from_numpy(src), torch.from_numpy(fl),
                                               torch.from_numpy(g), want_dsrc=True)
    j_src, j_flow = jax_warp_vjp(jax_warp_simple, src, fl, g)
    assert_close_scaled(d_src, j_src, "d_src vs oracle")
    assert_close_scaled(d_flow, j_flow, "d_flow vs oracle")
    _, p_flow = jax_warp_vjp(jax_warp, src, fl, g)
    assert_close_scaled(d_flow, p_flow, "d_flow vs ops.warp")


@pytest.mark.parametrize("shape,c", [((10, 12, 10), 3), ((6, 9, 7), 1)])
def test_bwd_plain_d_flow_matches_jax_v3_dflow_interpret(shape, c):
    """d_flow vs H, `warp3d_planes_v3_dflow` in interpret mode, on a smooth
    flow within its window budget."""
    src, fl, g = source(shape, c, 23), smooth_flow(shape, 1.5, 2), source(shape, c, 24)
    coords = np.asarray(jax_base_grid(*shape, jnp.float32))[None] + fl
    planes = jnp.asarray(src).transpose(0, 4, 1, 2, 3).reshape(c, *shape)
    gp = jnp.asarray(g).transpose(0, 4, 1, 2, 3).reshape(c, *shape)
    want = warp3d_planes_v3_dflow(planes, *(jnp.asarray(coords[..., a]) for a in range(3)), gp, c,
                                  interpret=True)
    d_src, d_flow = warp3d_trilinear_bwd_plain(torch.from_numpy(src), torch.from_numpy(fl),
                                               torch.from_numpy(g), want_dsrc=False)
    assert d_src is None
    for a in range(3):
        assert_close_scaled(d_flow[..., a], want[a], f"d_flow axis {a}")


def test_bwd_plain_matches_torch_autograd():
    src = torch.from_numpy(source((7, 6, 8), 4, 25)).requires_grad_()
    fl = torch.from_numpy(wild_flow((5, 7, 6), 4.0, 26)).requires_grad_()  # rescaled too
    g = torch.from_numpy(source((5, 7, 6), 4, 27))
    want = torch.autograd.grad(warp3d_trilinear_plain(src, fl), (src, fl), g)
    got = warp3d_trilinear_bwd_plain(src.detach(), fl.detach(), g)
    for a, b, what in zip(got, want, ("d_src", "d_flow")):
        assert_close_scaled(a, b, what)


def test_bwd_wrapper_on_cpu_runs_plain_without_launch():
    src, fl = torch.from_numpy(source((5, 6, 7), 3, 28)), torch.from_numpy(wild_flow((5, 6, 7), 4, 29))
    g = torch.from_numpy(source((5, 6, 7), 3, 30))
    before = (warp3d_trilinear_bwd.launches, warp3d_trilinear_bwd.scatters)
    for want_dsrc in (True, False):
        got = warp3d_trilinear_bwd(src, fl, g, want_dsrc)
        ref = warp3d_trilinear_bwd_plain(src, fl, g, want_dsrc)
        assert (got[0] is None) == (not want_dsrc)
        for a, b in zip(got, ref):
            if b is not None:
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (warp3d_trilinear_bwd.launches, warp3d_trilinear_bwd.scatters) == before
    with pytest.raises(ValueError, match="CUDA device"):
        warp3d_trilinear_bwd(src.to("meta"), fl.to("meta"), g.to("meta"))


def test_bad_shapes_raise():
    with pytest.raises(ValueError, match="NDHWC"):
        warp(torch.zeros((1, 4, 4, 4)), torch.zeros((1, 4, 4, 4, 3)))
    with pytest.raises(ValueError, match="batch"):
        warp(torch.zeros((2, 4, 4, 4, 1)), torch.zeros((1, 4, 4, 4, 3)))


@pytest.mark.parametrize("src_shape,flow_shape,c,amp,freq", [
    ((16, 16, 16), (16, 16, 16), 1, 0.8, 1),
    ((12, 16, 12), (12, 16, 12), 3, 2.0, 2),
    ((10, 12, 10), (10, 12, 10), 16, 1.5, 2),
    ((13, 17, 11), (9, 12, 8), 2, 1.0, 1),  # shape mismatch: rescaled coordinates
])
def test_pallas_matches_jax_f_interpret(src_shape, flow_shape, c, amp, freq):
    """F (`smilecode_tpu/kernels/warp3d.py:_warp_kernel`) in interpret mode
    through JAX ``warp(impl="pallas")``, on smooth flows within its window."""
    src, fl = source(src_shape, c, 31), smooth_flow(flow_shape, amp, freq)
    assert float(warp_window_violations(jnp.asarray(fl), src_shape)) == 0.0
    ref = np.asarray(jax_warp(jnp.asarray(src), jnp.asarray(fl), impl="pallas"))
    out = warp(torch.from_numpy(src), torch.from_numpy(fl), kernels=True)
    assert out.shape == (1, *flow_shape, c)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("src_shape,flow_shape,c,kind,amp", [
    ((12, 16, 12), (12, 16, 12), 3, "smooth", 2.0),
    ((12, 16, 12), (12, 16, 12), 1, "wild", 30.0),  # F would clamp: JAX takes its fallback
    ((10, 12, 10), (10, 12, 10), 8, "wild", 12.0),
    ((13, 17, 11), (9, 12, 8), 2, "smooth", 1.0),
])
def test_guarded_matches_jax_guarded(src_shape, flow_shape, c, kind, amp):
    src = source(src_shape, c, 32)
    fl = smooth_flow(flow_shape, amp, 2) if kind == "smooth" else wild_flow(flow_shape, amp, 33)
    viol = float(warp_window_violations(jnp.asarray(fl), src_shape))
    assert (viol > 0) == (kind == "wild")
    ref = np.asarray(jax_warp(jnp.asarray(src), jnp.asarray(fl), impl="guarded"))
    out = warp(torch.from_numpy(src), torch.from_numpy(fl), kernels=True)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_impl_names_map_to_the_kernel_wrapper_or_plain(monkeypatch, kernels, mode):
    """With the kernel switch on, a bilinear warp reaches the K2 wrapper (on
    the CPU: its plain version); off, and in nearest mode, it runs
    `_warp_simple`. Both give the same numbers on the CPU."""
    calls = []
    plain = port_warp3d.warp3d_trilinear_plain
    monkeypatch.setattr(port_warp3d, "warp3d_trilinear_plain",
                        lambda s, f, d0: calls.append(1) or plain(s, f, d0))
    src = torch.from_numpy(source((5, 6, 7), 2, 34))
    fl = torch.from_numpy(wild_flow((5, 6, 7), 3.0, 35))
    out = warp(src, fl, mode=mode, kernels=kernels)
    assert len(calls) == int(mode == "bilinear" and kernels)
    torch.testing.assert_close(out, _warp_simple(src, fl, mode), rtol=0, atol=0)


def nan_flow_case():
    """(1, 5, 6, 7) flow with C = 8: one voxel NaN in all three channels and
    one voxel NaN in channel 1 only; source and cotangent from seeds."""
    fl = wild_flow((5, 6, 7), 2.0, 36)
    fl[0, 1, 2, 3, :] = np.nan
    fl[0, 3, 4, 1, 1] = np.nan
    return source((5, 6, 7), 8, 37), fl, source((5, 6, 7), 8, 38)


@pytest.mark.parametrize("route", ["autograd", "bwd_plain"])
def test_nan_flow_gradients_match_jax_default_warp(route):
    """At a NaN flow the port's plain warp gives JAX's default `ops.warp`
    (the packed warp ModeT trains through) gradients: d_flow 0 in all three
    channels of both NaN voxels, which add nothing to d_src; the forward
    gives zeros there. Through torch autograd of the CPU route and through
    `warp3d_trilinear_bwd_plain` (K5's oracle)."""
    src, fl, g = nan_flow_case()
    j_src, j_flow = (np.asarray(a) for a in jax_warp_vjp(jax_warp, src, fl, g))
    if route == "autograd":
        s, f = (torch.from_numpy(a).requires_grad_() for a in (src, fl))
        out = warp3d_trilinear(s, f)
        assert out[0, 1, 2, 3].abs().max() == 0 and out[0, 3, 4, 1].abs().max() == 0
        d_src, d_flow = torch.autograd.grad(out, (s, f), torch.from_numpy(g))
    else:
        d_src, d_flow = warp3d_trilinear_bwd_plain(*(torch.from_numpy(a) for a in (src, fl, g)))
    assert np.isfinite(j_flow).all() and np.isfinite(j_src).all()
    assert not j_flow[0, 1, 2, 3].any() and not j_flow[0, 3, 4, 1].any()
    assert torch.isfinite(d_flow).all() and torch.isfinite(d_src).all()
    assert_close_scaled(d_flow, j_flow, "d_flow vs ops.warp")
    assert_close_scaled(d_src, j_src, "d_src vs ops.warp")


def test_jax_warp_simple_gives_nan_flow_gradients_at_nan_flows():
    """The JAX package's two warps differ at a NaN flow: `_warp_simple`
    gives NaN d_flow in channels (0, 1, 2) at the all-NaN voxel and (0, 2)
    at the channel-1 voxel, where its default `ops.warp` gives 0 (the test
    above)."""
    src, fl, g = nan_flow_case()
    _, j_flow = (np.asarray(a) for a in jax_warp_vjp(jax_warp_simple, src, fl, g))
    np.testing.assert_array_equal(np.isnan(j_flow[0, 1, 2, 3]), [True, True, True])
    np.testing.assert_array_equal(np.isnan(j_flow[0, 3, 4, 1]), [True, False, True])
    assert np.isnan(j_flow).sum() == 5
