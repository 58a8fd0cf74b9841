"""Port attention (plain path) vs the JAX package: the fused Pallas kernel in
interpret mode and the XLA oracle, on the same numpy inputs; and the
written-out backward (`modet_attention_bwd_plain`, the backward kernels'
oracle) vs torch autograd, the Pallas B1/B2 backward and the oracle's VJP.

Tolerance 1e-5 absolute on outputs (they lie in [-1, 1]): float32 softmax
over 27 logits, summed in another order by each implementation. Gradients
2e-5 times their largest magnitude (same reason, one more 27-term sum).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smilecode_tpu.kernels.modet_attn import modet_attention_pallas
from smilecode_tpu.models.im2grid import cotr as jax_cotr
from smilecode_tpu.ops.attention import _neighborhood_attention_xla
from smilecode_tpu.ops.attention import neighborhood_attention_3d as jax_neighborhood_attention_3d
from smilecode_tpu.ops.attention import offset_grid as jax_offset_grid
from smilecode_tpu_torch.kernels.modet_attn import (
    modet_attention,
    modet_attention_bwd,
    modet_attention_bwd_dk,
    modet_attention_bwd_dq,
    modet_attention_bwd_plain,
    modet_attention_plain,
)
from smilecode_tpu_torch.models.im2grid import cotr
from smilecode_tpu_torch.ops.attention import (
    KERNEL_SIZES,
    _neighborhood_attention_plain,
    neighborhood_attention_3d,
    offset_grid,
)

torch.set_num_threads(1)
TOL = 1e-5


def make_inputs(shape, heads, hd=6, with_rpb=True, seed=0, ks=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, *shape, heads, hd)).astype(np.float32)
    k = rng.standard_normal((1, *shape, heads, hd)).astype(np.float32)
    rpb = (rng.standard_normal((heads, ks, ks, ks)) * 0.5).astype(np.float32) if with_rpb else None
    return q, k, rpb


def to_torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def to_jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


CASES = [
    ((4, 6, 5), 1, 1.0, True),
    ((4, 6, 5), 2, 1.0, True),
    ((4, 6, 5), 2, 0.408, False),
    ((3, 5, 4), 1, 0.408, True),
]


@pytest.mark.parametrize("shape,heads,scale,with_rpb", CASES)
def test_plain_matches_jax_pallas_interpret(shape, heads, scale, with_rpb):
    q, k, rpb = make_inputs(shape, heads, with_rpb=with_rpb, seed=1)
    ref = modet_attention_pallas(*to_jax(q, k, rpb), scale, True)
    out = modet_attention_plain(*to_torch(q, k, rpb), scale)
    assert out.shape == (1, *shape, heads * 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("shape,heads,scale,with_rpb", CASES)
def test_plain_matches_jax_xla(shape, heads, scale, with_rpb):
    q, k, rpb = make_inputs(shape, heads, with_rpb=with_rpb, seed=2)
    ref = _neighborhood_attention_xla(*to_jax(q, k, rpb), scale)
    out = _neighborhood_attention_plain(*to_torch(q, k, rpb), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", [(4, 6, 5), (2, 3, 2), (5, 3, 4)])
def test_cotr_matches_jax_pallas_interpret(shape):
    """Im2grid's `cotr` (one head, head_dim 6, scale 1, no rpb: the case of
    K1 it runs) vs JAX ``neighborhood_attention_3d(..., None,
    impl="pallas")``, kernel A in interpret mode, and vs JAX `cotr`."""
    rng = np.random.default_rng(15)
    q, k = (rng.standard_normal((1, *shape, 6)).astype(np.float32) * 2 for _ in range(2))
    ref = jax_neighborhood_attention_3d(*to_jax(q[..., None, :], k[..., None, :]), None,
                                        scale=1.0, impl="pallas")
    out = cotr(*to_torch(q, k))
    assert out.shape == (1, *shape, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_cotr(*to_jax(q, k))), atol=TOL, rtol=0)
    torch.testing.assert_close(cotr(*to_torch(q, k), kernels=False), out, rtol=0, atol=0)


def test_plain_kernel_size_5_matches_jax_xla():
    q, k, rpb = make_inputs((5, 6, 5), 2, with_rpb=True, seed=3, ks=5)
    ref = _neighborhood_attention_xla(*to_jax(q, k, rpb), 1.0, kernel_size=5)
    out = neighborhood_attention_3d(*to_torch(q, k, rpb), 1.0, kernel_size=5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_offset_grid_matches_jax():
    for ks in KERNEL_SIZES:
        np.testing.assert_array_equal(offset_grid(ks), jax_offset_grid(ks))
    # token order t = (od*3 + oh)*3 + ow, offset (od-1, oh-1, ow-1)
    np.testing.assert_array_equal(offset_grid(3)[5], [-1, 0, 1])


def test_wrapper_on_cpu_runs_plain_without_launch():
    q, k, rpb = to_torch(*make_inputs((4, 5, 4), 2, seed=4))
    before = modet_attention.launches
    out = modet_attention(q, k, rpb, 1.0)
    assert modet_attention.launches == before
    torch.testing.assert_close(out, modet_attention_plain(q, k, rpb, 1.0), rtol=0, atol=0)
    via_dispatch = neighborhood_attention_3d(q, k, rpb, 1.0, kernels=True)
    torch.testing.assert_close(via_dispatch, out, rtol=0, atol=0)


def test_border_neighbours_stay_in_softmax():
    """q = k = 0: every logit is rpb. A large bias on token (+1,+1,+1) pulls
    every voxel toward that offset, corners included: out-of-volume
    neighbours are zero-padded, not masked."""
    shape, heads = (3, 3, 3), 1
    q = torch.zeros((1, *shape, heads, 6))
    rpb = torch.zeros((heads, 3, 3, 3))
    rpb[0, 2, 2, 2] = 50.0
    out = modet_attention(q, q.clone(), rpb, 1.0)
    torch.testing.assert_close(out, torch.ones_like(out), rtol=0, atol=TOL)


def test_dispatch_rejects_bad_arguments():
    q, k, rpb = to_torch(*make_inputs((3, 3, 3), 1, seed=5))
    with pytest.raises(ValueError, match="whitelist"):
        neighborhood_attention_3d(q, k, rpb, kernel_size=4)
    with pytest.raises(ValueError, match="equal"):
        modet_attention(q, k[..., :3], rpb)
    with pytest.raises(ValueError, match="rpb"):
        modet_attention(q, k, rpb[:, :2])


BWD_TOL = 2e-5  # times the largest |gradient|: 27-term float32 sums in another order


def assert_grads_close(got, want):
    for name, a, b in zip(("dq", "dk", "drpb"), got, want):
        if b is None:
            assert a is None, name
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=BWD_TOL * max(np.abs(b).max(), 1e-3),
                                   err_msg=name)


def jit_vjp(fn, *args):
    """Cotangents of ``fn``'s inputs for the output cotangent ``args[-1]``."""
    return jax.jit(lambda *a: jax.vjp(fn, *a[:-1])[1](a[-1]))(*args[:-1], jnp.asarray(args[-1]))


def cotangent(shape, heads, seed):
    return np.random.default_rng(seed).standard_normal((1, *shape, heads * 3)).astype(np.float32)


@pytest.mark.parametrize("shape,heads,scale,with_rpb", [
    ((4, 6, 5), 1, 1.0, True),
    ((3, 5, 4), 2, 0.5, False),
    ((2, 3, 2), 2, 0.5, True),  # every voxel on the border
    ((5, 4, 6), 3, 0.408, True),
])
def test_bwd_plain_matches_torch_autograd(shape, heads, scale, with_rpb):
    q, k, rpb = to_torch(*make_inputs(shape, heads, with_rpb=with_rpb, seed=7))
    g = torch.from_numpy(cotangent(shape, heads, 8))
    leaves = [t.clone().requires_grad_() for t in (q, k) + ((rpb,) if with_rpb else ())]
    out = modet_attention_plain(leaves[0], leaves[1], leaves[2] if with_rpb else None, scale)
    want = torch.autograd.grad(out, leaves, g)
    got = modet_attention_bwd_plain(q, k, rpb, scale, g)
    assert_grads_close(got, list(want) + ([] if with_rpb else [None]))


def test_bwd_plain_matches_jax_pallas_b1_b2_interpret():
    """B1/B2 of the JAX package in interpret mode, one tiny single-block shape."""
    shape, heads, scale = (3, 4, 5), 1, 1.0
    q, k, rpb = make_inputs(shape, heads, seed=9)
    g = cotangent(shape, heads, 10)
    want = jit_vjp(lambda a, b, c: modet_attention_pallas(a, b, c, scale, True),
                   *to_jax(q, k, rpb), g)
    got = modet_attention_bwd_plain(*to_torch(q, k, rpb), scale, torch.from_numpy(g))
    assert_grads_close(got, want)


@pytest.mark.parametrize("shape,heads,scale,with_rpb", [
    ((2, 3, 2), 2, 0.5, False),
    ((3, 2, 4), 2, 0.5, True),
    ((1, 4, 3), 1, 1.0, True),
])
def test_bwd_plain_matches_jax_xla_vjp_at_borders(shape, heads, scale, with_rpb):
    q, k, rpb = make_inputs(shape, heads, with_rpb=with_rpb, seed=11)
    g = cotangent(shape, heads, 12)
    if with_rpb:
        want = jit_vjp(lambda a, b, c: _neighborhood_attention_xla(a, b, c, scale),
                       *to_jax(q, k, rpb), g)
    else:
        want = (*jit_vjp(lambda a, b: _neighborhood_attention_xla(a, b, None, scale),
                         *to_jax(q, k), g), None)
    got = modet_attention_bwd_plain(*to_torch(q, k, rpb), scale, torch.from_numpy(g))
    assert_grads_close(got, want)


def test_bwd_wrapper_on_cpu_runs_plain_without_launch():
    q, k, rpb = to_torch(*make_inputs((3, 4, 3), 2, seed=13))
    g = torch.from_numpy(cotangent((3, 4, 3), 2, 14))
    before = (modet_attention_bwd_dq.launches, modet_attention_bwd_dk.launches)
    got = modet_attention_bwd(q, k, rpb, 1.0, g)
    assert (modet_attention_bwd_dq.launches, modet_attention_bwd_dk.launches) == before
    for a, b in zip(got, modet_attention_bwd_plain(q, k, rpb, 1.0, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA device"):
        modet_attention_bwd(q.to("meta"), k.to("meta"), None, 1.0, g.to("meta"))


def test_wrapper_never_takes_the_plain_path_off_the_cpu():
    """Only CPU tensors run the plain version; any other device must reach
    the kernel or raise (here: a meta tensor, and a CPU/meta mix)."""
    q, k, rpb = to_torch(*make_inputs((3, 3, 3), 1, seed=6))
    before = modet_attention.launches
    with pytest.raises(ValueError, match="CUDA device"):
        modet_attention(q.to("meta"), k.to("meta"), rpb.to("meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        modet_attention(q, k, rpb.to("meta"))
    assert modet_attention.launches == before


# ModeT's five level shapes of a 160x192x160 pair (heads 8/4/2/1/1), Im2grid's
# one-head levels, the card tests' uneven shapes, and a row too wide for the ring
GEOMETRY_CASES = [
    ((1, 160, 192, 160, 1, 6), 4, (8, 32, 9, 2160)),
    ((1, 80, 96, 80, 1, 6), 2, (8, 16, 3, 1620)),
    ((1, 40, 48, 40, 2, 6), 4, (8, 16, 1, 720)),
    ((1, 20, 24, 20, 4, 6), 4, (4, 16, 1, 240)),
    ((1, 10, 12, 10, 8, 6), 2, (3, 10, 1, 40)),
    ((2, 1, 1, 1, 8, 32), 4, (1, 1, 1, 2)),
    ((2, 33, 9, 40, 2, 16), 4, (5, 16, 1, 396)),
    ((2, 3, 4, 5, 8, 32), 4, (1, 3, 1, 48)),
    ((1, 0, 4, 4, 1, 6), 4, (4, 4, 1, 0)),  # an empty volume: no blocks
]


@pytest.mark.parametrize("shape,itemsize,want", GEOMETRY_CASES)
def test_attn_geometry_sizes_bricks_grid_and_partials(shape, itemsize, want):
    """`attn_geometry` (K1's and K3's brick and grid, and the number of K3's
    drpb partials) on the CPU: the pinned values, a brick inside the volume
    with at most ATTN_THREADS (voxel, head) rows and a k ring within
    ATTN_RING_BYTES, a grid that covers the volume once, and the partials
    that chip_smoke's bound counts."""
    import chip_smoke
    from smilecode_tpu_torch.kernels import modet_attn as ma

    b, d, h, w, heads, hd = shape
    bh, bw, cd, blocks = got = ma.attn_geometry(shape, itemsize)
    assert got == want
    assert 1 <= bh <= h and 1 <= bw <= w and 1 <= cd <= max(d, 1)
    assert bh * bw * heads <= ma.ATTN_THREADS
    assert 4 * -(-(bh + 2) * (bw + 2) * heads * hd * itemsize // 16) * 16 <= ma.ATTN_RING_BYTES
    assert blocks == b * -(-d // cd) * -(-h // bh) * -(-w // bw)
    assert (-(-d // cd) - 1) * cd < max(d, 1)  # no empty chunk
    no_rpb, with_rpb = (chip_smoke.attn_work("K3", shape, itemsize, r)[0] for r in (False, True))
    assert with_rpb - no_rpb == heads * 27 * 4 + blocks * heads * 27 * 4


# K4 (dk_geometry): ModeT's five level shapes in float32 and bf16, the card
# tests' uneven shapes, and an empty volume
DK_GEOMETRY_CASES = [
    *[(shape, isz) for shape in ((1, 160, 192, 160, 1, 6), (1, 80, 96, 80, 1, 6),
                                 (1, 40, 48, 40, 2, 6), (1, 20, 24, 20, 4, 6),
                                 (1, 10, 12, 10, 8, 6)) for isz in (4, 2)],
    ((2, 1, 1, 1, 8, 32), 4),
    ((2, 3, 5, 64, 1, 6), 2),
    ((2, 2, 3, 65, 2, 6), 4),
    ((2, 33, 9, 40, 2, 16), 4),
    ((2, 7, 6, 9, 2, 5), 2),
    ((2, 5, 4, 3, 8, 6), 4),
    ((1, 0, 4, 4, 1, 6), 4),
]


@pytest.mark.parametrize("shape,itemsize", DK_GEOMETRY_CASES)
def test_dk_geometry_sizes_bricks_and_grid(shape, itemsize):
    """K4's brick on the CPU: inside the volume, at most ATTN_THREADS
    (voxel, head) rows, a two-slot dl + q ring within K4_RING_BYTES and under
    half of the shared memory a block can use (two blocks per SM), chunks of
    at least K4_MIN_CHUNK slices, and a grid that covers the volume once."""
    from smilecode_tpu_torch.kernels import modet_attn as ma

    b, d, h, w, heads, hd = shape
    bh, bw, cd, blocks = ma.dk_geometry(shape, itemsize)
    assert 1 <= bh <= h and 1 <= bw <= w and 1 <= cd <= max(d, 1)
    assert bh * bw * heads <= ma.ATTN_THREADS
    ring = ma.dk_ring_bytes(bh, bw, heads, hd, itemsize)
    rows = [ma.span_pitch(bw, n * itemsize) for n in (heads * 27, heads * hd)]
    assert ring == 2 * (bh + 2) * sum(rows)
    assert all(p % 16 == 0 and p >= (bw + 2) * n * itemsize + 15
               for p, n in zip(rows, (heads * 27, heads * hd)))
    assert ring <= ma.K4_RING_BYTES and ring <= ma._SMEM_MAX // 2
    assert blocks == b * -(-d // cd) * -(-h // bh) * -(-w // bw)
    assert (-(-d // cd) - 1) * cd < max(d, 1)  # no empty chunk
    assert cd >= min(ma.K4_MIN_CHUNK, max(d, 1))
    if d:  # every voxel in exactly one block
        cover = np.zeros((b, d, h, w), np.int32)
        for z in range(b * -(-d // cd)):
            d0 = z % -(-d // cd) * cd
            for y in range(-(-h // bh)):
                for x in range(-(-w // bw)):
                    cover[z // -(-d // cd), d0:d0 + cd, y * bh:(y + 1) * bh,
                          x * bw:(x + 1) * bw] += 1
        assert (cover == 1).all()


@pytest.mark.parametrize("case", ["cpu", "dl-shape", "q-shape", "meta"])
def test_k4_wrapper_checks_its_inputs(case):
    """`modet_attention_bwd_dk` takes CUDA tensors only and checks q and dl
    before anything is built: CPU or meta tensors, a dl of another shape than
    (B, D, H, W, heads, 27) or a q that is not 6-D raise ValueError (no nvcc
    needed), and no launch is counted."""
    q = torch.zeros((1, 3, 4, 5, 2, 6))
    dl = torch.zeros((1, 3, 4, 5, 2, 27))
    args = {"cpu": (q, dl), "dl-shape": (q, dl[..., :26]), "q-shape": (q[0], dl),
            "meta": (q.to("meta"), dl.to("meta"))}[case]
    before = modet_attention_bwd_dk.launches
    with pytest.raises(ValueError, match="modet_attention_bwd_dk"):
        modet_attention_bwd_dk(*args, 1.0)
    assert modet_attention_bwd_dk.launches == before


def test_attn_geometry_rejects_what_the_ring_cannot_hold():
    from smilecode_tpu_torch.kernels.modet_attn import attn_geometry

    with pytest.raises(ValueError, match="heads"):
        attn_geometry((1, 4, 4, 4, 257, 1), 4)
    with pytest.raises(ValueError, match="too wide"):
        attn_geometry((1, 4, 4, 4, 64, 32), 4)
