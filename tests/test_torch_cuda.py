"""Hopper kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA card. This file imports no
jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest`` skips the JAX test configuration in tests/conftest.py.)
Tolerances: attention 1e-5 absolute (outputs in [-1, 1]); warp
1e-5 * max|src| (FMA contraction on the card, none in the plain version).
Backward kernels: 1e-5 times the largest |gradient| (27- and 8-term float32
sums in another order; drpb adds per-block partials, d_src is an atomic
scatter whose order changes from run to run). The bf16 instances against
their bf16 plain versions on the same bf16 inputs: bf16 outputs within 2 bf16
ulps of the largest magnitude, 2^-7 * max|ref| (both compute in float32 and
round once; a sum in another order can flip the last bit), float32 outputs
(drpb, d_flow) as above. The probe kernels P1-P4 equal their plain versions
exactly: they round each product and sum in the plain versions' order.
"""

import os

import numpy as np
import pytest
import torch

from smilecode_tpu_torch.kernels.modet_attn import (
    modet_attention,
    modet_attention_bwd,
    modet_attention_bwd_dk,
    modet_attention_bwd_dk_plain,
    modet_attention_bwd_dq,
    modet_attention_bwd_dq_plain,
    modet_attention_bwd_plain,
    modet_attention_plain,
)
from smilecode_tpu_torch.kernels import probes
from smilecode_tpu_torch.kernels.warp3d import (
    warp3d_trilinear,
    warp3d_trilinear_bwd,
    warp3d_trilinear_bwd_plain,
    warp3d_trilinear_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rand(shape, seed, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(shape) * scale)
                            .astype(np.float32))


@pytest.mark.parametrize("shape,heads,hd,scale,with_rpb", [
    ((5, 7, 6), 1, 6, 1.0, True),
    ((3, 4, 5), 8, 6, 1.0, True),
    ((4, 4, 4), 2, 1, 0.5, False),
    ((4, 5, 3), 2, 16, 0.25, True),
    ((3, 3, 3), 1, 32, 0.1, True),
    ((10, 12, 10), 1, 6, 1.0, False),  # Im2grid's cotr
])
def test_attention_kernel_matches_plain(dev, shape, heads, hd, scale, with_rpb):
    q, k = rand((2, *shape, heads, hd), 1), rand((2, *shape, heads, hd), 2)
    rpb = rand((heads, 3, 3, 3), 3) if with_rpb else None
    ref = modet_attention_plain(q, k, rpb, scale)
    before = modet_attention.launches
    out = modet_attention(q.to(dev), k.to(dev), None if rpb is None else rpb.to(dev), scale)
    torch.cuda.synchronize()
    assert modet_attention.launches == before + 1
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-5)


# K1 and K3 on the shared k stage (csrc/attn_tile.cuh): shapes whose D, H
# and W are no multiples of the brick or the D chunk, heads 1, 2 and 8, head
# dims 1 (2-byte bf16 rows: plain-load copies), 5 (odd: scalar reads), 6,
# 16 and 32, W = 64 for 32-voxel bricks; each with the default grid and with
# ATTN_TARGET_BLOCKS = 9, where the blocks walk long, uneven d chunks through
# the k ring
STAGE_CASES = [
    ((1, 1, 1), 8, 32, True),
    ((3, 5, 64), 1, 6, True),
    ((2, 3, 65), 1, 1, False),
    ((2, 3, 65), 2, 6, True),
    ((33, 9, 40), 2, 16, True),
    ((33, 9, 40), 1, 6, False),
    ((5, 4, 3), 8, 6, True),
    ((7, 6, 9), 2, 5, True),
]


def attn_inputs(shape, heads, hd, with_rpb, dtype, dev, seed):
    q, k = (rand((2, *shape, heads, hd), seed + i).to(dev).to(dtype) for i in (0, 1))
    rpb = rand((heads, 3, 3, 3), seed + 2).to(dev) if with_rpb else None
    g = rand((2, *shape, heads * 3), seed + 3).to(dev).to(dtype)
    return q, k, rpb, g


def assert_matches_plain(got, want, dtype, what):
    """bf16: 2 bf16 ulps of the largest finite magnitude; float32: 1e-5 of
    it; NaN where the plain version has NaN."""
    got, want = got.float().cpu(), want.float().cpu()
    finite = want[torch.isfinite(want)]
    big = max(float(finite.abs().max()) if finite.numel() else 0.0, 1e-3)
    atol = (2.0 ** -7 if dtype == BF16 else 1e-5) * big
    torch.testing.assert_close(got, want, rtol=0, atol=atol, equal_nan=True, msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("target", [None, 9], ids=["grid", "long-chunks"])
@pytest.mark.parametrize("shape,heads,hd,with_rpb", STAGE_CASES)
def test_staged_attention_kernels_match_plain(dev, monkeypatch, shape, heads, hd, with_rpb,
                                              target, dtype):
    """K1 out, K3 dq, dl and drpb vs their plain versions on the card, one
    launch each; drpb within 1e-6 of the largest sum_x |dl_t|."""
    from smilecode_tpu_torch.kernels import modet_attn

    if target is not None:
        monkeypatch.setattr(modet_attn, "ATTN_TARGET_BLOCKS", target)
    q, k, rpb, g = attn_inputs(shape, heads, hd, with_rpb, dtype, dev, 50)
    counts = (modet_attention.launches, modet_attention_bwd_dq.launches)
    out = modet_attention(q, k, rpb, 0.5)
    dq, dl, part = modet_attention_bwd_dq(q, k, rpb, 0.5, g)
    torch.cuda.synchronize()
    assert (modet_attention.launches, modet_attention_bwd_dq.launches) == (counts[0] + 1,
                                                                           counts[1] + 1)
    assert out.dtype == dq.dtype == dl.dtype == dtype
    assert_matches_plain(out, modet_attention_plain(q, k, rpb, 0.5), dtype, "out")
    p_dq, p_dl, p_drpb = modet_attention_bwd_dq_plain(q, k, rpb, 0.5, g)
    assert_matches_plain(dq, p_dq, dtype, "dq")
    assert_matches_plain(dl, p_dl, dtype, "dl")
    if with_rpb:
        assert part.shape == (modet_attn.attn_geometry(q.shape, q.element_size())[3], heads, 27)
        atol = 1e-6 * float(p_dl.float().abs().sum(dim=(0, 1, 2, 3)).max())
        torch.testing.assert_close(part.sum(0).reshape(heads, 3, 3, 3).cpu(), p_drpb.cpu(),
                                   rtol=0, atol=atol)
    else:
        assert part is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("target,min_chunk", [(None, None), (9, None), (1 << 20, 1)],
                         ids=["grid", "long-chunks", "one-slice-chunks"])
@pytest.mark.parametrize("shape,heads,hd,with_rpb", STAGE_CASES)
def test_staged_k4_matches_plain(dev, monkeypatch, shape, heads, hd, with_rpb, target, min_chunk,
                                 dtype):
    """K4's dk vs its plain version on the plain dl, one launch, on K1/K3's
    shapes, with K4_TARGET_BLOCKS = 9 (long, uneven d chunks through the
    two-slot ring) and with chunks of one slice (three staged slices for
    one of dk)."""
    from smilecode_tpu_torch.kernels import modet_attn

    if target is not None:
        monkeypatch.setattr(modet_attn, "K4_TARGET_BLOCKS", target)
    if min_chunk is not None:
        monkeypatch.setattr(modet_attn, "K4_MIN_CHUNK", min_chunk)
    q, k, rpb, g = attn_inputs(shape, heads, hd, with_rpb, dtype, dev, 55)
    dl = modet_attention_bwd_dq_plain(q, k, rpb, 0.5, g)[1]
    before = modet_attention_bwd_dk.launches
    dk = modet_attention_bwd_dk(q, dl, 0.5)
    torch.cuda.synchronize()
    assert modet_attention_bwd_dk.launches == before + 1
    assert dk.dtype == dtype
    assert_matches_plain(dk, modet_attention_bwd_dk_plain(q, dl, 0.5), dtype, "dk")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("elems", [1, 2])
@pytest.mark.parametrize("shape,heads,hd", [((3, 5, 64), 1, 6), ((2, 3, 65), 2, 5),
                                            ((7, 6, 9), 2, 1)])
def test_k4_takes_a_misaligned_q(dev, shape, heads, hd, elems, dtype):
    """q's copy unit follows its address (4 or 8 bytes in float32, 2 or 4 in
    bf16, odd rows included): dk still matches the plain version."""
    q, k, rpb, g = attn_inputs(shape, heads, hd, True, dtype, dev, 57)
    dl = modet_attention_bwd_dq_plain(q, k, rpb, 1.0, g)[1]
    assert_matches_plain(modet_attention_bwd_dk(on_card(q, dev, elems), dl, 1.0),
                         modet_attention_bwd_dk_plain(q, dl, 1.0), dtype, "dk")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_staged_attention_kernels_give_the_plain_nan_pattern(dev, dtype):
    """A q with an inf (at a border voxel and an interior one): the zero-filled
    k border gives inf * 0 = NaN logits where the plain version's padded k
    does, so K1's out and K3's dq, dl and drpb have NaN exactly where the
    plain versions have it, and K4's dk too."""
    q, k, rpb, g = attn_inputs((6, 5, 7), 2, 6, True, torch.float32, dev, 60)
    q[0, 0, 2, 3, 1, 4] = float("inf")
    q[1, 3, 2, 3, 0, 0] = -float("inf")
    q, k, g = q.to(dtype), k.to(dtype), g.to(dtype)
    out = modet_attention(q, k, rpb, 1.0)
    ref = modet_attention_plain(q, k, rpb, 1.0)
    assert torch.isnan(ref).any() and not torch.isnan(ref).all()
    assert_matches_plain(out, ref, dtype, "out")
    got = modet_attention_bwd(q, k, rpb, 1.0, g)
    want = modet_attention_bwd_plain(q, k, rpb, 1.0, g)
    for name, a, b in zip(("dq", "dk", "drpb"), got, want):
        assert torch.isnan(b).any(), name
        assert_matches_plain(a, b, dtype if name != "drpb" else torch.float32, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k3_drpb_partials_are_deterministic(dev, dtype):
    """Two launches of K3 on the same inputs give bitwise equal partials
    (and dq, dl), and two of K4 bitwise equal dk: fixed summation order, no
    atomics."""
    q, k, rpb, g = attn_inputs((20, 24, 20), 4, 6, True, dtype, dev, 70)
    first = modet_attention_bwd_dq(q, k, rpb, 1.0, g)
    second = modet_attention_bwd_dq(q, k, rpb, 1.0, g)
    dks = [modet_attention_bwd_dk(q, first[1], 1.0) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.equal(*dks)


def test_k1_launches_without_autograd_when_no_gradient_is_wanted(dev):
    """Under torch.no_grad(), or when no input requires a gradient, K1 is
    launched directly: one launch, no autograd node; with a gradient wanted
    it goes through the autograd Function."""
    q, k, rpb, _ = attn_inputs((4, 5, 6), 2, 6, True, torch.float32, dev, 80)
    leaves = [t.clone().requires_grad_() for t in (q, k, rpb)]
    ref = modet_attention_plain(q, k, rpb, 1.0)
    for args, grad_mode in ((leaves, False), ((q, k, rpb), True), (leaves, True)):
        before = modet_attention.launches
        with torch.set_grad_enabled(grad_mode):
            out = modet_attention(*args, 1.0)
        torch.cuda.synchronize()
        assert modet_attention.launches == before + 1
        assert (out.grad_fn is None) == (args is not leaves or not grad_mode)
        torch.testing.assert_close(out.detach(), ref, rtol=0, atol=1e-5)


def warp_flow(shape, kind, seed):
    """(2, *shape, 3) float32 flow: a number is the scale of a N(0, 1) flow;
    "wild" is uniform in +-20 voxels, "far" puts every sample 100 voxels
    outside the volume, "nan" is NaN everywhere, "nan1" a N(0, 4) flow whose
    channel 1 is NaN at every second w; "smooth" a +-3 voxel sine field."""
    if kind == "nan1":
        flow = rand((2, *shape, 3), seed, 2.0)
        flow[:, :, :, ::2, 1] = float("nan")
        return flow
    if kind == "wild":
        return torch.from_numpy(np.random.default_rng(seed).uniform(-20, 20, (2, *shape, 3))
                                .astype(np.float32))
    if kind in ("far", "nan"):
        return torch.full((2, *shape, 3), 100.0 if kind == "far" else float("nan"))
    if kind == "smooth":  # +-3 voxels, one period across the volume
        axes = [torch.linspace(0, 2 * np.pi, n) for n in shape]
        grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
        return (3.0 * torch.sin(grid + torch.arange(3.0) + seed)).expand(2, *shape, 3).contiguous()
    return rand((2, *shape, 3), seed, kind)


def on_card(t, dev, misaligned=False):
    """``t`` on the card; with ``misaligned`` (True, or a number of elements),
    as a contiguous view one (or that many) elements into a buffer, so that
    its data pointer is not 16-byte aligned."""
    if not misaligned:
        return t.to(dev)
    elems = int(misaligned)
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=dev)
    view = buf[elems:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


def vector_path(c, dtype, misaligned):
    """Whether K2 and K5 take their vector path: a row of whole 16-byte
    vectors from aligned pointers."""
    return (c * torch.tensor([], dtype=dtype).element_size()) % 16 == 0 and not misaligned


# (source shape, flow shape, C, flow kind, misaligned source): C = 1, 3, 5
# and misaligned sources take the scalar path, the rest the vector path
# (16 bytes: 1 lane per voxel; 8..128 channels: 2..32 lanes; 12: one lane
# over 3 vectors; 256: 32 lanes over 2 vectors each)
WARP_CASES = [
    ((6, 7, 8), (6, 7, 8), 1, 2.0, False),
    ((6, 7, 8), (6, 7, 8), 5, 20.0, False),
    ((9, 11, 7), (5, 6, 4), 3, 1.0, False),  # shape-mismatch rescale
    ((4, 4, 4), (4, 4, 4), 64, 3.0, False),
    ((5, 6, 7), (5, 6, 7), 8, "wild", False),
    ((9, 11, 7), (5, 6, 4), 16, 1.0, False),  # shape-mismatch rescale
    ((5, 4, 6), (5, 4, 6), 4, 2.0, False),
    ((4, 5, 6), (4, 5, 6), 12, 2.0, False),
    ((3, 4, 3), (3, 4, 3), 128, "wild", False),
    ((3, 3, 4), (3, 3, 4), 256, 2.0, False),
    ((5, 6, 7), (5, 6, 7), 8, "far", False),
    ((5, 6, 7), (5, 6, 7), 16, "nan", False),
    ((5, 6, 7), (5, 6, 7), 3, "nan", False),
    ((5, 6, 7), (5, 6, 7), 8, "nan1", False),
    ((5, 6, 7), (5, 6, 7), 8, 2.0, True),  # misaligned view: scalar path
    # a source coarser than the flow (PR++'s T(flow, w)): rescale < 1, and
    # in K5 up to 2 output voxels per axis scatter into one source cell
    ((5, 6, 4), (9, 11, 7), 3, "smooth", False),
    ((5, 6, 4), (9, 11, 7), 3, "wild", False),
    ((5, 6, 4), (9, 11, 7), 16, "smooth", False),
    ((5, 6, 4), (9, 11, 7), 16, "wild", False),
    # the d_src scatter at RDN's widest rows, many voxels per source cell
    ((3, 4, 3), (9, 11, 7), 64, "smooth", False),
    ((3, 4, 3), (9, 11, 7), 128, "wild", False),
]


@pytest.mark.parametrize("src_shape,flow_shape,c,kind,misaligned", WARP_CASES)
def test_warp_kernel_matches_plain(dev, src_shape, flow_shape, c, kind, misaligned):
    src = rand((2, *src_shape, c), 4)
    flow = warp_flow(flow_shape, kind, 5)
    ref = warp3d_trilinear_plain(src, flow)
    if kind in ("far", "nan"):
        assert torch.count_nonzero(ref) == 0
    before = (warp3d_trilinear.launches, warp3d_trilinear.launches_vector)
    out = warp3d_trilinear(on_card(src, dev, misaligned), flow.to(dev))
    torch.cuda.synchronize()
    assert (warp3d_trilinear.launches, warp3d_trilinear.launches_vector) == (
        before[0] + 1, before[1] + vector_path(c, src.dtype, misaligned))
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-5 * float(src.abs().max()))


@pytest.mark.parametrize("impl", ["pallas", "guarded", "auto"])
@pytest.mark.parametrize("src_shape,flow_shape,c,amp", [
    ((8, 10, 8), (8, 10, 8), 16, 2.0),
    ((6, 7, 8), (6, 7, 8), 3, 20.0),
    ((9, 11, 7), (5, 6, 4), 1, 1.0),  # shape-mismatch rescale
])
def test_warp_f_entries_launch_k2(dev, impl, src_shape, flow_shape, c, amp):
    """``ops.warp(impl="pallas"|"guarded")``, kernel F's entries, launch K2
    once per bilinear warp and match the plain version; nearest mode and
    ``impl="simple"`` launch nothing."""
    from smilecode_tpu_torch.ops.warp import warp

    src = rand((1, *src_shape, c), 25)
    flow = rand((1, *flow_shape, 3), 26, amp)
    ref = warp3d_trilinear_plain(src, flow)
    before = warp3d_trilinear.launches
    out = warp(src.to(dev), flow.to(dev), impl=impl)
    warp(src.to(dev), flow.to(dev), mode="nearest", impl=impl)
    warp(src.to(dev), flow.to(dev), impl="simple")
    torch.cuda.synchronize()
    assert warp3d_trilinear.launches == before + 1
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-5 * float(src.abs().max()))


def test_kernels_raise_on_what_they_do_not_take(dev):
    """bf16 is taken (q and k together, a float32 flow); float16, mixed q/k
    dtypes, a non-float32 rpb, flow or g raise."""
    q = rand((1, 3, 3, 3, 1, 6), 6).to(dev)
    before = modet_attention.launches_bf16
    assert modet_attention(q.bfloat16(), q.bfloat16(), None).dtype == torch.bfloat16
    assert modet_attention.launches_bf16 == before + 1
    for a, b in ((q.half(), q.half()), (q, q.bfloat16()), (q.bfloat16(), q)):
        with pytest.raises(TypeError, match="float32 or both bfloat16"):
            modet_attention(a, b, None)
    with pytest.raises(TypeError, match="rpb float32"):
        modet_attention(q.bfloat16(), q.bfloat16(), torch.zeros((1, 3, 3, 3), device=dev).bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        modet_attention(q.transpose(1, 2), q.transpose(1, 2), None)
    with pytest.raises(ValueError, match="CUDA device"):
        modet_attention(q, q.cpu(), None)
    with pytest.raises(ValueError, match="head_dim"):
        big = rand((1, 2, 2, 2, 1, 33), 7).to(dev)
        modet_attention(big, big, None)
    with pytest.raises(TypeError, match="q's dtype"):
        modet_attention_bwd(q, q, None, 1.0, torch.zeros((1, 3, 3, 3, 3), device=dev).double())
    dl = torch.zeros((1, 3, 3, 3, 1, 27), device=dev)
    with pytest.raises(TypeError, match="dl must have q's dtype"):
        modet_attention_bwd_dk(q, dl.bfloat16(), 1.0)
    with pytest.raises(ValueError, match="dl must be contiguous"):
        modet_attention_bwd_dk(q, dl.transpose(1, 2).contiguous().transpose(1, 2), 1.0)
    with pytest.raises(ValueError, match="16-byte aligned"):
        modet_attention_bwd_dk(q, on_card(dl, dev, misaligned=True), 1.0)
    src, flow = rand((1, 4, 4, 4, 2), 8).to(dev), torch.zeros((1, 4, 4, 4, 3), device=dev)
    with pytest.raises(ValueError, match="g must be"):
        warp3d_trilinear_bwd(src, flow, torch.zeros((1, 4, 4, 4, 3), device=dev))
    assert warp3d_trilinear(src.bfloat16(), flow).dtype == torch.bfloat16
    for s_, f_ in ((src.half(), flow), (src.bfloat16(), flow.bfloat16()), (src.double(), flow)):
        with pytest.raises(TypeError, match="float32 or bfloat16 src and a float32 flow"):
            warp3d_trilinear(s_, f_)
    with pytest.raises(TypeError, match="g must have src's dtype"):
        warp3d_trilinear_bwd(src.bfloat16(), flow, torch.zeros((1, 4, 4, 4, 2), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        warp3d_trilinear(src.transpose(1, 2), flow)


BWD_TOL = 1e-5


def assert_scaled_close(got, want, what):
    atol = BWD_TOL * max(float(want.abs().max()), 1e-3)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=atol, msg=what)


@pytest.mark.parametrize("shape,heads,hd,scale,with_rpb", [
    ((5, 7, 3), 1, 6, 1.0, True),
    ((3, 4, 5), 8, 6, 1.0, True),
    ((4, 3, 5), 2, 1, 0.5, False),
    ((3, 5, 3), 2, 16, 0.25, True),
    ((3, 3, 3), 1, 32, 0.1, True),
    ((6, 8, 5), 1, 6, 1.0, False),  # Im2grid's cotr
])
def test_attention_backward_kernels_match_plain(dev, shape, heads, hd, scale, with_rpb):
    q, k = rand((2, *shape, heads, hd), 11), rand((2, *shape, heads, hd), 12)
    rpb = rand((heads, 3, 3, 3), 13) if with_rpb else None
    g = rand((2, *shape, heads * 3), 14)
    ref = modet_attention_bwd_plain(q, k, rpb, scale, g)
    before = (modet_attention_bwd_dq.launches, modet_attention_bwd_dk.launches)
    got = modet_attention_bwd(q.to(dev), k.to(dev), None if rpb is None else rpb.to(dev), scale,
                              g.to(dev))
    torch.cuda.synchronize()
    assert (modet_attention_bwd_dq.launches, modet_attention_bwd_dk.launches) == (
        before[0] + 1, before[1] + 1)
    for name, a, b in zip(("dq", "dk", "drpb"), got, ref):
        if b is None:
            assert a is None
        else:
            assert_scaled_close(a, b, name)


def test_attention_autograd_runs_k1_k3_k4(dev):
    q, k = rand((1, 4, 5, 3, 2, 6), 15), rand((1, 4, 5, 3, 2, 6), 16)
    rpb, g = rand((2, 3, 3, 3), 17), rand((1, 4, 5, 3, 6), 18)
    leaves = [t.to(dev).requires_grad_() for t in (q, k, rpb)]
    counts = (modet_attention.launches, modet_attention_bwd_dq.launches,
              modet_attention_bwd_dk.launches)
    out = modet_attention(*leaves, 0.5)
    out.backward(g.to(dev))
    torch.cuda.synchronize()
    assert (modet_attention.launches, modet_attention_bwd_dq.launches,
            modet_attention_bwd_dk.launches) == tuple(c + 1 for c in counts)
    ref = modet_attention_bwd_plain(q, k, rpb, 0.5, g)
    for name, leaf, b in zip(("dq", "dk", "drpb"), leaves, ref):
        assert_scaled_close(leaf.grad, b, name)


@pytest.mark.parametrize("src_shape,flow_shape,c,kind,misaligned", WARP_CASES)
def test_warp_backward_kernel_matches_plain(dev, src_shape, flow_shape, c, kind, misaligned):
    """K5 vs its plain version; at a NaN flow every corner is outside the
    volume in both, so d_flow is 0 there and d_src gets nothing (JAX
    `ops.warp`'s gradients, tests/test_torch_warp.py)."""
    src = rand((2, *src_shape, c), 19)
    flow = warp_flow(flow_shape, kind, 20)
    g = rand((2, *flow_shape, c), 21)
    for want_dsrc in (True, False):
        ref = warp3d_trilinear_bwd_plain(src, flow, g, want_dsrc)
        counters = ("launches", "scatters", "launches_vector")
        before = [getattr(warp3d_trilinear_bwd, k) for k in counters]
        d_src, d_flow = warp3d_trilinear_bwd(on_card(src, dev, misaligned), flow.to(dev),
                                             on_card(g, dev, misaligned), want_dsrc)
        torch.cuda.synchronize()
        assert [getattr(warp3d_trilinear_bwd, k) for k in counters] == [
            before[0] + 1, before[1] + int(want_dsrc),
            before[2] + vector_path(c, src.dtype, misaligned)]
        assert_scaled_close(d_flow, ref[1], "d_flow")
        if want_dsrc:
            assert_scaled_close(d_src, ref[0], "d_src")
        else:
            assert d_src is None


def test_warp_autograd_scatters_only_when_src_needs_grad(dev):
    src, flow, g = rand((1, 5, 6, 4, 2), 22), rand((1, 5, 6, 4, 3), 23, 2.0), rand((1, 5, 6, 4, 2), 24)
    for src_grad in (True, False):
        s = src.to(dev).requires_grad_(src_grad)
        f = flow.to(dev).requires_grad_()
        counts = (warp3d_trilinear.launches, warp3d_trilinear_bwd.launches,
                  warp3d_trilinear_bwd.scatters)
        warp3d_trilinear(s, f).backward(g.to(dev))
        torch.cuda.synchronize()
        assert (warp3d_trilinear.launches, warp3d_trilinear_bwd.launches,
                warp3d_trilinear_bwd.scatters) == (counts[0] + 1, counts[1] + 1,
                                                    counts[2] + int(src_grad))
        ref_src, ref_flow = warp3d_trilinear_bwd_plain(src, flow, g, src_grad)
        assert_scaled_close(f.grad, ref_flow, "d_flow")
        if src_grad:
            assert_scaled_close(s.grad, ref_src, "d_src")
        else:
            assert s.grad is None


BF16 = torch.bfloat16


def assert_bf16_close(got, want, what):
    """2 bf16 ulps of the largest magnitude, 2^-7 * max|want|."""
    assert got.dtype == want.dtype, what
    want = want.float()
    atol = 2.0 ** -7 * max(float(want.abs().max()), 1e-3)
    torch.testing.assert_close(got.float().cpu(), want.cpu(), rtol=0, atol=atol, msg=what)


@pytest.mark.parametrize("shape,heads,hd,scale,with_rpb", [
    ((5, 7, 6), 1, 6, 1.0, True),
    ((3, 4, 5), 8, 6, 1.0, True),
    ((4, 5, 3), 2, 16, 0.4, True),  # a scale that bf16 rounds
    ((10, 12, 10), 1, 6, 1.0, False),
])
def test_bf16_attention_kernels_match_plain(dev, shape, heads, hd, scale, with_rpb):
    """K1, K3 and K4 on bf16 q and k vs their plain versions on the card:
    out, dq, dl, dk in bf16; drpb float32."""
    q, k = (rand((2, *shape, heads, hd), s).to(dev).to(BF16) for s in (31, 32))
    rpb = rand((heads, 3, 3, 3), 33).to(dev) if with_rpb else None
    g = rand((2, *shape, heads * 3), 34).to(dev).to(BF16)
    counts = (modet_attention.launches_bf16, modet_attention_bwd_dq.launches_bf16,
              modet_attention_bwd_dk.launches_bf16)
    assert_bf16_close(modet_attention(q, k, rpb, scale), modet_attention_plain(q, k, rpb, scale),
                      "out")
    dq, dl, part = modet_attention_bwd_dq(q, k, rpb, scale, g)
    p_dq, p_dl, p_drpb = modet_attention_bwd_dq_plain(q, k, rpb, scale, g)
    assert_bf16_close(dq, p_dq, "dq")
    assert_bf16_close(dl, p_dl, "dl")
    assert_bf16_close(modet_attention_bwd_dk(q, p_dl, scale), modet_attention_bwd_dk_plain(q, p_dl, scale),
                      "dk")
    if with_rpb:
        drpb = part.sum(0).reshape(heads, 3, 3, 3)
        assert drpb.dtype == torch.float32
        atol = 1e-6 * float(p_dl.float().abs().sum(dim=(0, 1, 2, 3)).max())
        torch.testing.assert_close(drpb.cpu(), p_drpb.cpu(), rtol=0, atol=atol)
    torch.cuda.synchronize()
    assert (modet_attention.launches_bf16, modet_attention_bwd_dq.launches_bf16,
            modet_attention_bwd_dk.launches_bf16) == tuple(c + 1 for c in counts)


@pytest.mark.parametrize("src_shape,flow_shape,c,kind,misaligned", [
    ((6, 7, 8), (6, 7, 8), 8, 2.0, False),
    ((5, 7, 6), (5, 7, 6), 16, 20.0, False),
    ((9, 11, 7), (5, 6, 4), 3, 1.0, False),  # shape-mismatch rescale
    ((9, 11, 7), (5, 6, 4), 8, 1.0, False),  # shape-mismatch rescale
    ((4, 5, 3), (4, 5, 3), 64, 3.0, False),
    ((5, 6, 4), (5, 6, 4), 4, "wild", False),  # 8-byte rows: scalar path
    ((5, 6, 4), (5, 6, 4), 16, "wild", False),
    ((5, 6, 4), (5, 6, 4), 8, "far", False),
    ((5, 6, 4), (5, 6, 4), 16, "nan", False),
    ((5, 6, 4), (5, 6, 4), 16, 2.0, True),  # misaligned view: scalar path
])
def test_bf16_warp_kernels_match_plain(dev, src_shape, flow_shape, c, kind, misaligned):
    """K2 and K5 on a bf16 source and a float32 flow vs their plain
    versions: out and d_src bf16 (the scatter sums in float32), d_flow
    float32; the F entries of ``ops.warp`` take bf16 too. A NaN flow gives
    zeros and no gradient (every corner outside the volume) in both."""
    from smilecode_tpu_torch.ops.warp import warp

    src = on_card(rand((2, *src_shape, c), 35).to(BF16), dev, misaligned)
    flow = warp_flow(flow_shape, kind, 36).to(dev)
    g = on_card(rand((2, *flow_shape, c), 37).to(BF16), dev, misaligned)
    vector = vector_path(c, BF16, misaligned)
    ref = warp3d_trilinear_plain(src, flow)
    for impl in ("auto", "pallas", "guarded"):
        before = (warp3d_trilinear.launches_bf16, warp3d_trilinear.launches_vector)
        assert_bf16_close(warp(src, flow, impl=impl), ref, f"out ({impl})")
        assert (warp3d_trilinear.launches_bf16, warp3d_trilinear.launches_vector) == (
            before[0] + 1, before[1] + vector)
    counters = ("launches_bf16", "scatters_bf16", "launches_vector")
    before = [getattr(warp3d_trilinear_bwd, k) for k in counters]
    d_src, d_flow = warp3d_trilinear_bwd(src, flow, g, True)
    p_src, p_flow = warp3d_trilinear_bwd_plain(src, flow, g, True)
    assert d_flow.dtype == torch.float32
    assert_bf16_close(d_src, p_src, "d_src")
    assert_scaled_close(d_flow, p_flow.cpu(), "d_flow")
    torch.cuda.synchronize()
    assert [getattr(warp3d_trilinear_bwd, k) for k in counters] == [
        before[0] + 1, before[1] + 1, before[2] + vector]


def test_warp_kernels_index_past_2_31(dev):
    """A bf16 source of 3 * 2^30 elements (6 GiB, B=2) takes the 64-bit
    instances of K2 and K5 (vector path, C=8): an 8^3 flow grid, rescaled to
    the source, samples corners across both volumes, the second of which
    lies mostly past element 2^31."""
    gen = torch.Generator(dev).manual_seed(0)
    src = torch.randn((2, 384, 512, 1024, 8), generator=gen, device=dev).to(BF16)
    flow = torch.rand((2, 8, 8, 8, 3), generator=gen, device=dev) * 8 - 4
    g = torch.randn((2, 8, 8, 8, 8), generator=gen, device=dev).to(BF16)
    vectors = warp3d_trilinear.launches_vector, warp3d_trilinear_bwd.launches_vector
    assert_bf16_close(warp3d_trilinear(src, flow), warp3d_trilinear_plain(src, flow), "out")
    torch.cuda.empty_cache()
    _, d_flow = warp3d_trilinear_bwd(src, flow, g, False)
    _, p_flow = warp3d_trilinear_bwd_plain(src, flow, g, False)
    assert_scaled_close(d_flow, p_flow.cpu(), "d_flow")
    torch.cuda.empty_cache()
    d_src, _ = warp3d_trilinear_bwd(src, flow, g, True)
    p_src, _ = warp3d_trilinear_bwd_plain(src, flow, g, True)
    chunks = list(zip(d_src.view(-1).split(2 ** 28), p_src.view(-1).split(2 ** 28)))
    err = max(float((a.float() - b.float()).abs().max()) for a, b in chunks)
    scale = max(float(b.float().abs().max()) for _, b in chunks)
    assert 0 < scale and err <= 2.0 ** -7 * scale, (err, scale)
    torch.cuda.synchronize()
    assert (warp3d_trilinear.launches_vector, warp3d_trilinear_bwd.launches_vector) == (
        vectors[0] + 1, vectors[1] + 2)


def test_bf16_autograd_runs_the_bf16_kernels(dev):
    """Autograd through K1 and K2 on bf16 inputs launches the bf16 K3, K4 and
    K5 and gives gradients in the inputs' dtypes."""
    q, k = (rand((1, 4, 5, 3, 2, 6), s).to(dev).to(BF16).requires_grad_() for s in (38, 39))
    rpb = rand((2, 3, 3, 3), 40).to(dev).requires_grad_()
    src = rand((1, 4, 5, 3, 4), 41).to(dev).to(BF16).requires_grad_()
    flow = rand((1, 4, 5, 3, 3), 42, 2.0).to(dev).requires_grad_()
    before = {fn: fn.launches_bf16 for fn in (modet_attention, modet_attention_bwd_dq,
                                                modet_attention_bwd_dk, warp3d_trilinear,
                                                warp3d_trilinear_bwd)}
    loss = modet_attention(q, k, rpb, 1.0).float().sum() + warp3d_trilinear(src, flow).float().sum()
    loss.backward()
    torch.cuda.synchronize()
    assert all(fn.launches_bf16 == n + 1 for fn, n in before.items())
    assert (q.grad.dtype, k.grad.dtype, rpb.grad.dtype) == (BF16, BF16, torch.float32)
    assert (src.grad.dtype, flow.grad.dtype) == (BF16, torch.float32)


# The probe kernels P1-P4 (csrc/probes.cu) vs their plain versions, exactly,
# on the edge cases of `smilecode_tpu_torch.probes.EDGE_CASES` (the table
# chip_smoke.py's phase 25 runs too). Amounts and bounds are ints or int32
# tensors on the card; the tensor case runs under
# torch.cuda.set_sync_debug_mode("error"), which raises at any copy to the
# host or sync inside the wrapper; every call launches its kernel once.
def _edge_params():
    from smilecode_tpu_torch.probes import EDGE_CASES, Smem

    for case in EDGE_CASES:
        if not any(isinstance(a, Smem) for a in case.args):  # no ints: checked for syncs
            yield pytest.param(case, True, id=case.id)
            continue
        for on_device in (False, True):
            yield pytest.param(case, on_device,
                               id=f"{case.id}-{'on-device' if on_device else 'by-value'}")


@pytest.mark.parametrize("case,on_device", list(_edge_params()))
def test_probe_kernel_matches_plain(dev, case, on_device):
    from smilecode_tpu_torch.probes import launch_edge_case

    out = launch_edge_case(case, dev, on_device)
    assert out.shape == case.want.shape and torch.equal(out, case.want)
    if case.kernel == "P1":
        a, axis = case.args[0][0], case.args[1]
        assert torch.equal(out, torch.from_numpy(np.roll(case.x, -a, axis)))
    if case.kernel == "P4":  # Python's // and %, the product wrapped to int32 as torch's
        m, t = case.args[0], case.x.tolist()
        assert out.tolist() == [[((v // m) * m + 2 ** 31) % 2 ** 32 - 2 ** 31 for v in t],
                                [v % m for v in t]]


def test_probe_scripts_run_exactly_on_the_card(dev):
    """The entry point's 17 runs of the scripts' 14 probes: every error 0,
    and P1-P4 launched 6, 8, 2 and 1 times."""
    from smilecode_tpu_torch import probes as entry

    before = {k: fn.launches for k, fn in probes.KERNELS.items()}
    results = entry.main(device="cuda")
    assert len(results) == 17 and all(err == 0 for _, _, err in results)
    assert {k: fn.launches - before[k] for k, fn in probes.KERNELS.items()} == {
        "P1": 6, "P2": 8, "P3": 2, "P4": 1}


# P4 on more than 2^30 values: row 1 of out starts n values on, an offset
# past 2^31 that a 32-bit n + i overflows; past 2^31 values the count
# itself no longer fits the C int it went as (it wrapped to a negative
# count). Run in a child process, so that an illegal address cannot poison
# this process's CUDA context for the tests after it.
P4_PAST_2_30 = """
import sys
import torch
from smilecode_tpu_torch.kernels import probes
n, k, m = int(sys.argv[1]), 2 ** 20, -1000
g = torch.Generator(device="cuda").manual_seed(11)
t = torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int32, device="cuda", generator=g)
out = probes.floor_divmod(t, m)
torch.cuda.synchronize()
for part in (slice(0, k), slice(n - k, n)):
    assert torch.equal(out[:, part], probes.floor_divmod_plain(t[part], m)), part
print("ok", probes.floor_divmod.launches)
"""


@pytest.mark.parametrize("n", [2 ** 30 + 4096, 2 ** 31 + 4096], ids=["2^30+4096", "2^31+4096"])
def test_floor_divmod_past_2_30_values_writes_row_1_in_bounds(dev, n):
    import subprocess
    import sys

    run = subprocess.run([sys.executable, "-c", P4_PAST_2_30, str(n)], capture_output=True,
                         text=True, timeout=600,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert run.returncode == 0 and run.stdout.split() == ["ok", "1"], run.stdout + run.stderr


# the modes of the D-sharded step: K1/K3/K4 with k of D+2 slices (halo-k;
# K4 writes dk over all D+2, one-slice chunks reach the border slices
# alone) and K2/K5 with a D origin into a deeper (gathered) source
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("target,min_chunk", [(None, None), (1 << 20, 1)],
                         ids=["grid", "one-slice-chunks"])
@pytest.mark.parametrize("shape,heads,hd,with_rpb", [((1, 1, 1), 8, 32, True),
                                                     ((3, 5, 64), 1, 6, True),
                                                     ((7, 6, 9), 2, 5, False),
                                                     ((5, 4, 3), 8, 6, True)])
def test_halo_k_attention_kernels_match_plain(dev, monkeypatch, shape, heads, hd, with_rpb,
                                              target, min_chunk, dtype):
    from smilecode_tpu_torch.kernels import modet_attn

    if target is not None:
        monkeypatch.setattr(modet_attn, "ATTN_TARGET_BLOCKS", target)
        monkeypatch.setattr(modet_attn, "K4_TARGET_BLOCKS", target)
        monkeypatch.setattr(modet_attn, "K4_MIN_CHUNK", min_chunk)
    q, _, rpb, g = attn_inputs(shape, heads, hd, with_rpb, dtype, dev, 70)
    k = rand((2, shape[0] + 2, *shape[1:], heads, hd), 74).to(dev).to(dtype)
    counts = [f.launches_halo for f in (modet_attention, modet_attention_bwd_dq,
                                         modet_attention_bwd_dk)]
    out = modet_attention(q, k, rpb, 0.5, k_halo=True)
    dq, dl, part = modet_attention_bwd_dq(q, k, rpb, 0.5, g, k_halo=True)
    p_dq, p_dl, p_drpb = modet_attention_bwd_dq_plain(q, k, rpb, 0.5, g, k_halo=True)
    dk = modet_attention_bwd_dk(q, p_dl, 0.5, k_halo=True)
    torch.cuda.synchronize()
    assert [f.launches_halo for f in (modet_attention, modet_attention_bwd_dq,
                                      modet_attention_bwd_dk)] == [c + 1 for c in counts]
    assert dk.shape == k.shape
    assert_matches_plain(out, modet_attention_plain(q, k, rpb, 0.5, k_halo=True), dtype, "out")
    assert_matches_plain(dq, p_dq, dtype, "dq")
    assert_matches_plain(dl, p_dl, dtype, "dl")
    assert_matches_plain(dk, modet_attention_bwd_dk_plain(q, p_dl, 0.5, k_halo=True), dtype,
                         "dk")
    if with_rpb:
        atol = 1e-6 * float(p_dl.float().abs().sum(dim=(0, 1, 2, 3)).max())
        torch.testing.assert_close(part.sum(0).reshape(heads, 3, 3, 3).cpu(), p_drpb.cpu(),
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("src_depth,flow_shape,d0,c,kind", [
    (12, (6, 7, 8), 0, 1, 2.0), (12, (6, 7, 8), 6, 3, "wild"), (12, (3, 7, 8), 5, 8, 2.0),
    (8, (4, 5, 6), 4, 16, "wild"), (9, (3, 4, 3), 3, 64, 2.0)])
def test_d_origin_warp_kernels_match_plain(dev, src_depth, flow_shape, d0, c, kind, dtype):
    src = rand((2, src_depth, *flow_shape[1:], c), 80).to(dtype)
    flow = warp_flow(flow_shape, kind, 81)
    g = rand((2, *flow_shape, c), 82).to(dtype)
    before = (warp3d_trilinear.launches_origin, warp3d_trilinear_bwd.launches_origin)
    out = warp3d_trilinear(src.to(dev), flow.to(dev), d0)
    d_src, d_flow = warp3d_trilinear_bwd(src.to(dev), flow.to(dev), g.to(dev), True, d0)
    torch.cuda.synchronize()
    assert (warp3d_trilinear.launches_origin,
            warp3d_trilinear_bwd.launches_origin) == (before[0] + 1, before[1] + 1)
    assert d_src.shape == src.shape
    p_src, p_flow = warp3d_trilinear_bwd_plain(src, flow, g, True, d0)
    assert_matches_plain(out, warp3d_trilinear_plain(src, flow, d0), dtype, "out")
    assert_matches_plain(d_src, p_src, dtype, "d_src")
    assert_matches_plain(d_flow, p_flow, torch.float32, "d_flow")
