"""The port's multi-GPU layer (`parallel/mesh.py`, `parallel/spatial.py`)
and the kernel modes of the D-sharded step, on the CPU.

* Collectives on 4 gloo ranks (`run_ranks`, a ``file://`` store), float64:
  `halo_exchange` (halo 1 and 2) and its backward against JAX
  `parallel.spatial.halo_exchange` under shard_map on 4 of the conftest's 8
  CPU devices and its `jax.vjp` (1e-12: the same additions);
  `halo_conv` against an unsharded SAME convolution (1e-12); `all_gather_d`
  / its reduce_scatter backward and `psum` / its psum backward against
  their definitions (exact).
* `shard_batch` and the backend choice, without processes.
* The halo-k plain versions of K1, K3 and K4 against JAX
  `modet_attention_planes` and `_backward_planes` with
  ``k_prepadded_d=True`` in Pallas interpret mode, k's border slices data
  (1e-5 of each output's largest; drpb 1e-5 of the largest sum_x |dl_t|:
  float32 sums in other orders).
* The D-origin plain warp and its adjoint (source depth 12, output depth 6,
  d0 = 5) against JAX `warp3d_planes_v3` and `warp3d_planes_v3_dflow` in
  interpret mode at the same absolute coordinates (1e-5 of the largest
  value), and d_src against `jax.vjp` of JAX `ops.warp.warp_coords` on
  the source (1e-5).
* The wheel holds every source that the port compiles.
"""

import glob
import os
import shutil
import subprocess
import sys
import zipfile
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ranks as R
from smilecode_tpu_torch.kernels import modet_attn as MA
from smilecode_tpu_torch.kernels import warp3d as W3
from smilecode_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)
SP = 4  # spatial ranks of the collective tests
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def coll():
    return M.run_ranks(R.collectives, 1, SP, "cpu", args=(5,), threads=1)


def _jax_halo(x, g, halo):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from smilecode_tpu.parallel.mesh import make_mesh
    from smilecode_tpu.parallel.spatial import halo_exchange

    mesh = make_mesh(dp=1, spatial=SP)
    spec = P(None, "spatial")
    fn = shard_map(partial(halo_exchange, halo=halo), mesh=mesh, in_specs=(spec,),
                   out_specs=spec, check_vma=False)
    with jax.enable_x64():
        y, vjp = jax.vjp(fn, jnp.asarray(x))
        (dx,) = vjp(jnp.asarray(g))
        return np.asarray(y), np.asarray(dx)


@pytest.mark.parametrize("halo", [1, 2])
def test_halo_exchange_and_its_backward_match_jax(coll, halo):
    x, g1, g2 = R.collective_inputs(5, SP)[:3]
    y, dx = _jax_halo(x, g1 if halo == 1 else g2, halo)
    got_y = torch.cat([r[f"halo{halo}"][0] for r in coll], 1).numpy()
    got_dx = torch.cat([r[f"halo{halo}"][1] for r in coll], 1).numpy()
    np.testing.assert_allclose(got_y, y, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_dx, dx, rtol=0, atol=1e-12)
    assert np.abs(got_y[:, :halo]).max() == 0 and np.abs(got_y[:, -halo:]).max() == 0


def test_halo_conv_matches_unsharded_conv(coll):
    x, _, _, w, bias, _ = R.collective_inputs(5, SP)
    want = torch.nn.functional.conv3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                                      torch.from_numpy(w), torch.from_numpy(bias), padding=1)
    got = torch.cat([r["conv"] for r in coll], 1)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 4, 1).numpy(), rtol=0,
                               atol=1e-12)


def test_all_gather_reduce_scatter_and_psum_transposes(coll):
    x, _, _, _, _, gg = R.collective_inputs(5, SP)
    dl = 8 // SP
    for j, r in enumerate(coll):
        ga, dxa = r["gather"]
        assert torch.equal(ga, torch.from_numpy(x))
        # the all_gather's transpose: every rank's cotangent of slab j, summed
        np.testing.assert_allclose(dxa.numpy(), SP * gg[:, j * dl:(j + 1) * dl], rtol=1e-15)
        s, dxs = r["psum"]
        np.testing.assert_allclose(s.numpy(), x.sum(axis=(1, 2, 3)), rtol=1e-13)
        # psum's transpose is psum: the ranks' cotangents 1..SP, summed
        assert torch.all(dxs == SP * (SP + 1) / 2)


def test_shard_batch_takes_rows_and_slabs_and_raises_on_uneven_batches():
    a = torch.arange(4 * 8 * 2).reshape(4, 8, 1, 2, 1).float()
    for rank in range(4):
        mesh = M.Mesh(2, 2, rank, torch.device("cpu"), "gloo", {}, {})
        (s,) = M.shard_batch(mesh, (a,))
        i, j = rank // 2, rank % 2
        assert torch.equal(s, a[2 * i:2 * i + 2, 4 * j:4 * j + 4])
    mesh = M.Mesh(2, 1, 0, torch.device("cpu"), "gloo", {}, {})
    with pytest.raises(ValueError, match="not divisible by dp=2"):
        M.shard_batch(mesh, (a[:3],))
    assert M.shard_batch(None, (a,))[0] is a
    assert M.rank_device("cpu", 3) == torch.device("cpu")
    assert "backend gloo" in mesh.describe() and not mesh.staged("send/recv", a)


def _to_planes(x):
    b, d, h, w, nh, c = x.shape
    return jnp.asarray(x.transpose(0, 4, 1, 5, 2, 3).reshape(b * nh, d, c, h, w))


def _from_planes(x, b, heads):
    bh, d, c, h, w = x.shape
    return np.asarray(x).reshape(b, heads, d, c, h, w).transpose(0, 2, 4, 5, 1, 3)


def test_halo_k_plain_attention_and_backward_match_jax_kernels():
    from smilecode_tpu.kernels.modet_attn import _backward_planes, modet_attention_planes

    d, h, w, heads, hd = 3, 5, 4, 2, 3
    q, kp, rpb, g = R.arrays(11, (1, d, h, w, heads, hd), (1, d + 2, h, w, heads, hd),
                             (heads, 3, 3, 3), (1, d, h, w, heads * 3), dtype=np.float32)
    rpb = rpb * 0.5
    scale = 0.7
    out = MA.modet_attention_plain(torch.from_numpy(q), torch.from_numpy(kp),
                                   torch.from_numpy(rpb), scale, k_halo=True)
    j_out = modet_attention_planes(_to_planes(q), _to_planes(kp), jnp.asarray(rpb), heads, scale,
                                   True, True)
    j_out = np.asarray(j_out).reshape(1, heads, 3, d, h, w).transpose(0, 3, 4, 5, 1, 2)
    np.testing.assert_allclose(out.numpy(), j_out.reshape(out.shape), rtol=0,
                               atol=1e-5 * np.abs(j_out).max())

    dq, dl, drpb = MA.modet_attention_bwd_dq_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(rpb), scale,
        torch.from_numpy(g), k_halo=True)
    dk = MA.modet_attention_bwd_dk_plain(torch.from_numpy(q), dl, scale, k_halo=True)
    assert dk.shape == kp.shape
    gpl = g.reshape(1, d, h, w, heads, 3).transpose(0, 4, 5, 1, 2, 3).reshape(heads, 3, d, h, w)
    j_dq, j_dk, j_drpb = _backward_planes(_to_planes(q), _to_planes(kp), jnp.asarray(rpb), heads,
                                          scale, jnp.asarray(gpl), True, True)
    for name, a, b in (("dq", dq.numpy(), _from_planes(j_dq, 1, heads)),
                       ("dk", dk.numpy(), _from_planes(j_dk, 1, heads))):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max(), err_msg=name)
    # k's border slices (the neighbours') get cotangents: they are data
    assert np.abs(dk.numpy()[:, [0, -1]]).max() > 1e-3
    tol = 1e-5 * float(dl.abs().sum(dim=(0, 1, 2, 3)).max())
    np.testing.assert_allclose(drpb.numpy(), np.asarray(j_drpb), rtol=0, atol=tol)
    # the halo-k backward through autograd equals the written-out one
    qt, kt = torch.from_numpy(q).requires_grad_(), torch.from_numpy(kp).requires_grad_()
    rt = torch.from_numpy(rpb).requires_grad_()
    auto = torch.autograd.grad(MA.modet_attention(qt, kt, rt, scale, k_halo=True), (qt, kt, rt),
                               torch.from_numpy(g))
    for a, b in zip(auto, (dq, dk, drpb)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5 * float(b.abs().max()))


def test_d_origin_plain_warp_and_adjoint_match_jax():
    from smilecode_tpu.kernels.warp3d_v3 import warp3d_planes_v3, warp3d_planes_v3_dflow
    from smilecode_tpu.ops.warp import warp_coords

    c, sd, fd, h, w, d0 = 4, 12, 6, 7, 9, 5
    src, g = R.arrays(21, (1, sd, h, w, c), (1, fd, h, w, c), dtype=np.float32)
    rng = np.random.default_rng(22)
    flow = rng.uniform(-2.5, 2.5, (1, fd, h, w, 3)).astype(np.float32)
    out = W3.warp3d_trilinear_plain(torch.from_numpy(src), torch.from_numpy(flow), d0)
    d_src, d_flow = W3.warp3d_trilinear_bwd_plain(torch.from_numpy(src), torch.from_numpy(flow),
                                                  torch.from_numpy(g), True, d0)
    assert d_src.shape == src.shape and d_flow.shape == flow.shape

    grid = np.stack(np.meshgrid(np.arange(fd), np.arange(h), np.arange(w), indexing="ij"), -1)
    coords = (grid[None] + flow).astype(np.float32)
    coords[..., 0] += d0
    cd, ch, cw = (jnp.asarray(coords[..., a]) for a in range(3))
    planes = jnp.asarray(src.transpose(0, 4, 1, 2, 3).reshape(c, sd, h, w))
    j_out = np.asarray(warp3d_planes_v3(planes, cd, ch, cw, c, True))
    j_out = j_out.reshape(1, c, fd, h, w).transpose(0, 2, 3, 4, 1)
    np.testing.assert_allclose(out.numpy(), j_out, rtol=0, atol=1e-5 * np.abs(src).max())
    gp = jnp.asarray(g.transpose(0, 4, 1, 2, 3).reshape(c, fd, h, w))
    j_df = np.stack([np.asarray(a) for a in warp3d_planes_v3_dflow(planes, cd, ch, cw, gp, c,
                                                                    True)], -1)
    np.testing.assert_allclose(d_flow.numpy(), j_df, rtol=0, atol=1e-5 * np.abs(j_df).max())

    _, vjp = jax.vjp(lambda s: warp_coords(s, jnp.asarray(coords.reshape(1, -1, 3)), (fd, h, w)),
                     jnp.asarray(src))
    (j_dsrc,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(d_src.numpy(), np.asarray(j_dsrc), rtol=0,
                               atol=1e-5 * np.abs(j_dsrc).max())
    # D-origin through autograd (the wrapper on CPU tensors) equals both
    st, ft = torch.from_numpy(src).requires_grad_(), torch.from_numpy(flow).requires_grad_()
    a_src, a_flow = torch.autograd.grad(W3.warp3d_trilinear(st, ft, d0), (st, ft),
                                        torch.from_numpy(g))
    np.testing.assert_allclose(a_src.numpy(), d_src.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(a_flow.numpy(), d_flow.numpy(), rtol=0,
                               atol=1e-5 * np.abs(j_df).max())
    with pytest.raises(ValueError, match="D-origin"):
        W3.warp3d_trilinear(torch.from_numpy(src[:, :, :-1]), torch.from_numpy(flow), d0)


def _compiled_sources():
    """Every file that `kernels/_build.py` and `native/__init__.py` compile,
    relative to the package."""
    from smilecode_tpu_torch import native
    from smilecode_tpu_torch.kernels import _build

    pkg = os.path.dirname(os.path.dirname(_build.__file__))
    files = [os.path.relpath(p, pkg) for p in _build._sources()]
    files.append(os.path.relpath(os.path.join(os.path.dirname(native.__file__), "preproc.cpp"),
                                 pkg))
    return sorted(files)


def test_the_wheel_holds_every_compiled_source(tmp_path):
    """A wheel built from the package's files (not an editable install)
    holds every source that the kernels' and the native library's builds
    compile at first use."""
    sources = _compiled_sources()
    assert "native/preproc.cpp" in sources and "csrc/attn_tile.cuh" in sources
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(os.path.join(REPO, "pyproject.toml"), src)
    ignore = shutil.ignore_patterns("_build", "__pycache__", "*.pyc", "*.so")
    for pkg in ("smilecode_tpu", "smilecode_tpu_torch"):
        shutil.copytree(os.path.join(REPO, pkg), src / pkg, ignore=ignore)
    out = subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps",
                          "--no-build-isolation", "--no-index", "-w", str(tmp_path / "dist"),
                          str(src)], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    (wheel,) = glob.glob(str(tmp_path / "dist" / "*.whl"))
    names = set(zipfile.ZipFile(wheel).namelist())
    missing = [f for f in sources if f"smilecode_tpu_torch/{f}" not in names]
    assert not missing, missing
