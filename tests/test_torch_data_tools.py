"""The port's data tools and API-parity ops vs the JAX package.

* `data.trans_ext` and `data.rand`: each transform of the zoo, built alike
  in both packages, with Python's `random` and `np.random` seeded alike
  before each package's call: equal arrays, dtypes and shapes.
* `data.preprocess`: `make_pkl_dataset` on synthetic Analyze subjects
  (little- and big-endian headers, ``.hdr`` and ``.hdr.gz``, odd grids)
  writes the JAX package's pkls, array for array and dtype for dtype.
* `native`: equal to its numpy versions and to the JAX package's `native`,
  exactly, dtype branches included; a failed build raises naming g++; a
  concurrent build from several processes and threads. Skipped where there
  is no g++.
* `ops.resize_flow` and `ops.blocks.UpConvBlock`/`DeconvBlock` (through
  the converters) against the JAX functions and flax modules, 1e-6 and
  1e-5 relative (float32 in another order).
* `utils.profiling` on the CPU.
"""

import gzip
import os
import random
import shutil
import struct
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smilecode_tpu import native as jax_native
from smilecode_tpu.data import preprocess as jax_pre
from smilecode_tpu.data import rand as jax_rand
from smilecode_tpu.data import trans_ext as jax_ext
from smilecode_tpu.metrics import dice_val_voi_np as jax_dice_np
from smilecode_tpu.ops import blocks as jax_blocks
from smilecode_tpu.ops.resize import resize_flow as jax_resize_flow
from smilecode_tpu_torch import native
from smilecode_tpu_torch.convert import params_from_state_dict, state_dict_from_jax
from smilecode_tpu_torch.data import datasets, preprocess, rand, trans, trans_ext
from smilecode_tpu_torch.metrics import dice_val_voi_np
from smilecode_tpu_torch.ops.blocks import DeconvBlock, UpConvBlock
from smilecode_tpu_torch.ops.resize import resize_flow
from smilecode_tpu_torch.utils.profiling import StepTimer, memory_stats, trace

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ trans_ext

def _pair(seed=0):
    """A (1, D, H, W, 2) image in [0, 1) and (1, D, H, W) raw LPBA labels."""
    rng = np.random.default_rng(seed)
    img = rng.random((1, 12, 14, 11, 2)).astype(np.float32)
    seg = rng.choice(trans.LPBA_SEG_TABLE, (1, 12, 14, 11)).astype(np.uint16)
    return img, seg


# (case, constructor args given each package's module): every transform of
# the zoo, the samplers it draws from, and the protocol classes they share
TRANSFORMS = {
    "Identity": lambda m, r: m.Identity(),
    "Rot90": lambda m, r: m.Rot90(axes=(1, 3)),
    "RandomRotion": lambda m, r: m.RandomRotion(10),
    "Flip": lambda m, r: m.Flip(2),
    "RandomFlip": lambda m, r: m.RandomFlip(),
    "RandSelect": lambda m, r: m.RandSelect(0.5, [m.Flip(1), m.Rot90((1, 2))]),
    "CenterCrop": lambda m, r: m.CenterCrop(8),
    "CenterCropBySize": lambda m, r: m.CenterCropBySize((8, 10, 6)),
    "RandCrop": lambda m, r: m.RandCrop(8),
    "RandCrop3D": lambda m, r: m.RandCrop3D((8, 10, 6)),
    "RandomIntensityChange": lambda m, r: m.RandomIntensityChange((0.1, 0.2)),
    "RandomGammaCorrection": lambda m, r: m.RandomGammaCorrection((0.6, 1.6)),
    "MinMax_norm": lambda m, r: m.MinMax_norm(),
    "Seg_norm_7regions_FAIM": lambda m, r: m.Seg_norm_7regions_FAIM(),
    "Resize_img": lambda m, r: m.Resize_img((9, 16, 8)),
    "Pad": lambda m, r: m.Pad((0, 2, 1, 3, 0)),
    "Pad3DIfNeeded": lambda m, r: m.Pad3DIfNeeded((15, 14, 16), mask_value=3),
    "Noise": lambda m, r: m.Noise(3, sigma=0.2),
    "GaussianBlur": lambda m, r: m.GaussianBlur(3, sigma=r.Uniform(0.5, 1.5)),
    "GaussianBlur(Gaussian, app)": lambda m, r: m.GaussianBlur(3, r.Gaussian(1.0, 0.3), app=1),
    "Normalize": lambda m, r: m.Normalize(0.25, 2.0),
    "Seg_norm": lambda m, r: m.Seg_norm(),
    "Compose": lambda m, r: m.Compose([m.RandCrop3D((8, 10, 6)), m.RandomFlip(), m.Seg_norm(),
                                       m.NumpyType((np.float32, np.int16))]),
}


def _apply(make, module, rand_module, seed):
    random.seed(seed)
    np.random.seed(seed)
    t = make(module, rand_module)
    img, seg = _pair(seed)
    out = t([img, seg])
    return out, str(t)


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax_under_the_same_seeds(name, request):
    if name in ("Seg_norm", "Compose"):  # `native.seg_remap`
        request.getfixturevalue("gxx")
    make = TRANSFORMS[name]
    for seed in (3, 11):
        got, got_str = _apply(make, trans_ext, rand, seed)
        want, want_str = _apply(make, jax_ext, jax_rand, seed)
        assert got_str == want_str
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_samplers_match_jax_and_the_zoo_takes_the_port_protocol():
    for cls in ("Uniform", "Gaussian", "Constant"):
        random.seed(5)
        a = getattr(rand, cls)(0.5, 2.0).sample() if cls != "Constant" else rand.Constant(3).sample()
        random.seed(5)
        b = (getattr(jax_rand, cls)(0.5, 2.0).sample() if cls != "Constant"
             else jax_rand.Constant(3).sample())
        assert a == b
    assert trans_ext.Base is trans.Base and trans_ext.Compose is trans.Compose
    assert trans_ext.Seg_norm is trans.Seg_norm and trans_ext.Uniform is rand.Uniform


# ------------------------------------------------------------ preprocess

def write_analyze(dirpath, name, vol, endian="<", hdr_gz=False, img_gz=True):
    """An Analyze 7.5 .hdr[.gz] + .img[.gz] pair; ``vol`` indexed (z, y, x)
    is the buffer, x fastest."""
    dz, dy, dx = vol.shape
    hdr = bytearray(348)
    struct.pack_into(endian + "i", hdr, 0, 348)
    struct.pack_into(endian + "4h", hdr, 40, 3, dx, dy, dz)
    datatype = {np.dtype("uint8"): 2, np.dtype("int16"): 4, np.dtype("int32"): 8,
                np.dtype("float32"): 16, np.dtype("float64"): 64}[vol.dtype]
    struct.pack_into(endian + "h", hdr, 70, datatype)
    hdr_path = os.path.join(dirpath, name + ".hdr" + (".gz" if hdr_gz else ""))
    with (gzip.open if hdr_gz else open)(hdr_path, "wb") as f:
        f.write(bytes(hdr))
    img_path = os.path.join(dirpath, name + ".img" + (".gz" if img_gz else ""))
    with (gzip.open if img_gz else open)(img_path, "wb") as f:
        f.write(vol.astype(vol.dtype.newbyteorder(endian)).tobytes())
    return img_path


def raw_subject(shape, seed, img_dtype):
    rng = np.random.default_rng(seed)
    img = np.zeros(shape, np.float64)
    lo = [s // 6 for s in shape]
    hi = [s - s // 5 for s in shape]
    box = tuple(slice(a, b) for a, b in zip(lo, hi))
    img[box] = 40 + 60 * rng.random([b - a for a, b in zip(lo, hi)])
    lbl = np.where(img > 0, rng.choice(trans.LPBA_SEG_TABLE[1:], shape), 0)
    return img.astype(img_dtype), lbl.astype(np.int16)


# (subject name, grid, image dtype, header endianness, header gzipped)
SUBJECTS = [("S01", (21, 27, 19), np.int16, "<", False),
            ("S02", (23, 26, 25), np.float32, ">", True),
            ("S10", (20, 25, 17), np.uint8, ">", False)]


def test_make_pkl_dataset_matches_jax(tmp_path):
    raw = tmp_path / "raw"
    for i, (name, shape, dtype, endian, hdr_gz) in enumerate(SUBJECTS):
        sub = raw / name
        sub.mkdir(parents=True)
        img, lbl = raw_subject(shape, i, dtype)
        write_analyze(str(sub), f"{name}.skullstripped", img, endian, hdr_gz)
        write_analyze(str(sub), f"{name}.label", lbl, endian, hdr_gz)
    shape = (16, 20, 14)
    preprocess.make_pkl_dataset(str(raw), str(tmp_path / "port"), shape=shape, verbose=False)
    jax_pre.make_pkl_dataset(str(raw), str(tmp_path / "jax"), shape=shape, verbose=False)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "subject_01.pkl", "subject_02.pkl", "subject_03.pkl"]
    for name in names:
        got = datasets.pkload(str(tmp_path / "port" / name))
        want = datasets.pkload(str(tmp_path / "jax" / name))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape == shape
            np.testing.assert_array_equal(g, w)
        img, lbl = got
        assert img.dtype == np.float32 and img.min() == 0.0 and img.max() == 1.0
        assert lbl.dtype == np.uint16 and lbl.max() > 0


@pytest.mark.parametrize("endian,hdr_gz,img_gz", [("<", False, False), (">", True, False),
                                                  (">", False, True), ("<", True, True)])
def test_analyze_reader_matches_jax(tmp_path, endian, hdr_gz, img_gz):
    rng = np.random.default_rng(7)
    vol = rng.standard_normal((5, 7, 11)).astype(np.float32)
    vol[1, 2, 3] = -99.0
    path = write_analyze(str(tmp_path), "toy", vol, endian, hdr_gz, img_gz)
    got = preprocess._read_analyze_img_gz(path)
    want = jax_pre._read_analyze_img_gz(path)
    assert got.shape == want.shape == vol.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, vol)
    np.testing.assert_array_equal(got, want)


def test_center_crop_and_minmax_match_jax():
    img, lbl = raw_subject((21, 27, 19), 4, np.int16)
    np.testing.assert_array_equal(preprocess.center(img), jax_pre.center(img))
    for c in ((2, 3, 2), (20, 26, 18), preprocess.center(img)):
        np.testing.assert_array_equal(preprocess.crop_by_center(img, c, (8, 10, 6)),
                                      jax_pre.crop_by_center(img, c, (8, 10, 6)))
    got = preprocess.process_subject(img, lbl, (8, 10, 6))
    want = jax_pre.process_subject(img, lbl, (8, 10, 6))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert preprocess.natsort_key("S10") > preprocess.natsort_key("S9")


# ------------------------------------------------------------ native

@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++: native builds preproc.cpp with g++")


def _labels(rng, shape):
    seg = rng.choice(trans.LPBA_SEG_TABLE, shape).astype(np.uint16)
    seg.reshape(-1)[:3] = (999, 7, 65535)  # not in the table: 0
    return seg


def test_seg_remap_matches_numpy_and_jax(gxx):
    rng = np.random.default_rng(13)
    table = trans.LPBA_SEG_TABLE
    seg = _labels(rng, (20, 23, 21))
    want = trans.seg_remap(seg, table)
    loop = np.zeros_like(seg)
    for i, lbl in enumerate(table):
        loop[seg == lbl] = i
    np.testing.assert_array_equal(want, loop)
    for got in (native.seg_remap(seg, table), trans.Seg_norm().tf(seg, k=1),
                native.seg_remap(seg[:, ::2].transpose(2, 0, 1), table)):
        assert got.dtype == np.uint16
    np.testing.assert_array_equal(native.seg_remap(seg, table), want)
    np.testing.assert_array_equal(native.seg_remap(seg, table), jax_native.seg_remap(seg, table))
    view = seg[:, ::2].transpose(2, 0, 1)  # not contiguous
    np.testing.assert_array_equal(native.seg_remap(view, table), trans.seg_remap(view, table))
    for dtype in (np.int16, np.int32, np.uint8):  # the numpy branch
        s = (seg % 200).astype(dtype)
        got = native.seg_remap(s, table)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, trans.seg_remap(s, table))
        np.testing.assert_array_equal(got, jax_native.seg_remap(s, table))


def test_minmax_normalize_matches_numpy_and_jax(gxx):
    rng = np.random.default_rng(14)
    img = (rng.random((17, 18, 19)) * 300 - 90).astype(np.float32)
    got = native.minmax_normalize(img)
    assert got.dtype == np.float32 and got.min() == 0.0 and got.max() == 1.0
    np.testing.assert_array_equal(got, native.minmax_normalize_np(img))
    np.testing.assert_array_equal(got, jax_native.minmax_normalize(img))
    np.testing.assert_allclose(got, (img - img.min()) / (img.max() - img.min()), atol=1e-7)
    for other in (img.astype(np.float64), (img * 10).astype(np.int16)):  # the numpy branch
        got = native.minmax_normalize(other)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, native.minmax_normalize_np(other))
        np.testing.assert_allclose(got, jax_native.minmax_normalize(other), rtol=0, atol=1e-7)


@pytest.mark.parametrize("shape", [(17, 16, 15), (1, 2, 3), (9, 9, 9)])
def test_halfres_matches_numpy_and_jax(gxx, shape):
    rng = np.random.default_rng(15)
    for dtype in (np.float32, np.uint16, np.float64, np.int16):
        vol = (rng.random(shape) * 500).astype(dtype)
        got = native.halfres(vol)
        assert got.dtype == dtype and got.flags.c_contiguous
        np.testing.assert_array_equal(got, datasets.halfres(vol))
        np.testing.assert_array_equal(got, jax_native.halfres(vol))
    vol4 = rng.random((1, *shape)).astype(np.float32)  # not 3-D: numpy
    np.testing.assert_array_equal(native.halfres(vol4), vol4[::2, ::2, ::2])


def test_dice_counts_match_numpy_and_jax(gxx):
    rng = np.random.default_rng(16)
    pred = rng.integers(0, 60, (24, 25, 23)).astype(np.uint16)  # ids >= 55 count nowhere
    true = rng.integers(0, 60, (24, 25, 23)).astype(np.uint16)
    true[:4] = pred[:4]
    inter, pc, tc = native.dice_counts(pred, true, 55)
    for lbl in (0, 1, 30, 54):
        assert inter[lbl] == np.sum((pred == lbl) & (true == lbl))
        assert pc[lbl] == np.sum(pred == lbl) and tc[lbl] == np.sum(true == lbl)
    for g, w in zip((inter, pc, tc), jax_native.dice_counts(pred, true, 55)):
        np.testing.assert_array_equal(g, w)
    fast = native.dice_val_voi_native(pred, true)
    assert fast == jax_native.dice_val_voi_native(pred, true)
    np.testing.assert_allclose(fast, dice_val_voi_np(pred, true), rtol=1e-12)
    assert dice_val_voi_np(pred, true) == jax_dice_np(pred, true)
    with pytest.raises(ValueError, match="differ in size"):
        native.dice_counts(pred, true[:-1], 55)


def test_a_failed_build_raises_naming_gxx(gxx, tmp_path, monkeypatch):
    bad = tmp_path / "preproc.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        native.halfres(np.zeros((4, 4, 4), np.float32))
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        native.seg_remap(np.zeros((2, 2, 2), np.uint16), trans.LPBA_SEG_TABLE)


_BUILD = r"""
import sys
import numpy as np
from smilecode_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
vol = np.arange(4 * 5 * 6, dtype=np.float32).reshape(4, 5, 6)
print(native.library_path().startswith(sys.argv[1]), float(native.halfres(vol).sum()))
"""


def test_processes_and_threads_building_at_once(gxx, tmp_path):
    """Four processes build into one empty directory at once (each writes
    its own temporary file, then renames it): every one loads a whole
    library. Then 16 threads of one process call the kernels at once, as
    the loader's workers do, one OpenMP thread each."""
    build = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, build], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    want = float(np.arange(120, dtype=np.float32).reshape(4, 5, 6)[::2, ::2, ::2].sum())
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["True", str(want)]
    assert [f for f in os.listdir(build) if f.endswith(".so")] == [
        os.path.basename(native.library_path())]
    assert not [f for f in os.listdir(build) if f.endswith(".tmp")]

    rng = np.random.default_rng(17)
    segs = [_labels(rng, (16, 18, 17)) for _ in range(16)]
    with ThreadPoolExecutor(max_workers=16) as pool:
        got = list(pool.map(lambda s: native.seg_remap(s, trans.LPBA_SEG_TABLE), segs))
    for g, s in zip(got, segs):
        np.testing.assert_array_equal(g, trans.seg_remap(s, trans.LPBA_SEG_TABLE))


# ------------------------------------------------------------ ops

@pytest.mark.parametrize("factor", [0.5, 1, 2, 1.5, 0.75])
def test_resize_flow_matches_jax(factor):
    x = (np.random.default_rng(18).standard_normal((1, 8, 9, 10, 3)) * 4).astype(np.float32)
    got = resize_flow(torch.from_numpy(x), factor).numpy()
    want = np.asarray(jax_resize_flow(jnp.asarray(x), factor))
    assert got.shape == want.shape == (1, int(8 * factor), int(9 * factor), int(10 * factor), 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if factor == 1:
        np.testing.assert_array_equal(got, x)


def _flax_params(module, seed, *inputs):
    return module.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs))


@pytest.mark.parametrize("cin,cout", [(6, 5), (4, 4)])
def test_upconv_block_matches_flax_through_the_converters(cin, cout):
    """ConvTranspose3d(k4, s2), crop, IN, LeakyReLU; Cin == Cout is the
    square kernel whose layout the converters take from the module type."""
    x = np.random.default_rng(19).standard_normal((1, 3, 4, 5, cin)).astype(np.float32)
    params = _flax_params(jax_blocks.UpConvBlock(cout), 20, x)
    want = np.asarray(jax_blocks.UpConvBlock(cout).apply(params, jnp.asarray(x)))
    block = UpConvBlock(cin, cout)
    params = jax.tree.map(np.array, params)
    block.load_state_dict(state_dict_from_jax(params, block), strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 6, 8, 10, cout)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    back = params_from_state_dict(block.state_dict(), block)["params"]
    np.testing.assert_array_equal(back["upconv"]["kernel"], params["params"]["upconv"]["kernel"])


def test_deconv_block_matches_flax_through_the_converters():
    rng = np.random.default_rng(21)
    dec = rng.standard_normal((1, 3, 4, 5, 8)).astype(np.float32)
    skip = rng.standard_normal((1, 6, 8, 10, 4)).astype(np.float32)
    module = jax_blocks.DeconvBlock(4)
    params = jax.tree.map(np.array, _flax_params(module, 22, dec, skip))
    want = np.asarray(module.apply(params, jnp.asarray(dec), jnp.asarray(skip)))
    block = DeconvBlock(8, 4)
    sd = state_dict_from_jax(params, block)
    assert sorted(sd) == sorted(block.state_dict())
    block.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(dec), torch.from_numpy(skip)).numpy()
    assert got.shape == want.shape == (1, 6, 8, 10, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    back = params_from_state_dict(block.state_dict(), block)["params"]
    assert jax.tree.structure(back) == jax.tree.structure(params["params"])


# ------------------------------------------------------------ profiling

def test_step_timer_memory_stats_and_trace_on_the_cpu(tmp_path):
    timer = StepTimer()
    assert timer.median_ms == 0.0
    for _ in range(3):
        timer.start()
        out = {"loss": torch.ones(3).sum(), "more": [torch.zeros(2), (1, "x")]}
        assert timer.stop(out) >= 0.0
    timer.start()
    timer.stop()
    assert len(timer.times_ms) == 4 and timer.median_ms == float(np.median(timer.times_ms))
    assert memory_stats("cpu") == {} and memory_stats(torch.device("cpu")) == {}
    with trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "aten::matmul" for e in prof.key_averages())
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
