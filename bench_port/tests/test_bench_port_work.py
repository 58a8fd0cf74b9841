"""The benchmark's frozen yardstick (`bench_port.work`) against
`chip_smoke.py`'s, and the kernel calls counted on the reference against
the program's own launch counts, at the configurations' shapes."""

import importlib.util
import os

import pytest
import torch

from bench_port import harness, work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SIZE = (160, 192, 160)
HEADS = (8, 4, 2, 1, 1)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _level_shapes(size=SIZE):
    for level, heads in zip((5, 4, 3, 2, 1), HEADS):
        f = 2 ** (level - 1)
        yield (1, size[0] // f, size[1] // f, size[2] // f, heads, 6)


@pytest.mark.parametrize("kernel", ["K1", "K3", "K4"])
@pytest.mark.parametrize("isz", [4, 2])
def test_attention_work_is_chip_smokes(kernel, isz):
    cs = _chip_smoke()
    for shape in _level_shapes():
        assert work.attn_work(kernel, shape, isz) == cs.attn_work(kernel, shape, isz)
        assert work.attn_work(kernel, shape, isz, False) == cs.attn_work(kernel, shape, isz, False)


@pytest.mark.parametrize("kernel,scatter", [("K2", False), ("K5", False), ("K5", True)])
def test_warp_work_and_bound_are_chip_smokes(kernel, scatter):
    cs = _chip_smoke()
    for voxels, c in ((SIZE[0] * SIZE[1] * SIZE[2], 1), (80 * 96 * 80, 16), (20 * 24 * 20, 64)):
        got = work.warp_work(kernel, voxels, voxels, c, 4, scatter)
        assert got == cs.warp_work(kernel, voxels, voxels, c, 4, scatter)
        assert work.bound(*got) == cs.bound(*got)


def _calls(workload):
    bench = harness.load_benchmark()
    run = harness.Run(workload, 0, "cpu", bench)
    return harness.counted_work(run)


def _count(calls, kernel, **kw):
    return sum(c["kernel"] == kernel and all(c.get(k) == v for k, v in kw.items()) for c in calls)


def test_modet_counts_are_the_programs():
    """5 K1 and 9 K2 a pair; in a step also 5 K3, 5 K4 and 9 K5, 8 of them
    scattering (the moved image's source needs no gradient), as
    `chip_smoke.py` counts the program's launches."""
    reg = _calls("modet.register")["kernel_calls"]
    assert (_count(reg, "K1"), _count(reg, "K2"), _count(reg, "K5")) == (5, 9, 0)
    step = _calls("modet.train")
    calls = step["kernel_calls"]
    assert [_count(calls, k) for k in ("K1", "K3", "K4", "K2", "K5")] == [5, 5, 5, 9, 9]
    assert _count(calls, "K5", scatter=True) == 8
    shapes = sorted(c["shape"] for c in calls if c["kernel"] == "K1")
    assert shapes == sorted(_level_shapes())
    # convolutions forward and backward: at least the forward's, at most 3x it
    assert step["flops"] > 2 * _calls("modet.register")["flops"]


def test_rdn_counts_are_the_programs():
    calls = _calls("rdn.register")["kernel_calls"]
    assert _count(calls, "K2") == 136 and _count(calls, "K1") == 0


def test_kernel_names_are_in_the_sources():
    srcs = ""
    for name in os.listdir(os.path.join(ROOT, "smilecode_tpu_torch", "csrc")):
        with open(os.path.join(ROOT, "smilecode_tpu_torch", "csrc", name)) as f:
            srcs += f.read()
    for info in work.KERNELS.values():
        for g in info["globals"]:
            assert f"{g}(" in srcs, g


def test_counting_needs_no_real_tensors():
    before = torch.get_default_device() if hasattr(torch, "get_default_device") else None
    _calls("modet.train-half")
    after = torch.get_default_device() if hasattr(torch, "get_default_device") else None
    assert before == after
