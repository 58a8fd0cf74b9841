"""The one launch path of every kernel wrapper, `kernels/_build.py:launch`,
on the CPU: a stub stands in for the ctypes kernel library (`_build._lib`)
and for PyTorch's current-device and raw-stream queries, which a CPU build
of PyTorch lacks. This file imports no jax."""

import collections
import contextlib

import numpy as np
import pytest
import torch

from smilecode_tpu_torch.kernels import _build, modet_attn, probes, warp3d

STREAM = 0x5EED  # the stub's raw stream handle


class StubFunction:
    """A C entry point: records its calls and each assignment of its
    ``argtypes``; returns the library's code."""

    def __init__(self, lib, name):
        self._lib, self._name, self.calls, self.restype = lib, name, [], None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self._lib.argtype_sets[self._name] += 1
        self._argtypes = value

    def __call__(self, *args):
        assert len(args) == len(self._argtypes)
        self.calls.append(args)
        return self._lib.code


class StubLibrary:
    """The kernel library: counts each lookup of an entry point by name."""

    def __init__(self, code=0):
        self.code, self.fns = code, {}
        self.lookups, self.argtype_sets = collections.Counter(), collections.Counter()

    def __getattr__(self, name):
        if not name.startswith("smilecode_"):
            raise AttributeError(name)
        self.lookups[name] += 1
        return self.fns.setdefault(name, StubFunction(self, name))

    def smilecode_error_string(self, code):
        return f"stub error {code}".encode()


class CudaStandIn:
    """What the launcher reads of a CUDA tensor: its device index."""

    def __init__(self, index=0):
        self.index = index
        self.device = f"cuda:{index}"

    def get_device(self):
        return self.index


@pytest.fixture()
def lib(monkeypatch):
    stub = StubLibrary()
    monkeypatch.setattr(_build, "_lib", stub)
    monkeypatch.setattr(_build, "_bound", {})
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: STREAM + index,
                        raising=False)
    guards = []

    @contextlib.contextmanager
    def device(index):
        guards.append(index)
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    stub.guards = guards
    return stub


ARGS_2 = [_build.ctypes.c_void_p, _build.ctypes.c_int, _build.ctypes.c_void_p]


def test_each_entry_is_looked_up_and_typed_once_over_many_calls(lib):
    t = CudaStandIn()
    for i in range(100):
        _build.launch("smilecode_a", ARGS_2, t, 16 * i, i, what="a")
        _build.launch("smilecode_b", ARGS_2[1:], t, i, what="b")
    assert lib.lookups == {"smilecode_a": 1, "smilecode_b": 1}
    assert lib.argtype_sets == {"smilecode_a": 1, "smilecode_b": 1}
    assert lib.fns["smilecode_a"].restype is _build.ctypes.c_int
    assert lib.fns["smilecode_a"].calls == [(16 * i, i, STREAM) for i in range(100)]
    assert len(lib.fns["smilecode_b"].calls) == 100
    assert lib.guards == []  # the tensor's device is the current one: no guard


def test_the_launcher_guards_only_another_device(lib, monkeypatch):
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 1)
    _build.launch("smilecode_a", ARGS_2, CudaStandIn(1), 0, 0, what="a")
    assert lib.guards == []
    _build.launch("smilecode_a", ARGS_2, CudaStandIn(0), 0, 0, what="a")
    assert lib.guards == [0]  # launched in card 0's context, on card 0's stream
    assert [c[-1] for c in lib.fns["smilecode_a"].calls] == [STREAM + 1, STREAM]


@pytest.mark.parametrize("code", [1, 700])
def test_the_launcher_raises_with_the_error_string(lib, code):
    lib.code = code
    with pytest.raises(RuntimeError, match=rf"^probe roll launch: CUDA error {code} "
                                           rf"\(stub error {code}\)$"):
        _build.launch("smilecode_a", ARGS_2, CudaStandIn(), 0, 0, what="probe roll launch")
    assert len(lib.fns["smilecode_a"].calls) == 1


def test_a_cpu_tensor_never_reaches_a_kernel(lib):
    with pytest.raises(ValueError, match="takes CUDA tensors, got cpu"):
        _build.launch("smilecode_a", ARGS_2, torch.zeros(3), 0, 0, what="a")
    assert not lib.lookups  # refused before the library is touched


def _wrapper_calls():
    """Every kernel wrapper on small CPU tensors (amounts and bounds as int32
    tensors on the CPU too): (name, call)."""
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, k, rpb = rand(1, 3, 3, 3, 2, 6), rand(1, 3, 3, 3, 2, 6), rand(2, 3, 3, 3)
    g = rand(1, 3, 3, 3, 6)
    src, flow = rand(1, 4, 4, 4, 2), rand(1, 4, 4, 4, 3)
    x, i32 = rand(5, 8), torch.tensor([2, 4], dtype=torch.int32)
    return [
        ("K1", lambda: modet_attn.modet_attention(q, k, rpb, 0.5)),
        ("K1 autograd", lambda: modet_attn.modet_attention(q.requires_grad_(), k, rpb).sum()
         .backward()),
        ("K3+K4", lambda: modet_attn.modet_attention_bwd(q.detach(), k, rpb, 0.5, g)),
        ("K2", lambda: warp3d.warp3d_trilinear(src, flow)),
        ("K2 origin", lambda: warp3d.warp3d_trilinear(src, flow, d0=0)),
        ("K5", lambda: warp3d.warp3d_trilinear_bwd(src, flow, torch.ones_like(src))),
        ("P1", lambda: probes.roll(x, i32[:1], 1)),
        ("P2", lambda: probes.row_window_sum(x, 3, 0, 1, i32)),
        ("P3", lambda: probes.affine(x, 2.0, 1.0)),
        ("P4", lambda: probes.floor_divmod(i32, 3)),
    ]


WRAPPER_CALLS = _wrapper_calls()


@pytest.mark.parametrize("name,call", WRAPPER_CALLS, ids=[n for n, _ in WRAPPER_CALLS])
def test_a_wrapper_given_cpu_tensors_runs_its_plain_version(monkeypatch, name, call):
    def refuse(*args, **kwargs):
        raise AssertionError(f"{name}: a CPU tensor reached the launcher")

    monkeypatch.setattr(_build, "launch", refuse)
    call()
