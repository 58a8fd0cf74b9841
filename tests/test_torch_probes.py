"""The probe kernels' plain route vs the root probe scripts' own kernels.

Each of the 17 probe runs of `_probe_prims.py`, `_probe2.py`, `_probe3.py`
and `_probe4.py` (14 kernels; k1 with three amounts, k1b with two), through
the port's wrappers on CPU tensors (their plain versions), equals the
script's numpy ``want`` and the script's own kernel run by Pallas in
interpret mode on the script's inputs, exactly: the values are
integer-valued float32 (or int32), so there is no rounding to allow for.

The scripts call `pl.pallas_call` when imported, with no interpret flag,
which fails without a TPU. So they are not imported: their imports and the
``def`` nodes of the kernels are read with `ast` and executed into a
namespace, and each kernel is called through ``pl.pallas_call(...,
interpret=True)`` with the script's own operand memory spaces (SMEM
scalars, VMEM arrays). One shim: `pltpu.roll` of this JAX refuses a
negative static shift ("shift must be non-negative"), which k2 passes
(-3), so the namespace's `pltpu.roll` takes a static shift modulo the axis
length, the same rotation; traced shifts are passed on unchanged.
"""

import ast
import ctypes
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from smilecode_tpu_torch import probes
from smilecode_tpu_torch.kernels import probes as kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMEM = pl.BlockSpec(memory_space=pltpu.SMEM)
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


def _roll(x, shift, axis):
    if isinstance(shift, int):
        shift %= x.shape[axis]
    return pltpu.roll(x, shift, axis)


def load_kernels(script, names):
    """The script's imports and the ``def``s in ``names``, executed into a
    namespace whose `pltpu` takes a negative static roll shift."""
    path = os.path.join(ROOT, script)
    with open(path) as f:
        tree = ast.parse(f.read())
    keep = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))
            or (isinstance(n, ast.FunctionDef) and n.name in names)]
    assert {n.name for n in keep if isinstance(n, ast.FunctionDef)} == set(names)
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    ns["pltpu"] = types.SimpleNamespace(**{k: getattr(pltpu, k) for k in dir(pltpu)
                                           if not k.startswith("_")})
    ns["pltpu"].roll = _roll
    return ns


# per probe run: (script, kernel, extra defs, SMEM operands, X, output shape, output dtype)
F32, I32 = jnp.float32, jnp.int32
JAX_RUNS = {
    **{f"k1 amt={a}": ("_probe_prims.py", "k1", (), [[a]], "X32", (32, 128), F32)
       for a in (0, 3, 5)},
    **{f"k1b amt={a}": ("_probe_prims.py", "k1b", (), [[a]], "X32", (32, 128), F32)
       for a in (0, 7)},
    "k2": ("_probe_prims.py", "k2", (), [], "X32", (32, 128), F32),
    "k3": ("_probe_prims.py", "k3", (), [[2, 7]], "X32", (8, 128), F32),
    "k4": ("_probe2.py", "k4", (), [], "X64", (64, 128), F32),
    "k5": ("_probe2.py", "k5", (), [], "X64", (64, 128), F32),
    "k6": ("_probe2.py", "k6", (), [[-3]], None, (2,), I32),
    "k7": ("_probe2.py", "k7", (), [[1, 3]], "X64", (16, 128), F32),
    "k8a": ("_probe3.py", "k8a", ("body_roll",), [], "X64", (16, 128), F32),
    "k8b": ("_probe3.py", "k8b", (), [[1, 3]], "X64", (16, 128), F32),
    "k8d": ("_probe3.py", "k8d", ("body_roll",), [[1, 3]], "X64", (16, 128), F32),
    "k8e": ("_probe3.py", "k8e", (), [[1, 3]], "X64", (16, 128), F32),
    "k9": ("_probe4.py", "k9", (), [], "X64", (16, 128), F32),
    "k10": ("_probe4.py", "k10", (), [], "X64", (8, 128), F32),
}
RUNS = {probe.name: probe for probe in probes.PROBES}


def run_script_kernel(name, smem=None):
    """The script's kernel of probe run ``name`` in interpret mode, on the
    script's SMEM operands or on ``smem`` in their place."""
    script, kernel, extra, run_smem, x, shape, dtype = JAX_RUNS[name]
    smem = run_smem if smem is None else smem
    ns = load_kernels(script, (kernel, *extra))
    args = [jnp.asarray(v, jnp.int32) for v in smem]
    if x is not None:
        args.append(jnp.asarray(probes.XS[x]))
    kw = {}
    if smem:  # the script's specs: SMEM scalars, a VMEM array, the output in VMEM (k6: SMEM)
        kw = dict(in_specs=[SMEM] * len(smem) + [VMEM] * (x is not None),
                  out_specs=SMEM if x is None else VMEM)
    return np.asarray(pl.pallas_call(ns[kernel], out_shape=jax.ShapeDtypeStruct(shape, dtype),
                                     interpret=True, **kw)(*args))


def test_every_probe_run_has_a_script_kernel():
    assert set(RUNS) == set(JAX_RUNS) and len(RUNS) == 17
    assert {p.kernel for p in RUNS.values()} == {"P1", "P2", "P3", "P4"}
    assert all(p.where.startswith(JAX_RUNS[name][0]) for name, p in RUNS.items())


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_plain_route_equals_the_script(name):
    probe = RUNS[name]
    got = probes.run_probe(probe, "cpu").numpy()
    script = run_script_kernel(name)
    assert got.dtype == script.dtype and got.shape == probe.want.shape
    np.testing.assert_array_equal(got, probe.want)
    np.testing.assert_array_equal(got.reshape(script.shape), script)  # k6: (2, 1) vs (2,)


@pytest.mark.parametrize("m", [1, 3, 8])
def test_floor_divmod_plain_is_pythons(m):
    t = torch.arange(-20, 21, dtype=torch.int32)
    out = kernels.floor_divmod(t, m)
    assert out.dtype == torch.int32
    assert out.tolist() == [[(v // m) * m for v in range(-20, 21)], [v % m for v in range(-20, 21)]]


def test_wrappers_check_their_arguments():
    x = torch.zeros((4, 5))
    with pytest.raises(TypeError, match="float32"):
        kernels.roll(x.double(), 1, 0)
    with pytest.raises(ValueError, match="axis"):
        kernels.roll(x, 1, 2)
    with pytest.raises(TypeError, match="int32"):
        kernels.row_window_sum(x, 2, 0, 1, torch.tensor([0, 2]))
    with pytest.raises(ValueError, match="stride"):
        kernels.row_window_sum(x, 2, 0, 2, (0, 2))
    with pytest.raises(ZeroDivisionError):
        kernels.floor_divmod(torch.arange(3, dtype=torch.int32), 0)
    assert all(fn.launches == 0 for fn in kernels.KERNELS.values())  # CPU: the plain versions


def test_probes_main_runs_on_the_cpu(capsys):
    results = probes.main(device="cpu")
    assert len(results) == 17 and all(err == 0 for _, _, err in results)
    assert "17 probe runs on cpu: all exact" in capsys.readouterr().out


@pytest.mark.parametrize("case", [c for c in probes.EDGE_CASES if c.kernel in ("P1", "P3")],
                         ids=lambda c: c.id)
def test_p1_p3_edge_cases_match_numpy_on_the_cpu(case):
    """P1's and P3's edge cases (the card tests' and phase 25's table) through
    the wrappers on the CPU, the operand a view ``case.offset`` values into
    its buffer: equal to `np.roll` and to float32 ``alpha * x + beta``
    (product and sum each rounded), and to the case's recorded output."""
    x = probes.edge_operand(case, "cpu")
    if case.kernel == "P1":
        a, axis = case.args[0][0], case.args[1]
        got, want = kernels.roll(x, a, axis), np.roll(case.x, -a, axis)
    else:
        alpha, beta = case.args
        got = kernels.affine(x, alpha, beta)
        want = case.x * np.float32(alpha) + np.float32(beta)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, case.want)


def window_numpy(x, n, base, stride, bounds, weighted=False, bcast=False):
    """P2 as a float32 numpy loop over t in order: rows outside x add 0."""
    lo, hi = bounds
    acc = np.zeros((n, x.shape[1]), np.float32)
    r = np.zeros(n, np.int64) if bcast else np.arange(n)
    for t in range(lo, hi):
        rows = base + stride * t + r
        inside = (rows >= 0) & (rows < x.shape[0])
        v = np.where(inside[:, None], x[np.clip(rows, 0, x.shape[0] - 1)], np.float32(0))
        acc = acc + (v * np.float32(t) if weighted else v)
    return acc


def divmod_numpy(t, m):
    """P4 with Python's floor semantics in int64, row 0 wrapped to int32 as
    torch's and JAX's int32 products wrap."""
    t64 = t.astype(np.int64)
    prod = (t64 // m) * m
    return np.stack([(prod + 2 ** 31) % 2 ** 32 - 2 ** 31, t64 % m]).astype(np.int32)


@pytest.mark.parametrize("case", [c for c in probes.EDGE_CASES if c.kernel in ("P2", "P4")],
                         ids=lambda c: c.id)
def test_p2_p4_edge_cases_match_numpy_on_the_cpu(case):
    """P2's and P4's edge cases through the wrappers on the CPU, the operand
    a view ``case.offset`` values into its buffer: equal to a float32 numpy
    loop over t in order, and to ``(t // m) * m`` and ``t % m`` wrapped to
    int32, and to the case's recorded output."""
    x = probes.edge_operand(case, "cpu")
    if case.kernel == "P2":
        n, base, stride, bounds = case.args
        got = kernels.row_window_sum(x, n, base, stride, tuple(bounds), **case.kwargs)
        want = window_numpy(case.x, n, base, stride, bounds, **case.kwargs)
    else:
        (m,) = case.args
        got, want = kernels.floor_divmod(x, m), divmod_numpy(case.x, m)
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, case.want)


@pytest.mark.parametrize("v", probes.INT32_EXTREMES.tolist())
def test_k6_at_the_int32_extremes_equals_floor_divmod_plain(v):
    """The script's k6 (m = 8) in Pallas interpret mode on one int32 extreme:
    equal to `floor_divmod_plain` and to Python's floor division."""
    script = run_script_kernel("k6", smem=[[v]])
    got = kernels.floor_divmod_plain(torch.tensor([v], dtype=torch.int32), 8).reshape(2)
    np.testing.assert_array_equal(script, got.numpy())
    np.testing.assert_array_equal(script, divmod_numpy(np.array([v], np.int32), 8).reshape(2))


def test_the_c_int_helper_takes_every_int32_and_refuses_the_rest():
    kernels._c_ints("w", "a b c", 2 ** 31 - 1, -2 ** 31, 0)
    for v in (2 ** 31, 2 ** 32 + 3, -2 ** 31 - 1):
        with pytest.raises(ValueError, match=rf"^w: size = {v} does not fit"):
            kernels._c_ints("w", "a size", 0, v)


BIG = 2 ** 31
# (kernel, the size or value that goes past a C int, the wrapper call on a
# meta tensor: shapes without storage)
REFUSED = [
    ("P1", "rows", lambda: kernels.roll(torch.empty((BIG, 1), device="meta"), 1, 0)),
    ("P1", "cols", lambda: kernels.roll(torch.empty((1, BIG), device="meta"), 1, 1)),
    ("P1", "amount", lambda: kernels.roll(torch.empty((2, 3), device="meta"), BIG + 5, 1)),
    ("P2", "rows", lambda: kernels.row_window_sum(torch.empty((BIG, 1), device="meta"), 2, 0,
                                                  1, (0, 2))),
    ("P2", "cols", lambda: kernels.row_window_sum(torch.empty((1, BIG), device="meta"), 2, 0,
                                                  1, (0, 2))),
    ("P2", "n", lambda: kernels.row_window_sum(torch.empty((4, 3), device="meta"), BIG, 0, 1,
                                               (0, 2))),
    ("P2", "base", lambda: kernels.row_window_sum(torch.empty((4, 3), device="meta"), 2, -BIG - 1,
                                                  1, (0, 2))),
    ("P2", "hi", lambda: kernels.row_window_sum(torch.empty((4, 3), device="meta"), 2, 0, 1,
                                                (0, BIG))),
    ("P4", "m", lambda: kernels.floor_divmod(torch.empty(5, dtype=torch.int32, device="meta"),
                                             2 ** 32 + 3)),
]


def _pretend_on_card(monkeypatch):
    """The wrappers' checks as for a tensor on the card (a meta tensor
    stands in for it); every call of `_c_ints` recorded; the launcher
    refusing to be reached."""
    calls = []

    def kernel_ints(what, x, dtype, ndim, ints=None, n=0):
        assert x.dtype == dtype and x.dim() == ndim
        if isinstance(ints, torch.Tensor):
            return ints.data_ptr(), (0,) * n
        vals = (ints,) if n == 1 else tuple(ints or ())
        return None, tuple(int(a) for a in vals)

    def c_ints(what, names, *ints):
        calls.append(dict(zip(names.split(), ints)))
        return C_INTS(what, names, *ints)

    def launch(name, argtypes, t, *args, what):
        raise AssertionError(f"{what}: a size past a C int reached the launcher")

    monkeypatch.setattr(kernels, "_kernel_ints", kernel_ints)
    monkeypatch.setattr(kernels, "_c_ints", c_ints)
    monkeypatch.setattr(kernels._build, "launch", launch)
    return calls


C_INTS = kernels._c_ints


@pytest.mark.parametrize("kernel,name,call", REFUSED, ids=[f"{k}-{n}" for k, n, _ in REFUSED])
def test_probe_wrappers_refuse_sizes_a_c_int_cannot_hold(monkeypatch, kernel, name, call):
    """Each probe wrapper, given a size or value that would reach its
    kernel as a wrapped C ``int``, raises `ValueError` through `_c_ints`
    before it allocates or launches."""
    calls = _pretend_on_card(monkeypatch)
    with pytest.raises(ValueError, match=rf": {name} = -?\d+ does not fit"):
        call()
    assert len(calls) == 1 and name in calls[0]
    assert kernels.KERNELS[kernel].launches == 0


@pytest.mark.parametrize("stride", [0, 1])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("bcast", [False, True])
def test_p2_wrapper_packs_its_instance_into_flags(monkeypatch, stride, weighted, bcast):
    """P2's entry point takes 11 arguments: (stride, weighted, bcast) go as
    one ``flags`` int, stride | 2 weighted | 4 bcast; by-value bounds with
    a null pointer, device bounds as the pointer with 0s."""
    _pretend_on_card(monkeypatch)
    seen = []
    monkeypatch.setattr(kernels._build, "launch",
                        lambda name, argtypes, t, *args, what: seen.append((name, argtypes, args)))
    x = torch.zeros((7, 5))
    bounds = torch.tensor([-1, 3], dtype=torch.int32)
    for b in ((-1, 3), bounds):
        out = kernels.row_window_sum(x, 4, 2, stride, b, weighted=weighted, bcast=bcast)
        assert out.shape == (4, 5)
    flags = stride + 2 * weighted + 4 * bcast
    for (name, argtypes, args), ptr in zip(seen, (None, bounds.data_ptr())):
        assert name == "smilecode_probe_row_window" and len(argtypes) == 11
        assert len(args) == len(argtypes) - 1  # the launcher adds the stream
        assert args[2:] == (7, 5, 4, 2, flags, ptr) + ((-1, 3) if ptr is None else (0, 0))


def test_p4_wrapper_passes_its_count_as_a_long_long(monkeypatch):
    _pretend_on_card(monkeypatch)
    seen = []
    monkeypatch.setattr(kernels._build, "launch",
                        lambda name, argtypes, t, *args, what: seen.append((argtypes, args)))
    t = torch.arange(-5, 6, dtype=torch.int32)
    kernels.floor_divmod(t, -3)
    ((argtypes, args),) = seen
    assert argtypes[2] is ctypes.c_longlong and args[2:] == (11, -3)
