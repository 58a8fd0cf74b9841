"""The port's spans (`utils.profiling.span`): off without a profiler, named
and nested as the layers are under one, on the profiler's clock.

Imports no jax; the test marked ``cuda`` runs on the card with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_tracing.py
"""

import collections

import numpy as np
import pytest
import torch

from smilecode_tpu_torch import infer, train
from smilecode_tpu_torch.data import Loader
from smilecode_tpu_torch.kernels import launch_counters
from smilecode_tpu_torch.kernels.modet_attn import (
    modet_attention,
    modet_attention_bwd_dk,
    modet_attention_bwd_dq,
)
from smilecode_tpu_torch.kernels.warp3d import warp3d_trilinear, warp3d_trilinear_bwd
from smilecode_tpu_torch.models import ModeT
from smilecode_tpu_torch.models.registry import loss_plan
from smilecode_tpu_torch.optim import AMSGrad
from smilecode_tpu_torch.utils import profiling

SHAPE = (16, 16, 16)  # the smallest volume ModeT's four downsamplings take


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


class Pairs:
    def __len__(self):
        return 5

    def __getitem__(self, i):
        return (np.full((1, 2, 3, 2), i, np.float32), np.full((1, 2, 3, 2), -i, np.int16))


@pytest.fixture(scope="module")
def steps():
    """A training step and an infer step of one small ModeT, and a pair."""
    gen = torch.Generator().manual_seed(5)
    x, y = torch.rand((1, *SHAPE, 1), generator=gen), torch.rand((1, *SHAPE, 1), generator=gen)
    seg = torch.randint(0, 4, (1, *SHAPE, 1), generator=gen).to(torch.int16)
    model = ModeT(qk_scale=1.0, generator=torch.Generator().manual_seed(6))
    step = train.make_train_step(model, loss_plan("modet"), AMSGrad(model.parameters(), lr=1e-3),
                                 (1.0, 1.0))
    return model, step, infer.make_infer_step(model), (x, y, seg, seg)


def children(log, index):
    return [s.name for s in log if s.parent == index]


@pytest.mark.parametrize("num_workers", [0, 2])
def test_nothing_is_logged_without_a_profiler(steps, num_workers):
    model, step, infer_step, (x, y, xs, ys) = steps
    profiling.reset()
    assert len(list(Loader(Pairs(), batch_size=2, num_workers=num_workers))) == 3
    step(x, y)
    infer_step(x, y, xs, ys)
    assert profiling.spans() == []


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_spans_nest_under_a_profiler(num_workers):
    profiling.reset()
    with profiled():
        batches = list(Loader(Pairs(), batch_size=2, num_workers=num_workers))
    log = profiling.spans()
    nexts = [i for i, s in enumerate(log) if s.name == "loader.next"]
    assert len(nexts) == len(batches) == 3
    inner = "loader.build" if num_workers == 0 else "loader.wait"
    for i in nexts:
        assert log[i].parent == -1
        assert children(log, i) == [inner, "loader.copy"]
    assert collections.Counter(s.name for s in log) == {"loader.next": 3, inner: 3,
                                                        "loader.copy": 3}


def test_step_spans_nest_under_a_profiler(steps):
    model, step, infer_step, (x, y, xs, ys) = steps
    profiling.reset()
    with profiled():
        model.train()
        step(x, y)
        model.eval()
        infer_step(x, y, xs, ys)
    log = profiling.spans()
    roots = [(i, s.name) for i, s in enumerate(log) if s.parent == -1]
    assert [name for _, name in roots] == ["train.step", "infer.step"]
    (t, _), (f, _) = roots
    assert children(log, t) == ["train.forward", "train.loss", "train.backward",
                                "train.optimizer"]
    assert children(log, f) == ["infer.forward", "infer.score"]
    for s in log:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent >= 0:
            parent = log[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
            assert parent.thread == s.thread
    # the attention and the feature warps of each forward, through the K1 and K2 wrappers
    for forward in ("train.forward", "infer.forward"):
        i = next(i for i, s in enumerate(log) if s.name == forward)
        assert collections.Counter(children(log, i)) == {"kernel.K1": 5, "kernel.K2": 9}


def _k1():
    q, k = torch.rand(1, 3, 4, 3, 2, 6), torch.rand(1, 3, 4, 3, 2, 6)
    modet_attention(q, k, torch.rand(2, 3, 3, 3), 1.0)


def _k2():
    warp3d_trilinear(torch.rand(1, 3, 4, 3, 2), torch.rand(1, 3, 4, 3, 3))


def _k3():
    q, k, g = torch.rand(1, 3, 4, 3, 2, 6), torch.rand(1, 3, 4, 3, 2, 6), torch.rand(1, 3, 4, 3, 6)
    with pytest.raises(ValueError, match="CUDA"):  # K3 has no plain path: the card alone
        modet_attention_bwd_dq(q, k, torch.rand(2, 3, 3, 3), 1.0, g)


def _k4():
    q, dl = torch.rand(1, 3, 4, 3, 2, 6), torch.rand(1, 3, 4, 3, 2, 27)
    with pytest.raises(ValueError, match="modet_attention_bwd_dk"):  # the card alone
        modet_attention_bwd_dk(q, dl, 1.0)


def _k5():
    src = torch.rand(1, 3, 4, 3, 2)
    warp3d_trilinear_bwd(src, torch.rand(1, 3, 4, 3, 3), torch.rand(1, 3, 4, 3, 2))


@pytest.mark.parametrize("kernel,call", [("K1", _k1), ("K2", _k2), ("K3", _k3), ("K4", _k4),
                                         ("K5", _k5)])
def test_each_kernel_wrapper_call_logs_one_span(kernel, call):
    """On the CPU K1, K2 and K5 take their plain versions, and K3 and K4,
    which have none, refuse the tensors: each call is one span all the
    same, on or off the card."""
    profiling.reset()
    call()
    assert profiling.spans() == []
    with profiled():
        call()
        call()
    assert [s.name for s in profiling.spans()] == [f"kernel.{kernel}"] * 2
    assert all(s.parent == -1 and s.end_ns >= s.start_ns for s in profiling.spans())


def test_the_log_and_the_trace_share_a_clock():
    """Each span is a `record_function` of its name, and the log stamps it
    on the profiler's clock (Unix-epoch ns)."""
    profiling.reset()
    with profiled() as prof:
        for _ in range(200):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    torch.ones(8) + 1
    log = profiling.spans()
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name() in ("outer", "inner"):
            events[e.name()].append(e.start_ns())
    offsets = []
    for name in ("outer", "inner"):
        mine = sorted(s.start_ns for s in log if s.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs) == 200
        offsets += [abs(a - b) for a, b in zip(mine, theirs)]
    assert np.median(offsets) <= 50_000


def test_trace_empties_the_log(tmp_path):
    profiling.reset()
    with profiled():
        with profiling.span("before"):
            pass
    assert [s.name for s in profiling.spans()] == ["before"]
    with profiling.trace(str(tmp_path / "trace")):
        assert profiling.spans() == []
        with profiling.span("inside"):
            pass
    assert [s.name for s in profiling.spans()] == ["inside"]


@pytest.mark.cuda
def test_kernel_spans_count_the_launches_on_the_card():
    """On the card: one ``kernel.K*`` span per launch of K1-K6 and K8 in a ModeT
    training step and an infer step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    x, y = (torch.rand((1, 32, 32, 32, 1), generator=gen).to(dev) for _ in range(2))
    seg = torch.randint(0, 4, (1, 32, 32, 32, 1), generator=gen).to(torch.int16).to(dev)
    model = ModeT(qk_scale=1.0, generator=torch.Generator().manual_seed(8)).to(dev)
    step = train.make_train_step(model, loss_plan("modet"), AMSGrad(model.parameters(), lr=1e-3),
                                 (1.0, 1.0))
    infer_step = infer.make_infer_step(model)
    step(x, y)  # the kernels' build
    profiling.reset()
    before = launch_counters()
    with profiled():
        model.train()
        step(x, y)
        model.eval()
        infer_step(x, y, seg, seg)
        torch.cuda.synchronize()
    after = launch_counters()
    spans = collections.Counter(s.name for s in profiling.spans())
    for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K8"):
        grew = after[f"{k} launches"] - before[f"{k} launches"]
        assert grew > 0 and spans[f"kernel.{k}"] == grew, k
