"""Profiling hooks: spans at the port's layer boundaries, a `torch.profiler`
trace and a step timer that waits for the device.

Counterpart of `smilecode_tpu/utils/profiling.py`. CUDA work is queued
asynchronously, so `StepTimer.stop` synchronises every card its outputs
live on before it reads the clock.

Spans (`span`) are on only while a `torch.profiler` records on the calling
thread (autograd's backward threads inherit the profiler from the thread
that started the backward). Off, a span site costs one check of the
profiler's flag. On, a span is a `torch.profiler.record_function` of its
name, so it shows in every profiler trace, and an entry of an in-memory
log (`spans`): name, start and end in ns on the profiler's own clock (Unix
epoch, the clock of the trace's host and device events), thread and the
index of the enclosing span on that thread. The port's spans:

* ``loader.next`` (`data.loader.Loader`), each batch handed out, over
  ``loader.wait`` (a worker's batch) or ``loader.build`` (no workers) and
  ``loader.copy`` (pinning and the copy to the device);
* ``train.step`` (`train.make_train_step`) over ``train.forward``,
  ``train.loss``, ``train.backward`` and ``train.optimizer`` (the
  D-sharded step: ``train.step`` alone);
* ``infer.step`` (`infer.make_infer_step`) over ``infer.forward`` and
  ``infer.score`` (the nearest warp, both Dice and the folding fraction);
* ``kernel.K1`` ... ``kernel.K5`` (the wrappers in `kernels/`), from a
  wrapper's entry to its return, on whatever thread calls it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

LOG_LIMIT = 1 << 20  # spans the log holds; later ones go to the trace alone

# the flag torch.profiler sets on each thread it records: one C call
_profiler_enabled = torch._C._autograd._profiler_enabled
_log: list = []
_lock = threading.Lock()


class _Open(threading.local):
    """The log indices of each thread's open spans, innermost last."""

    def __init__(self):
        self.stack = []


_open = _Open()


class Span(NamedTuple):
    """One logged span; ``end_ns`` is None while it is open, ``parent`` -1
    for a span with no enclosing one on its thread."""

    name: str
    start_ns: int
    end_ns: int | None
    thread: int
    parent: int


class _Off:
    """The span of a site while no profiler records. Its ``__enter__`` and
    ``__exit__`` are a C function that reads no argument and returns ""
    (false, so an exception goes on): a Python method would take twice the
    time of the site."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()


class _On:
    __slots__ = ("name", "record", "entry", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()
        self.stack = stack = _open.stack
        # [name, start, end, thread, parent]; the end is filled in on exit
        self.entry = [self.name, time.time_ns(), None, threading.get_ident(),
                      stack[-1] if stack else -1]
        with _lock:
            index = len(_log)
            if index < LOG_LIMIT:
                _log.append(self.entry)
            else:
                index = -1
        stack.append(index)

    def __exit__(self, *exc):
        self.entry[2] = time.time_ns()
        self.stack.pop()
        self.record.__exit__(*exc)


def span(name: str):
    """A context manager that marks the block as span ``name`` while a
    profiler records, and does nothing else otherwise."""
    return _On(name) if _profiler_enabled() else _OFF


def spans() -> list:
    """The log: every `Span` since the last `reset`, in the order they
    opened."""
    with _lock:
        return [Span(*e) for e in _log]


def reset() -> None:
    """Empty the log."""
    with _lock:
        _log.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with `torch.profiler` (the CPU, and the card where
    there is one) and write its trace into ``logdir`` on exit (a
    ``*.pt.trace.json`` that TensorBoard's profiler plugin or Perfetto
    opens), the port's spans among its events. Empties the span log on
    entry, so that `spans` then holds the block's. Yields the profiler,
    whose ``key_averages()`` sums the ops."""
    reset()
    with torch.profiler.profile(
        activities=sorted(torch.profiler.supported_activities(), key=str),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
        acc_events=True,  # keep the events for key_averages() after the trace is written
    ) as prof:
        yield prof


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class StepTimer:
    """Wall-clock step timer in ms; `stop` waits for the step's outputs."""

    def __init__(self):
        self.times_ms: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, outputs=None) -> float:
        """Synchronise each CUDA device that holds a tensor of ``outputs``
        (a tensor, or dicts, lists and tuples of them), then read the clock."""
        for dev in {t.device for t in _tensors(outputs) if t.is_cuda}:
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - self._t0) * 1000
        self.times_ms.append(dt)
        return dt

    @property
    def median_ms(self) -> float:
        return float(np.median(self.times_ms)) if self.times_ms else 0.0


def memory_stats(device="cuda") -> dict:
    """`torch.cuda.memory_stats` of a CUDA ``device``; ``{}`` for the CPU,
    which keeps none (as the JAX package's returns for a backend without
    them)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(device))
