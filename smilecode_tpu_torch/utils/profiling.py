"""Profiling hooks: a `torch.profiler` trace and a step timer that waits for
the device.

Counterpart of `smilecode_tpu/utils/profiling.py`. CUDA work is queued
asynchronously, so `StepTimer.stop` synchronises every card its outputs
live on before it reads the clock.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with `torch.profiler` (the CPU, and the card where
    there is one) and write its trace into ``logdir`` on exit (a
    ``*.pt.trace.json`` that TensorBoard's profiler plugin or Perfetto
    opens). Yields the profiler, whose ``key_averages()`` sums the ops."""
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
