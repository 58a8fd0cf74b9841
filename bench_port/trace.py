"""Reduction of a `torch.profiler` trace of the measured window, from the
profiler's raw events (a window of some 10^6 events; building the
profiler's own event tree for it takes minutes).

The window is the benchmark's own ``bench.window`` span; the benchmark also
wraps its calls into each layer of the program in spans of its own
(``bench.loader_next``, ``bench.step``, ``bench.score``), which name the
idle stretches of the device. Nothing here reads the program.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from bench_port.window import idle_gaps, union_length

WINDOW_SPAN = "bench.window"
TOP = 10
CONV_OPS = ("aten::convolution", "aten::convolution_backward")


def reduce(prof) -> dict:
    """From a finished profiler's raw events: the window's bounds (ns), the
    device intervals in it, device seconds by operation name, the device us
    under each of CONV_OPS (the kernels launched inside their outermost
    calls, on any thread), and the longest idle gaps named by the host's
    spans and ops on the window's thread."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    window = [e for e in events if e.name() == WINDOW_SPAN]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    lo, hi = window[0].start_ns(), window[0].end_ns()
    main_thread = window[0].start_thread_id()
    device, by_name = [], collections.defaultdict(float)
    cpu_s, cpu_e, cpu_n = [], [], []
    launched_by = {}  # an op's correlation id -> (thread, start)
    conv = collections.defaultdict(list)  # thread -> [(start, end)] of CONV_OPS calls
    for e in events:
        s, t, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation() and t > lo and s < hi:
                device.append((s, t, name, e.linked_correlation_id()))
                by_name[name] += (min(t, hi) - max(s, lo)) / 1e9
            continue
        thread = e.start_thread_id()
        launched_by[e.correlation_id()] = (thread, s)
        if name in CONV_OPS:
            conv[thread].append((s, t))
        if thread == main_thread and e is not window[0]:
            cpu_s.append(s)
            cpu_e.append(t)
            cpu_n.append(name)
    conv_spans = {}
    for thread, spans in conv.items():
        merged = []
        for s, t in sorted(spans):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        conv_spans[thread] = np.asarray(merged, dtype=np.int64).reshape(-1, 2)
    conv_us = 0.0
    for s, t, _, corr in device:
        thread, at = launched_by.get(corr, (None, None))
        spans = conv_spans.get(thread)
        if spans is not None and len(spans):
            i = np.searchsorted(spans[:, 0], at, side="right") - 1
            if i >= 0 and at <= spans[i, 1]:
                conv_us += (t - s) / 1e3
    intervals = [(s, t) for s, t, _, _ in device]
    busy_ns = union_length(intervals, lo, hi)
    starts, ends = np.asarray(cpu_s), np.asarray(cpu_e)
    bench = np.asarray([n.startswith("bench.") for n in cpu_n], dtype=bool)

    def host_name(t: float) -> str:
        """The benchmark span and the innermost host op running at ``t``."""
        if not len(starts):
            return "idle"
        cover = (starts <= t) & (ends >= t)
        names = []
        for mask in (cover & bench, cover):
            if mask.any():
                i = int(np.flatnonzero(mask)[np.argmax(starts[mask])])
                names.append(cpu_n[i])
        return "/".join(dict.fromkeys(names)) or "idle"

    gaps = idle_gaps(intervals, lo, hi)[:TOP]
    return {
        "busy_s": busy_ns / 1e9,
        "traced_s": (hi - lo) / 1e9,
        "device_events": [(s / 1e3, t / 1e3, name) for s, t, name, _ in device],
        "conv_device_us": conv_us,
        "breakdown": {
            "device_ops": [[n[:120], v] for n, v in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[host_name((a + b) / 2)[:120], (b - a) / 1e9] for a, b in gaps],
        },
    }
