"""Per-layer numbers from the program's own spans: pure functions over the
program's span log (`smilecode_tpu_torch.utils.profiling.spans`: name,
start and end in Unix-epoch ns, thread, parent) and a record's
``device_events`` ((start, end, name) in Unix-epoch us, the trace's clock),
kept apart so the CPU tests can hold them to hand-worked cases.

The log is in memory in the process that ran the window, and it holds the
traced half alone: the program logs spans only while a profiler records.
A program without the log (one older than its spans) gives None, and so do
the readers.
"""

from __future__ import annotations

import bisect

from bench_port.window import union_length


def program_log():
    """The program's span log, or None where the program keeps none."""
    try:
        from smilecode_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    return spans()


def intervals(log, names) -> list:
    """(start, end) in us of the closed spans of ``log`` named in
    ``names``, in the log's order."""
    return [(s[1] / 1e3, s[2] / 1e3) for s in log if s[0] in names and s[2] is not None]


def merge(device) -> list:
    """The union of (start, end) ``device`` intervals as sorted disjoint
    [start, end] pairs."""
    out = []
    for s, e in sorted(device):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def idle_inside(spans, device) -> float:
    """The time inside ``spans`` (start, end) that no ``device`` interval
    covers: each span's length less `window.union_length` of the device
    intervals in it, summed over the spans (which, being of one layer, do
    not overlap)."""
    merged = merge(device)
    starts = [s for s, _ in merged]
    total = 0.0
    for lo, hi in spans:
        if hi <= lo:
            continue
        first = max(bisect.bisect_right(starts, lo) - 1, 0)
        last = bisect.bisect_left(starts, hi)
        total += (hi - lo) - union_length(merged[first:last], lo, hi)
    return total


def idle_ms_per_unit(record, names, log) -> float | None:
    """Device-idle ms per traced unit inside the spans named ``names``;
    None without device events, units or such spans."""
    events = record.get("device_events")
    spans = intervals(log or [], names)
    if not events or not spans or not record.get("traced_units"):
        return None
    return idle_inside(spans, [(s, e) for s, e, _ in events]) / 1e3 / record["traced_units"]


def host_ms_per_unit(record, names, log) -> float | None:
    """Host ms per traced unit inside the spans named ``names``; None
    without device events (an untraced run), units or such spans."""
    spans = intervals(log or [], names)
    if not record.get("device_events") or not spans or not record.get("traced_units"):
        return None
    return sum(e - s for s, e in spans) / 1e3 / record["traced_units"]


def mean_us(record, prefix: str, log) -> float | None:
    """Mean us of the spans whose name starts with ``prefix``; None without
    device events or such spans."""
    spans = [(s[1], s[2]) for s in log or [] if s[0].startswith(prefix) and s[2] is not None]
    if not record.get("device_events") or not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / len(spans)
