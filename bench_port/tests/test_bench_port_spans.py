"""The arithmetic of the readers of the program's spans
(`bench_port/program_spans.py`), on hand-worked cases."""

import pytest

from bench_port import harness, program_spans


def log_of(*spans):
    """Log entries (name, start ns, end ns, thread, parent) from
    (name, start us, end us)."""
    return [(n, int(s * 1e3), None if e is None else int(e * 1e3), 1, -1) for n, s, e in spans]


def test_idle_inside_spans_partly_and_fully_covered():
    # span [0, 10]: device [2, 4] and [3, 6] overlap -> covered 4, idle 6;
    # span [20, 30]: device [15, 40] covers it all -> idle 0;
    # span [50, 60]: device [58, 70] covers 2 -> idle 8
    device = [(3, 6), (15, 40), (2, 4), (58, 70)]
    assert program_spans.idle_inside([(0, 10), (20, 30), (50, 60)], device) == 14
    assert program_spans.idle_inside([(0, 10)], []) == 10
    assert program_spans.idle_inside([], device) == 0


def test_merge_gives_sorted_disjoint_intervals():
    assert program_spans.merge([(5, 7), (1, 3), (2, 4), (7, 9), (10, 10)]) == [[1, 4], [5, 9]]


def test_idle_per_unit_reads_the_named_spans_alone():
    log = log_of(("loader.next", 0, 10), ("loader.copy", 6, 10), ("train.step", 10, 30),
                 ("loader.next", 30, 40), ("train.step", 40, None))  # the last still open
    record = {"device_events": [(2, 4, "k"), (3, 6, "k"), (12, 29, "k"), (35, 38, "k")],
              "traced_units": 2}
    # loader.next: [0, 10] idle 6, [30, 40] idle 7 -> 13 us over 2 units
    assert program_spans.idle_ms_per_unit(record, ("loader.next",), log) == pytest.approx(6.5e-3)
    # train.step: [10, 30] idle 3 (the open one is left out)
    assert program_spans.idle_ms_per_unit(record, ("train.step",), log) == pytest.approx(1.5e-3)
    assert program_spans.host_ms_per_unit(record, ("loader.copy",), log) == pytest.approx(2e-3)


def test_mean_us_of_the_kernel_spans():
    log = log_of(("kernel.K1", 0, 30), ("kernel.K3", 40, 90), ("train.step", 0, 100))
    assert program_spans.mean_us({"device_events": [(0, 1, "k")]}, "kernel.K", log) == 40


@pytest.mark.parametrize("stem", ["loader_idle_ms", "loader_copy_ms", "step_idle_ms",
                                  "kernel_host_us"])
def test_readers_give_none_without_device_events_or_spans(stem, monkeypatch):
    read = harness.reader(f"{stem}.train")
    traced = {"device_events": [(0, 5, "k")], "traced_units": 1}
    monkeypatch.setattr(program_spans, "program_log", lambda: None)
    assert read(traced) is None  # a program without the log
    monkeypatch.setattr(program_spans, "program_log", lambda: [])
    assert read(traced) is None  # no spans
    spans = log_of(("loader.next", 0, 10), ("loader.copy", 1, 2), ("train.step", 10, 20),
                   ("kernel.K2", 11, 12))
    monkeypatch.setattr(program_spans, "program_log", lambda: spans)
    assert read({"traced_units": 0}) is None  # an untraced run
    assert read(traced) is not None
