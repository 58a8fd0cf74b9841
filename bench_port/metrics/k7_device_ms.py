"""k7_device_ms: device milliseconds per training step or registered pair
of the hand-written kernel K7, PR++'s windowed correlation and its adjoint
(`smilecode_tpu_torch/csrc/correlation3d.cu`: its box sums, correlation and
two gathers, `bench_port.work.correlation.GLOBALS`), found by name in the
traced window. A program without K7 launches none of them, and the metric
is left out."""

from bench_port.work import correlation


def read(record):
    events = record.get("device_events")
    if not events or not record["traced_units"]:
        return None
    us = sum(t - s for s, t, name in events if any(g in name for g in correlation.GLOBALS))
    return us / 1e3 / record["traced_units"] if us else None
