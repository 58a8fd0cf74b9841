"""loader_wait_ms: host milliseconds the loop waits in ``next()`` on the
program's `Loader`, per step or pair of the run's untraced half (host
clock, free of the profiler's own cost)."""


def read(record):
    waits = record.get("loader_wait_s")
    return sum(waits) * 1e3 / len(waits) if waits else None
