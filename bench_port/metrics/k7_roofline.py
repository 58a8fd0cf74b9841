"""k7_roofline: the share (%) of its roofline that the hand-written kernel
K7 (PR++'s windowed correlation and its adjoint) reaches in the traced
window: the least time of a step's or a pair's K7 calls
(`bench_port.work.correlation`, counted from the configuration's volume and
width at the configuration's peak rates) over K7's device time per step or
pair, its kernels found in the trace by their __global__ names. With no K7
kernel in the trace the metric is left out."""

from bench_port import work
from bench_port.work import correlation


def read(record):
    events = record.get("device_events")
    if not events or not record["traced_units"]:
        return None
    us = sum(t - s for s, t, name in events if any(g in name for g in correlation.GLOBALS))
    if not us:
        return None
    peak = record["config"]["peak"]
    bound_ms = sum(work.bound(*correlation.work(kernel, voxels, c), peak["bytes_per_s"],
                              peak["ops_per_s"])[0]
                   for kernel, voxels, c in correlation.calls(record["config"],
                                                               record["kind"] == "train"))
    return 100.0 * bound_ms / (us / 1e3 / record["traced_units"])
