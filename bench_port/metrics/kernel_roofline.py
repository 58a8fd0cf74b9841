"""kernel_roofline: the share (%) of their roofline that the hand-written
kernels K1-K5 reach in the traced window: the sum of each call's least time
(`bench_port.work.bound`, from the configuration's shapes) over the sum of
their device time, the kernels found in the trace by their __global__
names. A kernel that the trace does not hold counts on neither side; with
none found the metric is left out."""

from bench_port import work


def read(record):
    events = record.get("device_events")
    if not events or not record["traced_units"]:
        return None
    peak = record["config"]["peak"]
    bound_ms, device_ms = 0.0, 0.0
    for kernel, info in work.KERNELS.items():
        times = [t - s for s, t, name in events if any(g in name for g in info["globals"])]
        if not times:
            continue
        device_ms += sum(times) / 1e3
        per_unit = sum(work.bound(*work.call_work(c)[1:], peak["bytes_per_s"], peak["ops_per_s"])[0]
                       for c in record["work"]["kernel_calls"] if c["kernel"] == kernel)
        bound_ms += per_unit * record["traced_units"]
    if not device_ms:
        return None
    return 100.0 * bound_ms / device_ms
