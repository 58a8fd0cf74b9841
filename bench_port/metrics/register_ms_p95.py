"""register_ms_p95: the 95th percentile of every pair's latency in the
window, from the request for its batch to its Dice and fold on the host."""

from bench_port.window import percentile


def read(record):
    if record["kind"] != "register" or not record.get("latencies_s"):
        return None
    return percentile(record["latencies_s"], 95) * 1e3
