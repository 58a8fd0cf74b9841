"""step_mfu: the share (%) of the configuration's peak float32 rate that
the whole step or pair reaches: the operations of one step or pair over
its host-clock time in the run's untraced half (all the work and all the
time, free of the profiler's own cost). The operations are counted from
the configuration's shapes on the benchmark's reference (its convolutions
and linear layers, forward and in training backward) plus K1-K5's own
from `bench_port.work`, never from the program."""


def read(record):
    work = record.get("work")
    if not work or not record["units"]:
        return None
    per_unit_s = record["window_s"] / record["units"]
    return 100.0 * work["flops"] / (per_unit_s * record["config"]["peak"]["ops_per_s"])
