"""kernel_host_us: mean host microseconds of one call of a K1-K5 wrapper in
the traced half, from its entry to its return (the program's ``kernel.K*``
spans, on any thread; under the profiler, so its own cost is in it)."""

from bench_port import program_spans


def read(record):
    return program_spans.mean_us(record, "kernel.K", program_spans.program_log())
