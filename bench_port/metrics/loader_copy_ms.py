"""loader_copy_ms: host milliseconds per step or pair of the traced half
inside the program's ``loader.copy`` spans (`Loader._to_device`: pinning
and the non-blocking copy of each column); the rest of ``loader.next`` is
the wait on the workers."""

from bench_port import program_spans


def read(record):
    return program_spans.host_ms_per_unit(record, ("loader.copy",), program_spans.program_log())
