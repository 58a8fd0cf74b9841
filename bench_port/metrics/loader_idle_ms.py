"""loader_idle_ms: device-idle milliseconds per step or pair of the traced
half inside the program's own ``loader.next`` spans (`Loader`: submitting
the next build, the wait on its workers, the pinned copy), the trace's
device intervals laid over the program's span log."""

from bench_port import program_spans


def read(record):
    return program_spans.idle_ms_per_unit(record, ("loader.next",), program_spans.program_log())
