"""step_idle_ms: device-idle milliseconds per step or pair of the traced
half inside the program's ``train.step`` or ``infer.step`` spans
(`train.make_train_step`, `infer.make_infer_step`): the host's launches and
syncs that the device waits on, the trace's device intervals laid over the
program's span log."""

from bench_port import program_spans


def read(record):
    return program_spans.idle_ms_per_unit(record, ("train.step", "infer.step"),
                                          program_spans.program_log())
