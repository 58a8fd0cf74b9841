"""setup_s: seconds from the start of the process to the window's start:
imports, the kernels' library (built only in a checkout's first run),
weights and subjects from the seed, and the first steps or warm-up pair."""


def read(record):
    return record["setup_s"]
