"""train_step_ms: the window's milliseconds over the training steps it
completed (host clock, synchronised at both ends)."""


def read(record):
    if record["kind"] != "train" or not record["units"]:
        return None
    return record["window_s"] * 1e3 / record["units"]
