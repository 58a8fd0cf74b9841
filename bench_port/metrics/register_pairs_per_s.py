"""register_pairs_per_s: pairs whose Dice and folding fraction reached the
host in the window, over the window's seconds."""


def read(record):
    if record["kind"] != "register":
        return None
    return record["units"] / record["window_s"]
