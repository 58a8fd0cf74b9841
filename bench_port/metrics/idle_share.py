"""idle_share: the share (%) of the traced window in which no operation ran
on the device (1 - the union of the device's intervals / the window)."""


def read(record):
    if "busy_s" not in record or not record["traced_s"]:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["traced_s"])
