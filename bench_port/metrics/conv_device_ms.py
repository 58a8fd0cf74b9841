"""conv_device_ms: device milliseconds per step or pair of the kernels
launched inside the outermost aten convolution ops (forward, and backward
in training), from the traced window."""


def read(record):
    us = record.get("conv_device_us")
    if not us or not record["traced_units"]:
        return None
    return us / 1e3 / record["traced_units"]
