"""k6_device_ms: device milliseconds per training step of the hand-written
kernel K6, the float32 3x3x3 conv weight and bias gradient
(`smilecode_tpu_torch/csrc/conv3d_wgrad.cu`: its main kernel
``wgrad_kernel<TM, TN>`` and its reduction ``wgrad_reduce_kernel<S>``),
from the traced window. K6 is launched from its own autograd Function,
outside the aten convolution ops, so `conv_device_ms` does not count it. A
program without K6 launches neither kernel, and the metric is left out."""

K6_GLOBALS = ("(anonymous namespace)::wgrad_kernel<", "(anonymous namespace)::wgrad_reduce_kernel<")


def read(record):
    events = record.get("device_events")
    if not events or not record["traced_units"]:
        return None
    us = sum(t - s for s, t, name in events if any(g in name for g in K6_GLOBALS))
    return us / 1e3 / record["traced_units"] if us else None
