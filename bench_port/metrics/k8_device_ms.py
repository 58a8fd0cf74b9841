"""k8_device_ms: device milliseconds per training step or registered pair
of the hand-written kernel K8, ModeT's LayerNorm and its backward
(`smilecode_tpu_torch/csrc/layer_norm.cu`: ``layer_norm_rows_fwd_kernel``,
``layer_norm_rows_bwd_kernel`` and ``layer_norm_rows_reduce_kernel``), found
by name in the traced window. A program without K8 launches none of them
(torch's own LayerNorm kernels have other names), and the metric is left
out."""

K8_GLOBALS = ("(anonymous namespace)::layer_norm_rows_",)


def read(record):
    events = record.get("device_events")
    if not events or not record["traced_units"]:
        return None
    us = sum(t - s for s, t, name in events if any(g in name for g in K8_GLOBALS))
    return us / 1e3 / record["traced_units"] if us else None
