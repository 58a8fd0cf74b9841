from smilecode_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from smilecode_tpu_torch.utils.device import resolve_device
from smilecode_tpu_torch.utils.logging import Logger, MetricsWriter
from smilecode_tpu_torch.utils.meters import AverageMeter

__all__ = ["AverageMeter", "Logger", "MetricsWriter", "latest_checkpoint", "load_checkpoint",
           "resolve_device", "save_checkpoint"]
