from smilecode_tpu_torch.losses.core import grad3d, ncc_vxm
from smilecode_tpu_torch.losses.extended import (
    displacement_regularizer,
    grad2d,
    grad3d_itv,
    local_mutual_information,
    mind_loss,
    mind_ssc,
    mutual_information,
    ssim2d,
    ssim3d,
    ssim3d_loss,
)

__all__ = [
    "ncc_vxm", "grad3d", "ssim2d", "ssim3d", "ssim3d_loss", "grad2d",
    "grad3d_itv", "displacement_regularizer", "mind_ssc", "mind_loss",
    "mutual_information", "local_mutual_information",
]
