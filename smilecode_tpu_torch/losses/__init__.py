from smilecode_tpu_torch.losses.core import grad3d, ncc_vxm

__all__ = ["ncc_vxm", "grad3d"]
