from smilecode_tpu_torch.data.datasets import (
    LPBABrainDatasetS2S,
    LPBABrainInferDatasetS2S,
    pair_indices,
    pkload,
)
from smilecode_tpu_torch.data.loader import Loader
from smilecode_tpu_torch.data.trans import LPBA_SEG_TABLE, Base, Compose, NumpyType, Seg_norm

__all__ = [
    "LPBABrainDatasetS2S",
    "LPBABrainInferDatasetS2S",
    "pair_indices",
    "pkload",
    "Loader",
    "LPBA_SEG_TABLE",
    "Base",
    "Compose",
    "NumpyType",
    "Seg_norm",
]
