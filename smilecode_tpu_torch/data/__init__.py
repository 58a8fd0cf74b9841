from smilecode_tpu_torch.data.datasets import (
    LPBABrainAtlasDataset,
    LPBABrainAtlasInferDataset,
    LPBABrainDatasetS2S,
    LPBABrainHalfDatasetS2S,
    LPBABrainHalfInferDatasetS2S,
    LPBABrainInferDatasetS2S,
    halfres,
    pair_dataset,
    pair_indices,
    pkload,
)
from smilecode_tpu_torch.data.loader import Loader
from smilecode_tpu_torch.data.trans import LPBA_SEG_TABLE, Base, Compose, NumpyType, Seg_norm

__all__ = [
    "LPBABrainAtlasDataset",
    "LPBABrainAtlasInferDataset",
    "LPBABrainDatasetS2S",
    "LPBABrainHalfDatasetS2S",
    "LPBABrainHalfInferDatasetS2S",
    "LPBABrainInferDatasetS2S",
    "halfres",
    "pair_dataset",
    "pair_indices",
    "pkload",
    "Loader",
    "LPBA_SEG_TABLE",
    "Base",
    "Compose",
    "NumpyType",
    "Seg_norm",
]
