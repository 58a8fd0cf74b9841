"""Spatial (halo-exchange) parallelism: the D axis sharded over the ranks
of a "spatial" group.

Counterpart of `smilecode_tpu/parallel/spatial.py:32-110`: `halo_exchange`
pads a rank's D slab with ``halo`` slices of each neighbour (zeros beyond
the volume's ends, the unsharded ops' zero padding), `conv3d_valid_d` is a
3D convolution that is VALID along D and SAME along H and W, and
`halo_conv` chains the two per layer, which equals an unsharded SAME
convolution. Layout NDHWC; the exchange is differentiable (its backward
sends each halo's cotangent back to the rank it came from).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from smilecode_tpu_torch.parallel.mesh import Mesh, ppermute


def halo_exchange(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """(B, Dl, H, W, C) -> (B, Dl + 2*halo, H, W, C): ``halo`` slices of the
    previous rank's slab before this one's, ``halo`` of the next rank's
    after it, zeros at the volume's ends."""
    if halo == 0:
        return x
    from_prev = ppermute(x[:, -halo:], mesh, 1)
    from_next = ppermute(x[:, :halo], mesh, -1)
    return torch.cat([from_prev, x, from_next], dim=1)


def conv3d_valid_d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                   stride: int = 1) -> torch.Tensor:
    """3D convolution of an NDHWC tensor with a torch (Cout, Cin, k, k, k)
    ``weight``: VALID along D, SAME along H and W (the D halo supplies
    the padding). Returns NDHWC."""
    pad = weight.shape[2] // 2
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight, bias, stride, padding=(0, pad, pad))
    return y.permute(0, 2, 3, 4, 1)


def halo_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, mesh: Mesh,
              stride: int = 1) -> torch.Tensor:
    """Per-layer halo exchange then `conv3d_valid_d`: equals the unsharded
    SAME convolution, and chains with nonlinearities in between."""
    return conv3d_valid_d(halo_exchange(x, weight.shape[2] // 2, mesh), weight, bias, stride)
