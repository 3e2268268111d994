"""Pooling on NHWC tensors (counterpart of the JAX ``ops/pooling.py``).

The JAX package writes torch's exact ``AdaptiveAvgPool2d`` bin arithmetic
(start=floor(i*In/Out), end=ceil((i+1)*In/Out)) as averaging matmuls; here
torch's own op computes it. On the encoder's 7x7 map the 14x14 grid is pure
bin duplication, so the result is exact in any dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> an NCHW view (channels_last when x is contiguous), no copy."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> an NHWC view, no copy."""
    return x.permute(0, 2, 3, 1)


def adaptive_avg_pool2d(x: torch.Tensor, output_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, out, out, C], exact nn.AdaptiveAvgPool2d math."""
    return nhwc(F.adaptive_avg_pool2d(nchw(x), output_size))


def max_pool2d(x: torch.Tensor, window: int, stride: Optional[int] = None,
               padding: int = 0) -> torch.Tensor:
    """[B, H, W, C] max pool; torch default stride = window, -inf padding."""
    return nhwc(F.max_pool2d(nchw(x), window, stride or window, padding))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, C]."""
    return x.mean(dim=(1, 2))
