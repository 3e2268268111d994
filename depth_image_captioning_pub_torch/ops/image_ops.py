"""On-device image preprocessing (counterpart of the JAX ``ops/image_ops.py``).

Images cross to the device as raw uint8 NHWC pixels and are converted and
normalized there. The public functions keep the NHWC layout of the JAX
package, so tests compare like with like.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_unit_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1]; float input passes through."""
    if not images.is_floating_point():
        return images.to(torch.float32) / 255.0
    return images


def imagenet_normalize(images: torch.Tensor) -> torch.Tensor:
    """[B,H,W,3] in [0,1] -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype,
                        device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def dpt_normalize(images: torch.Tensor) -> torch.Tensor:
    """mean=0.5/std=0.5 normalization for the DPT input."""
    return images * 2.0 - 1.0


def resize_bilinear(images: torch.Tensor, hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """[B,H,W,C] -> [B,h,w,C], half-pixel bilinear without antialiasing
    (the JAX ``jax.image.resize(..., antialias=False)``): 224->384 before
    the DPT and its depth map 384->224 after."""
    out = F.interpolate(images.permute(0, 3, 1, 2), size=tuple(hw),
                        mode="bilinear", align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1)


def standardize_depth_map(depth: torch.Tensor) -> torch.Tensor:
    """Per-image min-max to [0,1], NaN->0.5 first; depth [B, ...]."""
    depth = torch.nan_to_num(depth, nan=0.5)
    flat = depth.reshape(depth.shape[0], -1)
    shape = (depth.shape[0],) + (1,) * (depth.dim() - 1)
    mins = flat.amin(dim=1).reshape(shape)
    maxs = flat.amax(dim=1).reshape(shape)
    return (depth - mins) / (maxs - mins)
