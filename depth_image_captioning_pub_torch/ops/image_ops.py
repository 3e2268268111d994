"""On-device image preprocessing (counterpart of the JAX ``ops/image_ops.py``).

Images cross to the device as raw uint8 NHWC pixels and are converted and
normalized there. The public functions keep the NHWC layout of the JAX
package, so tests compare like with like.
"""

from __future__ import annotations

import torch

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
