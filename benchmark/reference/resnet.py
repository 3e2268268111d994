"""Plain ResNet grid encoder (He et al., arXiv:1512.03385; torchvision's
v1.5 bottleneck, the stride on the 3x3 conv) over a dict of weights.

BatchNorm is frozen on its running statistics. The 7x7 map of a 224x224
image becomes the 14x14 annotation grid by adaptive average pooling (exact
bin duplication), as Show, Attend and Tell's encoder (arXiv:1502.03044)
resizes it. Weight names are the benchmark's keys under ``prefix``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from reference.ops import F32, Rounding

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PLANES = (64, 128, 256, 512)


def _bn(x, w, p):
    return F.batch_norm(x, w[p + ".running_mean"].to(F32),
                        w[p + ".running_var"].to(F32), w[p + ".weight"].to(F32),
                        w[p + ".bias"].to(F32), False, 0.0, 1e-5)


def _conv(x, w, p, r: Rounding, stride=1, padding=0):
    return F.conv2d(r(x), r(w[p + ".weight"]), None, stride, padding)


def _block(x, w, p, stride, downsample, r):
    out = F.relu(_bn(_conv(x, w, p + ".conv1", r), w, p + ".bn1"))
    out = F.relu(_bn(_conv(out, w, p + ".conv2", r, stride, 1), w,
                     p + ".bn2"))
    out = _bn(_conv(out, w, p + ".conv3", r), w, p + ".bn3")
    if downsample:
        x = _bn(_conv(x, w, p + ".ds_conv", r, stride), w, p + ".ds_bn")
    return F.relu(out + x)


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalized float32 NCHW."""
    x = images_u8.to(F32).permute(0, 3, 1, 2) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=F32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=F32, device=x.device)
    return (x - mean[:, None, None]) / std[:, None, None]


def grid_features(w: Dict[str, torch.Tensor], images_u8: torch.Tensor,
                  layers: Sequence[int], grid: int = 14,
                  prefix: str = "encoder.backbone.",
                  r: Rounding = Rounding()) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> annotation vectors [B, grid*grid, 2048]."""
    g = {k[len(prefix):]: v for k, v in w.items() if k.startswith(prefix)}
    x = normalize(images_u8)
    x = F.relu(_bn(_conv(x, g, "conv1", r, 2, 3), g, "bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            x = _block(x, g, f"layer{stage + 1}_{b}", stride, b == 0, r)
    x = F.adaptive_avg_pool2d(x, grid)
    return x.flatten(2).transpose(1, 2)
