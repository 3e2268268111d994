"""Frozen ResNet grid encoder (counterpart of the JAX ``models/resnet.py``).

torchvision's v1.5 bottleneck layout (stride on the 3x3 conv), frozen
BatchNorm on running statistics (eps 1e-5, computed in f32), convs in the
compute dtype (bf16 by default) on channels_last tensors. Public inputs and
outputs keep the JAX package's NHWC layout; a permuted NHWC tensor IS a
channels_last NCHW tensor, so the layout change costs no copy.

Submodule and parameter names follow the flax names (``conv1``, ``bn1``,
``layer{s}_{b}``, ``ds_conv``, ``ds_bn``) so ``utils/jax_bridge.py`` maps
weights name for name. Folding BN into the convs waits for a later change.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from depth_image_captioning_pub_torch.models.initializers import (
    torch_conv_kernel)
from depth_image_captioning_pub_torch.ops.pooling import adaptive_avg_pool2d
from depth_image_captioning_pub_torch.ops.precision import full_f32

RESNET152_LAYERS = (3, 8, 36, 3)


class FrozenConv2d(nn.Module):
    """Bias-free conv with a frozen OIHW weight stored channels_last."""

    def __init__(self, in_c: int, out_c: int, kernel: int, stride: int = 1,
                 padding: int = 0, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        weight = torch.empty((out_c, in_c, kernel, kernel), dtype=dtype,
                             device=device)
        self.weight = nn.Parameter(
            weight.contiguous(memory_format=torch.channels_last),
            requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.copy_(torch_conv_kernel(self.weight.shape, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, None, self.stride, self.padding)


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm on running statistics; f32 math, output in x's dtype."""

    def __init__(self, channels: int, *, device=None, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name, value in (("weight", 1.0), ("bias", 0.0),
                            ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full(
                (channels,), value, dtype=torch.float32, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's BatchNorm init: scale 1, bias 0, mean 0, var 1."""
        self.weight.fill_(1.0)
        self.bias.fill_(0.0)
        self.running_mean.fill_(0.0)
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) bottleneck, torchvision v1.5 layout.
    NCHW (channels_last) in and out."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, *, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = FrozenConv2d(in_planes, planes, 1, **kw)
        self.bn1 = FrozenBatchNorm2d(planes, device=device)
        self.conv2 = FrozenConv2d(planes, planes, 3, stride, 1, **kw)
        self.bn2 = FrozenBatchNorm2d(planes, device=device)
        self.conv3 = FrozenConv2d(planes, planes * 4, 1, **kw)
        self.bn3 = FrozenBatchNorm2d(planes * 4, device=device)
        if downsample:
            self.ds_conv = FrozenConv2d(in_planes, planes * 4, 1, stride, **kw)
            self.ds_bn = FrozenBatchNorm2d(planes * 4, device=device)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)), inplace=True)
        out = F.relu(self.bn2(self.conv2(out)), inplace=True)
        out = self.bn3(self.conv3(out))
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(out + identity, inplace=True)


class ResNetBackbone(nn.Module):
    """Stem + 4 stages: [B, H, W, 3] -> [B, H/32, W/32, 2048] (NHWC)."""

    def __init__(self, layers: Sequence[int] = RESNET152_LAYERS, *,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = FrozenConv2d(3, 64, 7, 2, 3, dtype=dtype, device=device)
        self.bn1 = FrozenBatchNorm2d(64, device=device)
        self.block_names = []
        in_planes = 64
        for stage, (blocks, planes) in enumerate(
                zip(layers, (64, 128, 256, 512))):
            for block in range(blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                name = f"layer{stage + 1}_{block}"
                self.add_module(name, Bottleneck(
                    in_planes, planes, stride, downsample=(block == 0),
                    dtype=dtype, device=device))
                self.block_names.append(name)
                in_planes = planes * 4

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (FrozenConv2d, FrozenBatchNorm2d)):
                m.reset_parameters(generator)

    @full_f32()   # f32 convs in full f32, not cuDNN's default TF32
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.dtype).permute(0, 3, 1, 2)   # channels_last view
        x = F.relu(self.bn1(self.conv1(x)), inplace=True)
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x.permute(0, 2, 3, 1)


class AttentionGridEncoder(nn.Module):
    """Frozen ResNet -> enc_img_size^2 annotation grid [B, K, 2048]; the
    7x7 map of a 224^2 image becomes 14x14 by exact bin duplication."""

    def __init__(self, enc_img_size: int = 14, *, dtype=torch.bfloat16,
                 layers: Sequence[int] = RESNET152_LAYERS, device=None):
        super().__init__()
        self.enc_img_size = enc_img_size
        self.backbone = ResNetBackbone(layers, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.backbone.reset_parameters(generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = adaptive_avg_pool2d(self.backbone(images), self.enc_img_size)
        b = x.shape[0]
        return x.reshape(b, self.enc_img_size * self.enc_img_size,
                         x.shape[-1])
