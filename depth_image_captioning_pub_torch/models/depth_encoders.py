"""Depth-map encoders (counterpart of the JAX ``models/depth_encoders.py``):
``DepthCNNEncoder`` (the ``depth-*`` kinds: three convs in the compute
dtype on channels_last tensors, each followed by a trainable BatchNorm
with flax's semantics) and ``img_to_patch`` + ``DepthMLPEncoder`` (the
``mdepth-*`` kinds: a per-patch MLP in f32, no batch statistics).

Parameters are float32, as the JAX module's (``param_dtype=float32``): the
convs cast their weights to the compute dtype at the call, which rounds
exactly as storing them in that dtype would, and AdamW updates the f32
values.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from depth_image_captioning_pub_torch.models.initializers import (
    torch_bias, torch_conv_kernel, torch_linear_kernel)
from depth_image_captioning_pub_torch.ops.pooling import (
    adaptive_avg_pool2d, nchw, nhwc)
from depth_image_captioning_pub_torch.ops.precision import full_f32
from depth_image_captioning_pub_torch.parallel.mesh import (
    all_reduce_autograd, make_mesh)


def _global_moments(x32: torch.Tensor, axes):
    """(mean, biased variance) per channel of the ranks' batches
    together: one all-reduce of [sum, sum of squares, count]."""
    count = x32.numel() // x32.shape[1]
    stats = torch.cat([x32.sum(axes), (x32 * x32).sum(axes),
                       x32.new_full((1,), float(count))])
    stats = all_reduce_autograd(stats)
    c = x32.shape[1]
    total = stats[2 * c]
    mean = stats[:c] / total
    var = torch.clamp(stats[c:2 * c] / total - mean * mean, min=0.0)
    return mean, var


class BatchNorm2d(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW
    tensors: f32 ``weight`` and ``bias`` parameters (flax's ``scale`` and
    ``bias``), f32 ``running_mean`` and ``running_var`` buffers, output in
    x's dtype.

    ``train=False`` normalizes with the running statistics. ``train=True``
    normalizes with the batch's statistics over (N, H, W), computed in f32
    as flax does (``use_fast_variance``: E[x²] − E[x]², clipped at 0, the
    biased variance), gradients flowing through them, and moves the
    buffers to ``momentum * running + (1 - momentum) * batch``. Every row
    counts, the batch's repeated pad rows too, as in the JAX step. Over
    several ranks (``parallel/mesh``) the batch is the global one: the
    per-channel sums, sums of squares and counts are all-reduced with
    autograd through them, as the JAX step's BatchNorm sees its whole
    sharded batch; one rank computes as before, bit for bit.
    """

    def __init__(self, channels: int, *, device=None, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.ones(channels, **f32))
        self.bias = nn.Parameter(torch.zeros(channels, **f32))
        self.register_buffer("running_mean", torch.zeros(channels, **f32))
        self.register_buffer("running_var", torch.ones(channels, **f32))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's BatchNorm init: scale 1, bias 0, mean 0, var 1."""
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.fill_(0.0)
            self.running_mean.fill_(0.0)
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        x32 = x.to(torch.float32)
        axes = (0, 2, 3)
        if make_mesh().sharded:
            mean, var = _global_moments(x32, axes)
        else:
            mean = x32.mean(axes)
            var = torch.clamp((x32 * x32).mean(axes) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean.reshape(shape)) * mul.reshape(shape)
        return (y + self.bias.reshape(shape)).to(x.dtype)


class DepthCNNEncoder(nn.Module):
    """3-conv depth encoder: a standardized [B, 224, 224, 1] depth map ->
    [B, 196, 2048] annotation vectors, aligned with the RGB grid.

    224 -(7x7 s3 valid)-> 73 -(max3)-> 24 -(3x3)-> 22 -(max3)-> 7 -(1x1)-> 7
    -(adaptive avg)-> 14x14. Submodule names are the flax names
    (``conv{1,2,3}``, ``bn{1,2,3}``).
    """

    def __init__(self, enc_img_size: int = 14, *, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.enc_img_size, self.dtype = enc_img_size, dtype
        kw = dict(dtype=torch.float32, device=device)
        self.conv1 = nn.Conv2d(1, 128, 7, stride=3, **kw)
        self.bn1 = BatchNorm2d(128, device=device)
        self.conv2 = nn.Conv2d(128, 512, 3, **kw)
        self.bn2 = BatchNorm2d(512, device=device)
        self.conv3 = nn.Conv2d(512, 2048, 1, **kw)
        self.bn3 = BatchNorm2d(2048, device=device)
        self.to(memory_format=torch.channels_last)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX module's init: torch-default conv kernels, zero conv
        biases, BN scale 1, bias 0, mean 0, var 1."""
        with torch.no_grad():
            for conv in (self.conv1, self.conv2, self.conv3):
                conv.weight.copy_(torch_conv_kernel(conv.weight.shape,
                                                    generator))
                conv.bias.zero_()
        for bn in (self.bn1, self.bn2, self.bn3):
            bn.reset_parameters(generator)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, conv.weight.to(self.dtype),
                        conv.bias.to(self.dtype), conv.stride)

    @full_f32()   # f32 convs in full f32, not cuDNN's default TF32
    def forward(self, depth: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        """``train`` normalizes with the batch's statistics and moves the
        BNs' running statistics (``BatchNorm2d``)."""
        x = nchw(depth.to(self.dtype))
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            x = F.max_pool2d(F.relu(bn(self._conv(conv, x), train)), 3)
        x = F.relu(self.bn3(self._conv(self.conv3, x), train))
        x = adaptive_avg_pool2d(nhwc(x), self.enc_img_size)
        return x.reshape(x.shape[0], self.enc_img_size ** 2, x.shape[-1])


def img_to_patch(depth: torch.Tensor, patch: int = 16) -> torch.Tensor:
    """[B, H, W, 1] -> [B, (H/p)*(W/p), p*p]: the patches ordered row-major
    over the grid, each patch's pixels row-major (``nn.Unfold(16,
    stride=16)`` and a permute on one channel)."""
    b, h, w, c = depth.shape
    if c != 1 or h % patch or w % patch:
        raise ValueError(f"img_to_patch needs [B, H, W, 1] with H and W "
                         f"multiples of {patch}, got {tuple(depth.shape)}")
    gh, gw = h // patch, w // patch
    x = depth[..., 0].reshape(b, gh, patch, gw, patch)
    return x.permute(0, 1, 3, 2, 4).reshape(b, gh * gw, patch * patch)


class DepthMLPEncoder(nn.Module):
    """Per-patch MLP 256 -> 128 -> 64 -> 32, ReLU after every layer, f32:
    [B, 196, 256] patches -> [B, 196, 32] features, which the decoder
    concatenates to the RGB features (2048 + 32 = 2080). Layer names are
    the flax names (``l1``, ``l2``, ``l3``). ``dtype`` is the compute
    dtype (the JAX module takes the decoder's: bf16 in mixed-precision
    training, its f32 parameters cast at each layer)."""

    def __init__(self, dim_l1: int = 128, dim_l2: int = 64,
                 dim_out: int = 32, dim_in: int = 256, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=torch.float32, device=device)
        self.l1 = nn.Linear(dim_in, dim_l1, **kw)
        self.l2 = nn.Linear(dim_l1, dim_l2, **kw)
        self.l3 = nn.Linear(dim_l2, dim_out, **kw)

    def layers(self):
        return (self.l1, self.l2, self.l3)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX module's init: torch-default Linear kernels and biases."""
        with torch.no_grad():
            for lin in self.layers():
                fan_in = lin.in_features
                lin.weight.copy_(torch_linear_kernel(
                    (fan_in, lin.out_features), generator).T)
                lin.bias.copy_(torch_bias(fan_in)(lin.bias.shape, generator))

    @full_f32()   # f32 products in full f32, not TF32
    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        cd = self.dtype
        x = patches.to(cd)
        for lin in self.layers():
            # flax Dense: the product, then the bias
            x = F.relu(x @ lin.weight.T.to(cd) + lin.bias.to(cd))
        return x
