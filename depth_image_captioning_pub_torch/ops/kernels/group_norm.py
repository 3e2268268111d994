"""GroupNorm over NHWC activations with a fused epilogue: CUDA kernel
wrapper, planner and plain version.

Over x [B, H, W, C] (contiguous, C innermost) and G groups of C/G channels:

  mean, var  of each image's group over H*W x C/G values, f32 (population)
  a = rstd * weight, b = bias - mean * a       per channel, f32
  y = round(x * a + b)                         in x's dtype
  y = round(y + residual)                      f32 add (with ``residual``)
  y = relu(y)                                  (with ``relu``)

the rounding points of ``nn.GroupNorm`` followed by ``relu(y + shortcut)``,
but for one: on the card ``nn.GroupNorm`` in bf16 applies its mean and
rstd rounded to bf16, where these stay f32.
``group_norm_nhwc`` launches ``csrc/group_norm.cu`` for CUDA tensors and
``group_norm_nhwc_plain`` for CPU tensors, through operator
``dcap::group_norm_nhwc`` (``library.py``). The kernel replaces no TPU
kernel (XLA fuses the JAX package's GroupNorm): it keeps the DPT's
ResNetV2 backbone in NHWC, where PyTorch's CUDA GroupNorm takes NCHW only.
Two launches a call (the statistics, then the apply pass with the
epilogue) on a grid of tiles of rows of H*W by images that ``plan`` sizes
from H*W and C alone, so that an image's result does not depend on the
batch it comes in.
The kernel takes G = 32, bf16 or f32, C a multiple of 32 up to 1024 whose
groups tile its 16-byte vectors (C/G divides 8 bf16 or 4 f32 values, or is
a multiple of them), and no tensor that needs a gradient; the wrapper
raises outside that envelope.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from depth_image_captioning_pub_torch.ops.kernels import _build, library
from depth_image_captioning_pub_torch.ops.kernels.decode_step import (
    FEATURE_DTYPES, check_kernel_device, cuda_pointers)

LAUNCHES = 0   # kernel launches of dcap_group_norm_nhwc (two a call)

GROUPS = 32            # kGroups: the kernel's group count
THREADS = 256          # kThreads
MAX_CHANNELS = 1024    # kMaxChannels
MAX_TILES = 128        # tiles an image at most: each apply block merges all
TILE_STEPS = 16        # row steps a tile (64 KB of x: 72 tiles an image and
#                        4,608 blocks at the backbone's largest shape, B=64)


def plan(hw: int, c: int, vec: int) -> Tuple[int, int]:
    """(tiles an image, rows a tile) of both launches over x [B, hw, c]
    read in vectors of ``vec`` values: TILE_STEPS steps of THREADS / (c /
    vec) rows a tile, more where an image would have over MAX_TILES tiles.
    The tiling does not depend on B, so neither do the order of the
    statistic sums and the output: an image normalises to the same bits in
    any batch."""
    rows_step = THREADS // (c // vec)
    steps = -(-hw // rows_step)
    per = max(TILE_STEPS, -(-steps // MAX_TILES))
    return -(-steps // per), per * rows_step


def group_norm_nhwc_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, *, groups: int = GROUPS,
                          eps: float = 1e-5, relu: bool = False,
                          residual: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, the same rounding points."""
    f32 = torch.float32
    b, h, w, c = x.shape
    cpg = c // groups
    var, mean = torch.var_mean(x.to(f32).reshape(b, h * w, groups, cpg),
                               dim=(1, 3), correction=0)
    rstd = torch.rsqrt(var + eps).repeat_interleave(cpg, dim=1)   # [B, C]
    a = rstd * weight.to(f32)
    shift = bias.to(f32) - mean.repeat_interleave(cpg, dim=1) * a
    y = (x.to(f32) * a[:, None, None] + shift[:, None, None]).to(x.dtype)
    if residual is not None:
        y = (y.to(f32) + residual.to(f32)).to(x.dtype)
    return torch.relu(y) if relu else y


def group_norm_nhwc(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, *, groups: int = GROUPS,
                    eps: float = 1e-5, relu: bool = False,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm of x [B, H, W, C] over ``groups`` groups with the affine
    ``weight``, ``bias`` [C], then ``+ residual`` (x's shape) and ReLU where
    asked; returns [B, H, W, C] in x's dtype. Runs operator
    ``dcap::group_norm_nhwc``: CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    shape, dtype, dev = x.shape, x.dtype, x.device
    if len(shape) != 4 or min(shape[:3]) < 1:
        raise ValueError(f"x must be [B>=1, H>=1, W>=1, C], got "
                         f"{tuple(shape)}")
    if dtype not in FEATURE_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {dtype}")
    c = shape[3]
    if groups < 1 or c < groups or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"weight and bias must be ({c},), got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    if residual is not None and residual.shape != shape:
        raise ValueError(f"residual has shape {tuple(residual.shape)}, x "
                         f"{tuple(shape)}")
    others = (weight, bias) if residual is None else (weight, bias, residual)
    if any(t.dtype != dtype for t in others):
        raise TypeError(f"weight, bias and residual must be {dtype}, got "
                        f"{[t.dtype for t in others]}")
    if any(t.device != dev for t in others):
        raise ValueError(f"weight, bias and residual must be on {dev}, got "
                         f"{[t.device for t in others]}")
    check_kernel_device(dev)
    if (torch.is_grad_enabled() and dev.type == "cuda"
            and (x.requires_grad or any(t.requires_grad for t in others))):
        raise ValueError("the GroupNorm kernel has no backward: call it "
                         "under torch.no_grad() or inference_mode(), or on "
                         "tensors that need no gradient")
    return torch.ops.dcap.group_norm_nhwc(x, weight, bias, residual,
                                          int(groups), float(eps), bool(relu))


def _gn_cpu(x, weight, bias, residual, groups, eps, relu):
    return group_norm_nhwc_plain(x, weight, bias, groups=groups, eps=eps,
                                 relu=relu, residual=residual)


def _gn_fake(x, weight, bias, residual, groups, eps, relu):
    return x.new_empty(x.shape)


def _gn_cuda(x, weight, bias, residual, groups, eps, relu):
    """The two kernel launches of ``dcap::group_norm_nhwc``."""
    global LAUNCHES
    b, h, w, c = x.shape
    vec = 16 // x.element_size()
    cpg = c // groups
    if groups != GROUPS:
        raise ValueError(f"the kernel takes {GROUPS} groups, got {groups}")
    if c % vec or c > MAX_CHANNELS or (cpg % vec and vec % cpg):
        raise ValueError(
            f"C={c} in {x.dtype}: the kernel reads 16-byte vectors of "
            f"{vec} channels, so C must be a multiple of {vec}, at most "
            f"{MAX_CHANNELS}, with C/{GROUPS} dividing {vec} or a multiple "
            f"of it")
    named = [("x", x), ("weight", weight), ("bias", bias)]
    if residual is not None:
        named.append(("residual", residual))
    ptrs = cuda_pointers(named)
    if ptrs[0] % 16 or (residual is not None and ptrs[3] % 16):
        raise ValueError("x and residual must start on 16-byte boundaries "
                         "(the kernel reads them in 16-byte vectors)")
    tiles, rows = plan(h * w, c, vec)
    y = torch.empty_like(x)
    part = torch.empty(b * tiles * GROUPS * 2, dtype=torch.float32,
                       device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcap_group_norm_nhwc(
            ptrs[0], ptrs[1], ptrs[2], ptrs[3] if residual is not None
            else None, y.data_ptr(), part.data_ptr(),
            int(x.dtype == torch.bfloat16), b, h * w, c, tiles, rows,
            float(eps), int(relu), stream)
    _build.check_launch(err, "dcap_group_norm_nhwc")
    LAUNCHES += 2
    return y


library.implement("group_norm_nhwc", _gn_cpu, _gn_cuda, _gn_fake)
