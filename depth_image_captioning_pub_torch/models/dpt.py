"""DPT-hybrid monocular depth estimator, ViT-B + ResNetV2-50 backbone
(counterpart of the JAX ``models/dpt.py``), inference only.

* ResNetV2 stem (weight-standardized 7x7/2 conv + GroupNorm(32) + ReLU +
  SAME max-pool 3x3/2) and three post-activation bottleneck stages (3, 4, 9)
  with taps after stages 0 (/4) and 1 (/8); every GroupNorm runs the NHWC
  kernel of ``ops/kernels/group_norm.py`` (its plain version on the CPU),
  with the ReLU, or a bottleneck's shortcut add and ReLU, fused into it;
* 1x1 patch projection, class token, position embeddings (bilinearly
  resized for grids other than 24x24), pre-LN transformer blocks with taps
  after blocks 8 and 11; attention runs the CUDA kernel of
  ``ops/kernels/vit_attention.py`` (its plain version on the CPU);
* 'project' readout, reassembly convs, 3x3 scratch convs, four fusion
  blocks with align-corners x2 upsampling (the 1x1 out conv before the
  resize, which the JAX package proves exact), and the head
  conv -> x2 -> conv -> relu -> 1x1 -> relu.

Modules take and return NHWC tensors, as the JAX modules do; convolutions
see them as channels_last NCHW views, so the layout change copies nothing.
The backbone's activations stay contiguous NHWC from the stem's input to
the /16 tap: no GroupNorm, padding or convolution there converts one to
NCHW.
Everything runs in the module's ``dtype`` (bf16 on the card, f32 in the
parity tests), parameters included, except the raw ``StdConv`` kernels,
the class token and the position embeddings, which stay f32 and are cast
where they are used, as in the JAX package.

XLA's SAME padding puts the odd pixel of a stride-2 window at the end
(``lo = total // 2``); ``same_pads`` reproduces it: where the two sides
differ (the stem, the stride-2 3x3 convs, the max-pool) with an explicit
``F.pad`` of the NHWC tensor, since torch's symmetric ``padding`` cannot,
and where they agree (every stride-1 3x3) with the convolution's own zero
padding, which is exact.

Submodule names follow the flax names, so ``utils/jax_bridge.py`` maps the
flax tree path for path. Two of the JAX package's throughput knobs are
constructor arguments here, not module globals: ``gelu="tanh"`` (the JAX
``GELU_APPROXIMATE``: the ViT MLPs' GELU; the readout keeps the exact one,
as in the JAX package) and ``head="lowres"`` (``HEAD_LOW_RES``: head conv2
and conv3 before the x2 upsample). Both change the depth maps and are off
by default. ``DPTDepthEstimator(image_size=224)`` runs the DPT at 224x224:
the position embeddings shrink from 24x24 to 14x14 and the ViT attention
runs at N = 197 tokens. The other TPU knobs (token padding to a multiple
of 8, the two-tap upsample, ablations) are not ported.

Sequence parallelism (the JAX ``TOKEN_SHARDING``) is the constructor
argument ``token_sharding``: a ``parallel/tp.Mesh2D`` over whose model axis
the ``[B, N, C]`` tokens are split between the blocks. The tokens are
padded with zero rows to a multiple of the axis' size and each rank keeps
its contiguous share; LayerNorm and the MLP run on the local tokens,
attention all-gathers them first, so that K5 sees every key, and masks the
pad keys through its ``n_valid``; the taps are gathered and the pad rows
dropped. Tensor parallelism (``parallel/tp.shard_tree``) splits each
block's heads and MLP over the same axis; with both, a block's input is
gathered and its row-parallel outputs reduced and split again over the
tokens (Megatron's sequence parallelism). Neither changes the depth maps
but by the order of the f32 sums.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from depth_image_captioning_pub_torch.ops.image_ops import (
    dpt_normalize, resize_bilinear, standardize_depth_map, to_unit_float)
from depth_image_captioning_pub_torch.ops.kernels import (
    group_norm, vit_attention)
from depth_image_captioning_pub_torch.ops.pooling import nchw, nhwc
from depth_image_captioning_pub_torch.parallel.tp import (
    copy_to_region, gather_from_region, reduce_from_region,
    scatter_to_region)


def resize_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]
                         ) -> torch.Tensor:
    """[B, H, W, C] -> [B, h, w, C], bilinear, align_corners=True."""
    return nhwc(F.interpolate(nchw(x), size=tuple(out_hw), mode="bilinear",
                              align_corners=True))


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis: (before, after), odd pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int,
             value: float = 0.0) -> torch.Tensor:
    """Pad an NHWC tensor for a SAME window of ``kernel``/``stride``."""
    top, bottom = same_pads(x.shape[1], kernel, stride)
    left, right = same_pads(x.shape[2], kernel, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (0, 0, left, right, top, bottom), value=value)


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` with integer (symmetric) padding: NHWC in and out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nhwc(super().forward(nchw(x)))


class StdConv(nn.Module):
    """Weight-standardized conv (timm StdConv2dSame): the f32 kernel is
    normalized per output channel over (in, kh, kw) with the population
    variance and eps 1e-6, cast to ``dtype``; SAME padding."""

    def __init__(self, in_c: int, out_c: int, kernel: int, stride: int = 1,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.empty(
            (out_c, in_c, kernel, kernel), dtype=torch.float32,
            device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(self.weight, dim=(1, 2, 3), correction=0,
                                   keepdim=True)
        w = ((self.weight - mean) / torch.sqrt(var + 1e-6)).to(self.dtype)
        w = w.contiguous(memory_format=torch.channels_last)
        x = x.to(self.dtype)
        top, bottom = same_pads(x.shape[1], self.kernel, self.stride)
        left, right = same_pads(x.shape[2], self.kernel, self.stride)
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x, padding = pad_same(x, self.kernel, self.stride), 0
        return nhwc(F.conv2d(nchw(x), w, stride=self.stride, padding=padding))


class GroupNormAct(nn.Module):
    """GroupNorm(32), eps 1e-5, with optional ReLU (timm GroupNormAct), over
    a contiguous NHWC tensor. ``residual`` (x's shape) is added after the
    norm and a ReLU follows the add, whatever ``act``: a post-activation
    bottleneck's ``relu(norm3(y) + shortcut)``. One call of
    ``group_norm.group_norm_nhwc`` (the kernel on the card)."""

    def __init__(self, channels: int, act: bool = True, groups: int = 32, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.act = act
        self.gn = nn.GroupNorm(groups, channels, eps=1e-5, dtype=dtype,
                               device=device)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        return group_norm.group_norm_nhwc(
            x, self.gn.weight, self.gn.bias, groups=self.gn.num_groups,
            eps=self.gn.eps, relu=self.act or residual is not None,
            residual=residual)


class ResNetV2Bottleneck(nn.Module):
    """Post-activation bottleneck: 1x1+GN+relu -> 3x3(stride)+GN+relu ->
    1x1(4x)+GN, plus the (projected) shortcut, relu after the add (the add
    and the ReLU in ``norm3``'s epilogue)."""

    def __init__(self, in_c: int, mid: int, stride: int = 1,
                 downsample: bool = False, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        out_c = mid * 4
        if downsample:
            self.ds_conv = StdConv(in_c, out_c, 1, stride, **kw)
            self.ds_norm = GroupNormAct(out_c, act=False, **kw)
        self.downsample = downsample
        self.conv1 = StdConv(in_c, mid, 1, **kw)
        self.norm1 = GroupNormAct(mid, **kw)
        self.conv2 = StdConv(mid, mid, 3, stride, **kw)
        self.norm2 = GroupNormAct(mid, **kw)
        self.conv3 = StdConv(mid, out_c, 1, **kw)
        self.norm3 = GroupNormAct(out_c, act=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.ds_norm(self.ds_conv(x)) if self.downsample else x
        y = self.norm1(self.conv1(x))
        y = self.norm2(self.conv2(y))
        return self.norm3(self.conv3(y), residual=shortcut)


class HybridResNetStages(nn.Module):
    """Stem + 3 stages; returns the taps [/4 256ch, /8 512ch, /16 1024ch]."""

    def __init__(self, layers: Sequence[int] = (3, 4, 9), *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.stem_conv = StdConv(3, 64, 7, 2, **kw)
        self.stem_norm = GroupNormAct(64, **kw)
        self.stages: List[List[str]] = []
        in_c = 64
        for si, blocks in enumerate(layers):
            mid = 64 * 2 ** si
            names = []
            for bi in range(blocks):
                name = f"stage{si}_{bi}"
                self.add_module(name, ResNetV2Bottleneck(
                    in_c, mid, stride=2 if (si > 0 and bi == 0) else 1,
                    downsample=(bi == 0), **kw))
                names.append(name)
                in_c = mid * 4
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem_norm(self.stem_conv(x))
        # SAME max-pool 3x3/2 with -inf padding (timm MaxPool2dSame)
        x = nhwc(F.max_pool2d(nchw(pad_same(x, 3, 2, float("-inf"))), 3, 2))
        taps = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            taps.append(x)
        return taps


GELUS = {"erf": "none", "tanh": "tanh"}   # knob -> F.gelu's approximate
HEADS = ("full", "lowres")


def check_knobs(gelu: str, head: str) -> None:
    """Raise on a GELU or head setting the DPT does not have (the JAX
    ``cli.make_depth_fn``'s messages)."""
    if gelu not in GELUS:
        raise ValueError(f"dpt_gelu must be 'erf' or 'tanh', got {gelu!r}")
    if head not in HEADS:
        raise ValueError(f"dpt_head must be 'full' or 'lowres', got "
                         f"{head!r}")


class ViTBlock(nn.Module):
    """Pre-LN transformer block (timm ViT), LayerNorm eps 1e-6, the MLP's
    GELU exact (``gelu="erf"``) or tanh-approximated (``"tanh"``).
    Attention is the fused kernel over Z = batch * heads, on the keys
    below ``n_valid`` (all N by default). ``tp``: the model axis over which
    ``parallel/tp.shard_tree`` split the heads and the MLP; ``sp``: the axis
    over which the tokens are split (``DPTDepthModel(token_sharding=)``)."""

    tp = None
    sp = None

    def __init__(self, dim: int = 768, heads: int = 12, mlp_ratio: int = 4,
                 *, gelu: str = "erf", dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        check_knobs(gelu, "full")
        self.heads = heads
        self.approximate = GELUS[gelu]
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, **kw)
        self.qkv = nn.Linear(dim, 3 * dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, **kw)
        self.fc1 = nn.Linear(dim, dim * mlp_ratio, **kw)
        self.fc2 = nn.Linear(dim * mlp_ratio, dim, **kw)

    def _region_in(self, h: torch.Tensor) -> torch.Tensor:
        """A block input entering the split weights: all tokens (``sp``),
        and a gradient summed over the model ranks (``tp``)."""
        return copy_to_region(gather_from_region(h, self.sp, 1), self.tp)

    def _row(self, h: torch.Tensor, linear: nn.Linear) -> torch.Tensor:
        """A row-parallel ``linear`` (``tp``: this rank's input features,
        the partial sums reduced, then the bias), back on this rank's
        tokens (``sp``)."""
        if self.tp is None:
            return linear(scatter_to_region(h, self.sp, 1))
        y = reduce_from_region(F.linear(h, linear.weight), self.tp)
        return scatter_to_region(y, self.sp, 1) + linear.bias

    def forward(self, x: torch.Tensor,
                n_valid: Optional[int] = None) -> torch.Tensor:
        """K5 runs on this rank's heads (all of them without ``tp``) over
        every token (gathered under ``sp``); the MLP without ``tp`` on
        this rank's tokens."""
        b, d = x.shape[0], x.shape[-1]
        dh = d // self.heads
        h = self._region_in(self.norm1(x))
        n = h.shape[1]
        qkv = self.qkv(h)
        heads = qkv.shape[-1] // (3 * dh)     # this rank's
        # (B, N, 3, heads, dh) -> (3, B*heads, N, dh), one contiguous copy
        # (at B=1 the reshape alone would return a strided view)
        q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(
            2, 0, 3, 1, 4).contiguous().reshape(3, b * heads, n, dh)
        out = vit_attention.fused_attention(
            q, k, v, scale=dh ** -0.5, n_valid=n if n_valid is None
            else n_valid)
        out = out.reshape(b, heads, n, dh).permute(0, 2, 1, 3)
        x = x + self._row(out.reshape(b, n, heads * dh), self.proj)
        h = self.norm2(x)
        if self.tp is None:
            return x + self.fc2(F.gelu(self.fc1(h),
                                       approximate=self.approximate))
        h = F.gelu(self.fc1(self._region_in(h)),
                   approximate=self.approximate)
        return x + self._row(h, self.fc2)


class ProjectReadout(nn.Module):
    """Fold the class token into every patch token: cat + Linear + GELU."""

    def __init__(self, dim: int = 768, *, dtype=torch.float32, device=None):
        super().__init__()
        self.project = nn.Linear(2 * dim, dim, dtype=dtype, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        patches = tokens[:, 1:]
        readout = tokens[:, :1].expand_as(patches)
        x = self.project(torch.cat([patches, readout], dim=-1))
        return F.gelu(x, approximate="none")


class ResidualConvUnit(nn.Module):
    """relu -> conv3x3 -> relu -> conv3x3, plus the input."""

    def __init__(self, features: int = 256, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(padding=1, dtype=dtype, device=device)
        self.conv1 = Conv(features, features, 3, **kw)
        self.conv2 = Conv(features, features, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(x))
        return self.conv2(F.relu(y)) + x


class FeatureFusionBlock(nn.Module):
    """RefineNet-style fusion: add the refined skip, refine, 1x1 out conv,
    then x2 align-corners upsample (the JAX ``OUT_CONV_BEFORE_RESIZE``
    order; a 1x1 conv commutes with the resize exactly)."""

    def __init__(self, features: int = 256, skip: bool = True, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        if skip:
            self.res1 = ResidualConvUnit(features, **kw)
        self.res2 = ResidualConvUnit(features, **kw)
        self.out_conv = Conv(features, features, 1, **kw)

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.res1(skip)
        x = self.out_conv(self.res2(x))
        return resize_align_corners(x, (x.shape[1] * 2, x.shape[2] * 2))


def resize_pos_embed(pos: torch.Tensor, grid_old: int,
                     grid_new: Tuple[int, int]) -> torch.Tensor:
    """Bilinear pos-embed grid resize (half-pixel, no antialiasing), class
    token kept."""
    if (grid_old, grid_old) == tuple(grid_new):
        return pos
    tok, grid = pos[:, :1], pos[:, 1:].reshape(1, grid_old, grid_old, -1)
    grid = resize_bilinear(grid, grid_new)
    return torch.cat([tok, grid.reshape(1, grid_new[0] * grid_new[1], -1)],
                     dim=1)


class DPTDepthModel(nn.Module):
    """images [B, H, W, 3] (DPT-normalized) -> depth [B, H, W]. ``gelu``
    ("erf" or "tanh") is the ViT MLPs' GELU; ``head="lowres"`` runs head
    conv2 and conv3 before the x2 upsample (not exact: a 3x3 conv does not
    commute with the resize). ``token_sharding``: a ``parallel/tp.Mesh2D``
    over whose model axis the ViT tokens are split (None: unsplit)."""

    def __init__(self, features: int = 256, vit_dim: int = 768,
                 vit_heads: int = 12, vit_blocks: int = 12,
                 hooks: Tuple[int, int] = (8, 11),
                 resnet_layers: Sequence[int] = (3, 4, 9), patch: int = 16,
                 pretrain_grid: int = 24, *, gelu: str = "erf",
                 head: str = "full", token_sharding=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        check_knobs(gelu, head)
        kw = dict(dtype=dtype, device=device)
        self.dtype, self.patch, self.hooks = dtype, patch, tuple(hooks)
        self.gelu, self.head = gelu, head
        self.low_res_head = head == "lowres"
        self.pretrain_grid = pretrain_grid
        self.resnet = HybridResNetStages(resnet_layers, **kw)
        self.patch_proj = Conv(1024, vit_dim, 1, **kw)
        self.cls_token = nn.Parameter(torch.zeros(
            (1, 1, vit_dim), dtype=torch.float32, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(
            (1, 1 + pretrain_grid ** 2, vit_dim), dtype=torch.float32,
            device=device))
        self.blocks = []
        for i in range(vit_blocks):
            self.add_module(f"block{i}", ViTBlock(vit_dim, vit_heads,
                                                  gelu=gelu, **kw))
            self.blocks.append(f"block{i}")
        self.token_axis = None
        if token_sharding is not None and token_sharding.model.size > 1:
            self.token_axis = token_sharding.model
            for name in self.blocks:
                getattr(self, name).sp = self.token_axis
        self.pp3_readout = ProjectReadout(vit_dim, **kw)
        self.pp3_conv = Conv(vit_dim, vit_dim, 1, **kw)
        self.pp4_readout = ProjectReadout(vit_dim, **kw)
        self.pp4_conv = Conv(vit_dim, vit_dim, 1, **kw)
        self.pp4_down = Conv(vit_dim, vit_dim, 3, stride=2, padding=1, **kw)
        for i, in_c in enumerate((256, 512, vit_dim, vit_dim), start=1):
            self.add_module(f"layer{i}_rn", Conv(in_c, features, 3, padding=1,
                                                 bias=False, **kw))
        for i in (4, 3, 2, 1):
            self.add_module(f"refinenet{i}", FeatureFusionBlock(
                features, skip=i < 4, **kw))
        self.head_conv1 = Conv(features, features // 2, 3, padding=1, **kw)
        self.head_conv2 = Conv(features // 2, 32, 3, padding=1, **kw)
        self.head_conv3 = Conv(32, 1, 1, **kw)
        self.to(memory_format=torch.channels_last)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers: lecun-normal variance for conv and dense
        kernels (drawn as N(0, 1/fan_in)), zero biases and class token,
        unit norm scales, N(0, 0.02) position embeddings."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name == "pos_embed":
                    std = 0.02
                elif name.endswith("bias") or name == "cls_token":
                    p.zero_()
                    continue
                elif p.dim() == 1:
                    p.fill_(1.0)
                    continue
                else:
                    std = 1.0 / math.sqrt(p[0].numel())
                p.copy_(torch.empty(p.shape, dtype=torch.float32).normal_(
                    0.0, std, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        gh, gw = h // self.patch, w // self.patch
        x = x.to(self.dtype)
        tap1, tap2, feat16 = self.resnet(x)
        tokens = self.patch_proj(feat16).reshape(b, gh * gw, -1)
        dim = tokens.shape[-1]
        pos = resize_pos_embed(self.pos_embed, self.pretrain_grid, (gh, gw))
        tokens = torch.cat([self.cls_token.to(self.dtype).expand(b, 1, dim),
                            tokens], dim=1) + pos.to(self.dtype)
        n = tokens.shape[1]
        sp = self.token_axis
        if sp is not None:         # pad rows to a multiple of the ranks
            tokens = scatter_to_region(
                F.pad(tokens, (0, 0, 0, -n % sp.size)), sp, 1)
        taps = {}
        for i, name in enumerate(self.blocks):
            tokens = getattr(self, name)(tokens, n_valid=n)
            if i in self.hooks:
                taps[i] = tokens
        if sp is not None:
            taps = {i: gather_from_region(t, sp, 1)[:, :n]
                    for i, t in taps.items()}

        def tokens_to_map(t, readout):
            return readout(t).reshape(b, gh, gw, dim)

        l3 = self.pp3_conv(tokens_to_map(taps[self.hooks[0]],
                                         self.pp3_readout))
        l4 = self.pp4_down(self.pp4_conv(tokens_to_map(taps[self.hooks[1]],
                                                       self.pp4_readout)))
        rn = [getattr(self, f"layer{i}_rn")(l)
              for i, l in enumerate((tap1, tap2, l3, l4), start=1)]
        path = self.refinenet4(rn[3])
        path = self.refinenet3(path, rn[2])
        path = self.refinenet2(path, rn[1])
        path = self.refinenet1(path, rn[0])
        y = self.head_conv1(path)
        if not self.low_res_head:
            y = resize_align_corners(y, (y.shape[1] * 2, y.shape[2] * 2))
        y = F.relu(self.head_conv2(y))
        y = F.relu(self.head_conv3(y))
        if self.low_res_head:     # the x2 on one channel instead of 128
            y = resize_align_corners(y, (y.shape[1] * 2, y.shape[2] * 2))
        return y[..., 0]


TINY_DPT = dict(vit_blocks=3, hooks=(1, 2), resnet_layers=(1, 1, 1),
                vit_dim=64, vit_heads=4, features=32)   # at 64x64, for tests


class DPTDepthEstimator:
    """A DPT model and the standardized-depth function over it, on the CUDA
    card unless ``device`` names another. ``image_size`` is the DPT's input
    side (384, or 224 for ``--dpt-size 224``); ``gelu`` and ``head`` go to
    ``DPTDepthModel`` with the other ``model_kwargs``."""

    def __init__(self, dtype=torch.bfloat16, image_size: int = 384,
                 device="cuda", **model_kwargs):
        self.model = DPTDepthModel(dtype=dtype, device=device, **model_kwargs)
        self.image_size = image_size

    def init(self, generator: torch.Generator) -> None:
        self.model.reset_parameters(generator)

    def load_weights(self, path: str) -> None:
        """Load DPT-hybrid weights from ``path``: an Omnidata ``.ckpt``
        (through ``utils/torch_bridge.dpt_to_flax``, at the model's own
        stage and block counts, so a small model reads a small checkpoint)
        or a ``.msgpack`` of that tree (``utils.convert --kind dpt``).
        ``refinenet4``'s first residual unit, which the checkpoint holds
        but the forward never runs (it takes no skip), is left out."""
        from depth_image_captioning_pub_torch.utils import torch_bridge as tb
        from depth_image_captioning_pub_torch.utils.checkpoint import (
            load_component)
        from depth_image_captioning_pub_torch.utils.jax_bridge import (
            dpt_params_from_jax)
        model = self.model
        if path.endswith(".msgpack"):
            tree = load_component(path)
        else:
            tree = tb.dpt_to_flax(
                tb.load_state_dict(path),
                resnet_layers=tuple(len(s) for s in model.resnet.stages),
                vit_blocks=len(model.blocks))
        if not hasattr(model.refinenet4, "res1"):
            tree["params"]["refinenet4"].pop("res1", None)
        dpt_params_from_jax(model, tree)

    def depth_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """fn(images [B,H,W,3], uint8 or [0,1] float) -> standardized depth
        maps [B,224,224,1]: resize to ``image_size``, DPT-normalize, DPT,
        standardize per image, resize to 224."""
        return make_depth_fn(self.model, self.image_size)


def make_depth_fn(model: DPTDepthModel, size: int
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``DPTDepthEstimator.depth_fn`` over ``model`` at input side
    ``size`` (a pipeline's replica of the DPT on another card takes its
    own)."""
    @torch.inference_mode()
    def fn(images: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(to_unit_float(images), (size, size))
        depth = model(dpt_normalize(x))[..., None]
        return resize_bilinear(standardize_depth_map(depth), (224, 224))
    fn.model = model        # the eval cache's key hashes its weights
    fn.image_size = size    # the export records it
    return fn
