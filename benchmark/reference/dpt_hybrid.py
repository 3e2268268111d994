"""Plain DPT-hybrid depth estimator (Ranftl et al., arXiv:2103.13413) over
a dict of weights: a ResNetV2 with weight-standardized convs and
GroupNorm, a ViT-B/16 over its /16 map with a class token, the 'project'
readout on two taps, reassembly (levels 1 and 2 from the ResNetV2, 3 and
4 from the ViT), then the shared fusion blocks and head
(``reference/dpt_parts.py``); ``depth_maps`` is the captioner's use of it.

The ResNetV2's convolutions pad as XLA's SAME does, where the model was
trained with it (odd pixel at the end); the rest pad symmetrically. NCHW
throughout.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from reference import dpt_parts as P
from reference.ops import F32, Rounding


def _same(size: int, k: int, s: int):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, k, s, value=0.0):
    t, b = _same(x.shape[2], k, s)
    left, right = _same(x.shape[3], k, s)
    return F.pad(x, (left, right, t, b), value=value)


def _std_conv(x, w, p, r, stride=1):
    k = w[p + ".weight"].to(F32)
    var, mean = torch.var_mean(k, dim=(1, 2, 3), correction=0, keepdim=True)
    k = (k - mean) / torch.sqrt(var + 1e-6)
    x = _pad_same(x, k.shape[-1], stride)
    return F.conv2d(r(x), r(k), None, stride)


def _gn(x, w, p, act=True):
    y = F.group_norm(x, 32, w[p + ".gn.weight"].to(F32),
                     w[p + ".gn.bias"].to(F32), 1e-5)
    return F.relu(y) if act else y


def _bottleneck(x, w, p, stride, downsample, r):
    sc = (_gn(_std_conv(x, w, p + ".ds_conv", r, stride), w, p + ".ds_norm",
              False) if downsample else x)
    y = _gn(_std_conv(x, w, p + ".conv1", r), w, p + ".norm1")
    y = _gn(_std_conv(y, w, p + ".conv2", r, stride), w, p + ".norm2")
    y = _gn(_std_conv(y, w, p + ".conv3", r), w, p + ".norm3", False)
    return F.relu(y + sc)


def _resnet(x, w, layers, r) -> List[torch.Tensor]:
    x = _gn(_std_conv(x, w, "resnet.stem_conv", r, 2), w, "resnet.stem_norm")
    x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
    taps = []
    for si, blocks in enumerate(layers):
        for bi in range(blocks):
            x = _bottleneck(x, w, f"resnet.stage{si}_{bi}",
                            2 if si > 0 and bi == 0 else 1, bi == 0, r)
        taps.append(x)
    return taps


def dpt_forward(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict,
                r: Rounding = Rounding()) -> torch.Tensor:
    """[-1, 1] images [B, 3, S, S] -> depth [B, S, S]."""
    patch = cfg["patch"]
    gh, gw = x.shape[2] // patch, x.shape[3] // patch
    tap1, tap2, feat16 = _resnet(x, w, cfg["resnet_layers"], r)
    tokens = P.conv(feat16, w, "patch_proj", r).flatten(2).transpose(1, 2)
    tokens = P.embed(tokens, w, gh, gw, cfg.get("pretrain_grid", 24))
    taps = P.vit(tokens, w, cfg, r)
    hooks = cfg["hooks"]
    l3 = P.conv(P.readout(taps[hooks[0]], w, "pp3_readout", r, gh, gw), w,
                "pp3_conv", r)
    l4 = P.conv(P.conv(P.readout(taps[hooks[1]], w, "pp4_readout", r, gh,
                                 gw), w, "pp4_conv", r),
                w, "pp4_down", r, 2, 1)
    return P.fuse_and_head((tap1, tap2, l3, l4), w, r)


def depth_maps(w: Dict[str, torch.Tensor], images_u8: torch.Tensor,
               cfg: Dict, r: Rounding = Rounding(),
               out_size: int = 224) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> standardized depth maps [B, out, out, 1]."""
    return P.standardized(dpt_forward, w, images_u8, cfg, r, out_size)
