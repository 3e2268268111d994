"""Plain DPT-hybrid depth estimator (Ranftl et al., arXiv:2103.13413) over
a dict of weights: a ResNetV2 with weight-standardized convs and
GroupNorm, a ViT-B/16 over its /16 map with a class token, the 'project'
readout, reassembly, four RefineNet fusion blocks and the head; then the
captioner's use of it: resize 224 -> ``image_size``, normalize to [-1, 1],
the map standardized per image (min-max) and resized back to 224.

Convolutions pad as XLA's SAME does where the model was trained with it
(the ResNetV2, odd pixel at the end), symmetrically elsewhere. Attention
is softmax(q k^T / sqrt(d)) v, written out. NCHW throughout.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

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


def _conv(x, w, p, r, stride=1, padding=0):
    b = w.get(p + ".bias")
    return F.conv2d(r(x), r(w[p + ".weight"]),
                    None if b is None else b.to(F32), stride, padding)


def _linear(x, w, p, r):
    return F.linear(r(x), r(w[p + ".weight"]), w[p + ".bias"].to(F32))


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


def _block(x, w, p, heads, r):
    b, n, d = x.shape
    dh = d // heads
    h = F.layer_norm(x, (d,), w[p + ".norm1.weight"].to(F32),
                     w[p + ".norm1.bias"].to(F32), 1e-6)
    q, k, v = _linear(h, w, p + ".qkv", r).reshape(
        b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    att = torch.softmax((r(q) @ r(k).transpose(-1, -2)) * dh ** -0.5, -1)
    out = (r(att) @ r(v)).transpose(1, 2).reshape(b, n, d)
    x = x + _linear(out, w, p + ".proj", r)
    h = F.layer_norm(x, (d,), w[p + ".norm2.weight"].to(F32),
                     w[p + ".norm2.bias"].to(F32), 1e-6)
    return x + _linear(F.gelu(_linear(h, w, p + ".fc1", r)), w, p + ".fc2", r)


def _rcu(x, w, p, r):
    y = _conv(F.relu(x), w, p + ".conv1", r, padding=1)
    return _conv(F.relu(y), w, p + ".conv2", r, padding=1) + x


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def _fusion(x, w, p, r, skip=None):
    if skip is not None:
        x = x + _rcu(skip, w, p + ".res1", r)
    return _up2(_conv(_rcu(x, w, p + ".res2", r), w, p + ".out_conv", r))


def dpt_forward(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict,
                r: Rounding = Rounding()) -> torch.Tensor:
    """[-1, 1] images [B, 3, S, S] -> depth [B, S, S]."""
    b = x.shape[0]
    patch = cfg["patch"]
    gh, gw = x.shape[2] // patch, x.shape[3] // patch
    tap1, tap2, feat16 = _resnet(x, w, cfg["resnet_layers"], r)
    tokens = _conv(feat16, w, "patch_proj", r).flatten(2).transpose(1, 2)
    dim = tokens.shape[-1]
    pos = w["pos_embed"].to(F32)
    grid = cfg.get("pretrain_grid", 24)
    if (gh, gw) != (grid, grid):
        tok, g = pos[:, :1], pos[:, 1:].reshape(1, grid, grid, dim)
        g = F.interpolate(g.permute(0, 3, 1, 2), size=(gh, gw),
                          mode="bilinear", align_corners=False)
        pos = torch.cat([tok, g.permute(0, 2, 3, 1).reshape(1, gh * gw, dim)],
                        1)
    tokens = torch.cat([w["cls_token"].to(F32).expand(b, 1, dim), tokens],
                       1) + pos
    hooks = cfg["hooks"]
    taps = {}
    for i in range(cfg["vit_blocks"]):
        tokens = _block(tokens, w, f"block{i}", cfg["vit_heads"], r)
        if i in hooks:
            taps[i] = tokens

    def to_map(t, p):
        patches = t[:, 1:]
        y = F.gelu(_linear(torch.cat([patches, t[:, :1].expand_as(patches)],
                                     -1), w, p + ".project", r))
        return y.transpose(1, 2).reshape(b, dim, gh, gw)

    l3 = _conv(to_map(taps[hooks[0]], "pp3_readout"), w, "pp3_conv", r)
    l4 = _conv(_conv(to_map(taps[hooks[1]], "pp4_readout"), w, "pp4_conv", r),
               w, "pp4_down", r, 2, 1)
    rn = [_conv(t, w, f"layer{i}_rn", r, padding=1)
          for i, t in enumerate((tap1, tap2, l3, l4), start=1)]
    path = _fusion(rn[3], w, "refinenet4", r)
    path = _fusion(path, w, "refinenet3", r, rn[2])
    path = _fusion(path, w, "refinenet2", r, rn[1])
    path = _fusion(path, w, "refinenet1", r, rn[0])
    y = _up2(_conv(path, w, "head_conv1", r, padding=1))
    y = F.relu(_conv(y, w, "head_conv2", r, padding=1))
    y = F.relu(_conv(y, w, "head_conv3", r))
    return y[:, 0]


def depth_maps(w: Dict[str, torch.Tensor], images_u8: torch.Tensor,
               cfg: Dict, r: Rounding = Rounding(),
               out_size: int = 224) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> standardized depth maps [B, out, out, 1]."""
    size = cfg["image_size"]
    x = images_u8.to(F32).permute(0, 3, 1, 2) / 255.0
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False)
    d = dpt_forward(w, x * 2.0 - 1.0, cfg, r)[:, None]
    d = torch.nan_to_num(d, nan=0.5)
    lo = d.amin(dim=(1, 2, 3), keepdim=True)
    hi = d.amax(dim=(1, 2, 3), keepdim=True)
    d = F.interpolate((d - lo) / (hi - lo), size=(out_size, out_size),
                      mode="bilinear", align_corners=False, antialias=False)
    return d.permute(0, 2, 3, 1)
