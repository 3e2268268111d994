"""Pieces of a plain DPT (Ranftl et al., arXiv:2103.13413) that every
backbone shares, over a dict of weights in ``DPTDepthModel``'s names: the
class token and position embeddings, the ViT blocks, the 'project'
readout, the reassembled maps' 3x3 convs to ``features``, the four
RefineNet fusion blocks and the head; and the captioner's use of a DPT
(``standardized``). A model's own file (``reference/<model>.py``) puts
its backbone and reassembly between them.

Attention is softmax(q k^T / sqrt(d)) v, written out; convolutions pad
symmetrically. NCHW throughout.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from reference.ops import F32, Rounding


def conv(x, w, p, r, stride=1, padding=0):
    b = w.get(p + ".bias")
    return F.conv2d(r(x), r(w[p + ".weight"]),
                    None if b is None else b.to(F32), stride, padding)


def linear(x, w, p, r):
    return F.linear(r(x), r(w[p + ".weight"]), w[p + ".bias"].to(F32))


def embed(tokens, w, gh: int, gw: int, grid: int) -> torch.Tensor:
    """Patch tokens [B, gh*gw, dim] with the class token before them and
    the position embeddings (of a ``grid`` x ``grid`` pretraining grid,
    resized bilinearly to gh x gw where they differ) added."""
    b, _, dim = tokens.shape
    pos = w["pos_embed"].to(F32)
    if (gh, gw) != (grid, grid):
        tok, g = pos[:, :1], pos[:, 1:].reshape(1, grid, grid, dim)
        g = F.interpolate(g.permute(0, 3, 1, 2), size=(gh, gw),
                          mode="bilinear", align_corners=False)
        pos = torch.cat([tok, g.permute(0, 2, 3, 1).reshape(1, gh * gw, dim)],
                        1)
    return torch.cat([w["cls_token"].to(F32).expand(b, 1, dim), tokens],
                     1) + pos


def _block(x, w, p, heads, r):
    b, n, d = x.shape
    dh = d // heads
    h = F.layer_norm(x, (d,), w[p + ".norm1.weight"].to(F32),
                     w[p + ".norm1.bias"].to(F32), 1e-6)
    q, k, v = linear(h, w, p + ".qkv", r).reshape(
        b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    att = torch.softmax((r(q) @ r(k).transpose(-1, -2)) * dh ** -0.5, -1)
    out = (r(att) @ r(v)).transpose(1, 2).reshape(b, n, d)
    x = x + linear(out, w, p + ".proj", r)
    h = F.layer_norm(x, (d,), w[p + ".norm2.weight"].to(F32),
                     w[p + ".norm2.bias"].to(F32), 1e-6)
    return x + linear(F.gelu(linear(h, w, p + ".fc1", r)), w, p + ".fc2", r)


def vit(tokens, w, cfg: Dict, r) -> Dict[int, torch.Tensor]:
    """The ViT blocks ``block0..`` over ``tokens``; the tokens after each
    block that ``cfg["hooks"]`` names, by block."""
    taps = {}
    for i in range(cfg["vit_blocks"]):
        tokens = _block(tokens, w, f"block{i}", cfg["vit_heads"], r)
        if i in cfg["hooks"]:
            taps[i] = tokens
    return taps


def readout(t, w, p, r, gh: int, gw: int) -> torch.Tensor:
    """'project' readout: the class token folded into every patch token
    (cat, Linear, GELU), as a map [B, dim, gh, gw]."""
    patches = t[:, 1:]
    y = F.gelu(linear(torch.cat([patches, t[:, :1].expand_as(patches)], -1),
                      w, p + ".project", r))
    return y.transpose(1, 2).reshape(t.shape[0], -1, gh, gw)


def _rcu(x, w, p, r):
    y = conv(F.relu(x), w, p + ".conv1", r, padding=1)
    return conv(F.relu(y), w, p + ".conv2", r, padding=1) + x


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def _fusion(x, w, p, r, skip=None):
    if skip is not None:
        x = x + _rcu(skip, w, p + ".res1", r)
    return _up2(conv(_rcu(x, w, p + ".res2", r), w, p + ".out_conv", r))


def fuse_and_head(levels: Sequence[torch.Tensor], w, r) -> torch.Tensor:
    """The four reassembled maps (finest first) -> depth [B, S, S]:
    ``layer<i>_rn``, ``refinenet4..1`` and the head."""
    rn: List[torch.Tensor] = [conv(t, w, f"layer{i}_rn", r, padding=1)
                              for i, t in enumerate(levels, start=1)]
    path = _fusion(rn[3], w, "refinenet4", r)
    path = _fusion(path, w, "refinenet3", r, rn[2])
    path = _fusion(path, w, "refinenet2", r, rn[1])
    path = _fusion(path, w, "refinenet1", r, rn[0])
    y = _up2(conv(path, w, "head_conv1", r, padding=1))
    y = F.relu(conv(y, w, "head_conv2", r, padding=1))
    y = F.relu(conv(y, w, "head_conv3", r))
    return y[:, 0]


def standardized(forward: Callable, w: Dict[str, torch.Tensor],
                 images_u8: torch.Tensor, cfg: Dict, r: Rounding,
                 out_size: int) -> torch.Tensor:
    """The captioner's use of a DPT ``forward(w, x, cfg, r)``: uint8
    [B, H, W, 3] resized to ``cfg["image_size"]``, normalized to [-1, 1],
    the map standardized per image (min-max) and resized to
    ``out_size`` -> [B, out, out, 1]."""
    size = cfg["image_size"]
    x = images_u8.to(F32).permute(0, 3, 1, 2) / 255.0
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False)
    d = forward(w, x * 2.0 - 1.0, cfg, r)[:, None]
    d = torch.nan_to_num(d, nan=0.5)
    lo = d.amin(dim=(1, 2, 3), keepdim=True)
    hi = d.amax(dim=(1, 2, 3), keepdim=True)
    d = F.interpolate((d - lo) / (hi - lo), size=(out_size, out_size),
                      mode="bilinear", align_corners=False, antialias=False)
    return d.permute(0, 2, 3, 1)
