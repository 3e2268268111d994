"""The DPT-hybrid (``reference/dpt_hybrid.py``) at ``cfg["image_size"]``,
one image: the ResNetV2 stages, the patch projection, the ViT blocks, two
readouts, the reassembly, the fusion blocks and the head; and the shapes
of its GroupNorms, which K6 runs."""

from __future__ import annotations

from typing import Dict, List, Tuple

from counts.models import (conv, fuse_and_head, out_side, readout,
                           vit_blocks)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _backbone(cfg: Dict):
    """The ResNetV2 (SAME padding: a stride-s output is ceil(side / s)):
    (operations, taps as (channels, side), GroupNorms as (side, channels,
    with the residual))."""
    h = _ceil(cfg["image_size"], 2)
    ops = conv(3, 64, 7, h)
    norms = [(h, 64, False)]                          # stem_norm
    h = _ceil(h, 2)
    cin, taps = 64, []
    for si, n in enumerate(cfg["resnet_layers"]):
        mid = 64 * 2 ** si
        for bi in range(n):
            s = 2 if si > 0 and bi == 0 else 1
            ho = _ceil(h, s)
            ops += conv(cin, mid, 1, h) + conv(mid, mid, 3, ho)
            ops += conv(mid, 4 * mid, 1, ho)
            norms += [(h, mid, False), (ho, mid, False), (ho, 4 * mid, True)]
            if bi == 0:
                ops += conv(cin, 4 * mid, 1, ho)
                norms.append((ho, 4 * mid, False))    # ds_norm
            cin, h = 4 * mid, ho
        taps.append((cin, h))
    return ops, taps, norms


def ops(cfg: Dict) -> int:
    size, patch, f = cfg["image_size"], cfg["patch"], cfg["features"]
    dim = cfg["vit_dim"]
    ops, taps, _ = _backbone(cfg)
    cin = taps[-1][0]
    g = size // patch
    ops += conv(cin, dim, 1, g)                       # patch projection
    ops += vit_blocks(1 + g * g, dim, dim * cfg.get("mlp_ratio", 4),
                      cfg["vit_blocks"])
    ops += 2 * readout(g, dim)
    ops += 2 * conv(dim, dim, 1, g)                   # pp3_conv, pp4_conv
    g4 = out_side(g, 3, 2, 1)
    ops += conv(dim, dim, 3, g4)                      # pp4_down
    return ops + fuse_and_head([taps[0], taps[1], (dim, g), (dim, g4)], f)


def group_norms(cfg: Dict) -> List[Tuple[int, int, bool]]:
    """The GroupNorms of one forward, in order: (side, channels, with the
    residual added in its epilogue)."""
    return _backbone(cfg)[2]
