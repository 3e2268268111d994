"""Operations of one image through each model stage, and of one caption,
from a configuration's sizes (``configs/*.json``)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple


def conv(cin: int, cout: int, k: int, hout: int, wout: int = None) -> int:
    """Operations of a k x k convolution producing [cout, hout, wout]."""
    return 2 * cin * cout * k * k * hout * (hout if wout is None else wout)


def linear(rows: int, fin: int, fout: int) -> int:
    return 2 * rows * fin * fout


def out_side(size: int, k: int, s: int, p: int) -> int:
    """The output side of a k x k convolution of stride s, padding p."""
    return (size + 2 * p - k) // s + 1


def resnet(layers: Sequence[int], image_size: int = 224) -> int:
    """ResNet (v1.5 bottleneck, stride on the 3x3 conv), one image."""
    h = out_side(image_size, 7, 2, 3)
    ops = conv(3, 64, 7, h)
    h = out_side(h, 3, 2, 1)
    cin = 64
    for stage, blocks in enumerate(layers):
        p = 64 * 2 ** stage
        for b in range(blocks):
            s = 2 if stage > 0 and b == 0 else 1
            ho = out_side(h, 3, s, 1)
            ops += conv(cin, p, 1, h) + conv(p, p, 3, ho) + conv(p, 4 * p, 1,
                                                                 ho)
            if b == 0:
                ops += conv(cin, 4 * p, 1, ho)
            cin, h = 4 * p, ho
    return ops


def vit_blocks(n: int, dim: int, mlp: int, blocks: int) -> int:
    """``blocks`` ViT blocks over ``n`` tokens of width ``dim`` (MLP width
    ``mlp``): qkv, attention's two products, the projection and the MLP."""
    return blocks * (linear(n, dim, 3 * dim) + 2 * 2 * n * n * dim
                     + linear(n, dim, dim) + linear(n, dim, mlp)
                     + linear(n, mlp, dim))


def readout(g: int, dim: int) -> int:
    """One 'project' readout over a g x g grid of tokens."""
    return linear(g * g, 2 * dim, dim)


def fuse_and_head(levels: Sequence[Tuple[int, int]], f: int) -> int:
    """The four reassembled maps, (channels, side) finest first: their 3x3
    convs to ``f`` features, the four fusion blocks and the head."""
    ops = sum(conv(c, f, 3, s) for c, s in levels)    # layer*_rn
    for i, (_, s) in zip((4, 3, 2, 1), reversed(levels)):
        units = 1 if i == 4 else 2                    # res2, and res1
        ops += units * 2 * conv(f, f, 3, s) + conv(f, f, 1, s)
    s = 2 * levels[0][1]
    ops += conv(f, f // 2, 3, s)
    return ops + conv(f // 2, 32, 3, 2 * s) + conv(32, 1, 1, 2 * s)


def depth_cnn(channels: Sequence[int], image_size: int = 224) -> int:
    """The depth CNN on one [224, 224, 1] map."""
    c1, c2, c3 = channels
    h = out_side(image_size, 7, 3, 0)
    ops = conv(1, c1, 7, h)
    h = out_side(h // 3, 3, 1, 0)
    ops += conv(c1, c2, 3, h)
    return ops + conv(c2, c3, 1, h // 3)


def decoder_setup(k: int, d: int, a: int, h: int) -> int:
    """Per row: the features' projection and the initial state."""
    return linear(k, d, a) + linear(1, d, 2 * h)


def decoder_step(k: int, d: int, a: int, e: int, h: int, v: int) -> int:
    """Per row and step: attention, gate, LSTM cell and the vocab head."""
    return 2 * (h * a + k * a + k * d + h * d + (e + d + h) * 4 * h + h * v)


def sizes(cfg: Dict) -> Dict[str, int]:
    """The decoder's sizes of a configuration: K, D, A, E, H, V."""
    return {"k": cfg["enc_img_size"] ** 2, "d": cfg["dim_encoder"],
            "a": cfg["dim_attention"], "e": cfg["dim_embedding"],
            "h": cfg["dim_hidden"], "v": cfg["vocab_size"]}


DptOps = Optional[Callable[[Dict], int]]


def frozen_per_image(cfg: Dict, dpt_ops: DptOps = None) -> int:
    """The frozen stages of one image: the RGB encoder and, with depth,
    the DPT, counted by ``dpt_ops`` (the ``ops`` of the depth model's
    count file, given the ``dpt`` block)."""
    ops = resnet(cfg["resnet_layers"], cfg["image_size"])
    if "dpt" in cfg:
        ops += dpt_ops(cfg["dpt"])
    return ops


def caption(cfg: Dict, steps: int, dpt_ops: DptOps = None) -> int:
    """One caption whose decode ran ``steps`` steps: the frozen stages
    (the DPT's counted by ``dpt_ops``), the depth CNN, the decoder's
    set-up and its steps."""
    z = sizes(cfg)
    ops = frozen_per_image(cfg, dpt_ops) + decoder_setup(
        z["k"], z["d"], z["a"], z["h"])
    if "depth_cnn" in cfg:
        ops += depth_cnn(cfg["depth_cnn"]["channels"], cfg["image_size"])
    return ops + steps * decoder_step(**z)
