"""Command-line captioning with the port's pipeline.

    python -m depth_image_captioning_pub_torch.cli caption \\
        --images batch.npy [--weights params.npz] [--vocab word_to_id.pkl] \\
        [--device cuda] [--batch-buckets 1,16,64]

``--images`` is a uint8 ``.npy`` array [N, H, W, 3] (or [H, W, 3]);
``--random N`` captions N seeded random images instead. Weights come from
an ``.npz`` that ``utils/jax_bridge.load_npz`` reads (the JAX package's
parameter trees) or, without ``--weights``, are drawn from ``--seed``.
Without ``--vocab`` a placeholder vocabulary of ``--vocab-size`` words is
used, which is only good for seeded weights. Prints one caption per line.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from depth_image_captioning_pub_tpu.config import ConfigEval
from depth_image_captioning_pub_tpu.data.tokenizer import SPECIAL


def placeholder_vocab(size: int) -> Tuple[Dict[str, int], Dict[int, str]]:
    """``size`` words: w0, w1, ... then the four special tokens, in the
    order ``data/vocab.build_vocab`` assigns them."""
    words = [f"w{i}" for i in range(size - 4)]
    words += [SPECIAL.start, SPECIAL.end, SPECIAL.unk, SPECIAL.null]
    return ({w: i for i, w in enumerate(words)},
            {i: w for i, w in enumerate(words)})


def _ints(text: str) -> Tuple[int, ...]:
    return tuple(int(x) for x in text.split(",") if x)


def build_pipeline(args: argparse.Namespace):
    from depth_image_captioning_pub_tpu.data.vocab import load_vocab
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        load_npz, params_from_jax)

    if args.vocab:
        word_to_id, id_to_word = load_vocab(args.vocab)
    else:
        word_to_id, id_to_word = placeholder_vocab(args.vocab_size)
    cfg = ConfigEval()
    cap = build_captioner("base-soft", len(word_to_id), cfg,
                          resnet_layers=args.resnet_layers or None,
                          device=args.device)
    if args.weights:
        params_from_jax(cap, *load_npz(args.weights))
    else:
        cap.init(torch.Generator().manual_seed(args.seed))
    return CaptionPipeline(cap, word_to_id, id_to_word,
                           max_length=args.max_length,
                           batch_buckets=args.batch_buckets,
                           image_hw=(args.image_size, args.image_size))


def caption(args: argparse.Namespace) -> List[str]:
    if args.images:
        images = np.load(args.images)
        if images.ndim == 3:
            images = images[None]
    else:
        rng = np.random.default_rng(args.seed)
        images = rng.integers(0, 256, (args.random, args.image_size,
                                       args.image_size, 3), dtype=np.uint8)
    return build_pipeline(args)(images)


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    c = sub.add_parser("caption", help="caption uint8 image arrays")
    src = c.add_mutually_exclusive_group(required=True)
    src.add_argument("--images", help="uint8 .npy [N,H,W,3] or [H,W,3]")
    src.add_argument("--random", type=int, help="caption N seeded images")
    c.add_argument("--weights", help=".npz of the JAX parameter trees")
    c.add_argument("--vocab", help="word_to_id.pkl")
    c.add_argument("--vocab-size", type=int, default=9956)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--device", default="cuda" if torch.cuda.is_available()
                   else "cpu")
    c.add_argument("--resnet-layers", type=_ints, default=None,
                   help="e.g. 3,8,36,3 (ResNet-152, the default)")
    c.add_argument("--image-size", type=int, default=224)
    c.add_argument("--max-length", type=int, default=30)
    c.add_argument("--batch-buckets", type=_ints, default=(1, 16, 64))
    args = p.parse_args(argv)
    for line in caption(args):
        sys.stdout.write(line + "\n")


if __name__ == "__main__":
    main()
