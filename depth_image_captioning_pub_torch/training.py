"""Train caption models with the port (the counterpart of the JAX package's
``base_main.py`` and ``depth_main.py``, as ``evaluation.py`` is of its
evaluation scripts):

    python -m depth_image_captioning_pub_torch.training base {soft|hard} {coco|original}
    python -m depth_image_captioning_pub_torch.training base nic
    python -m depth_image_captioning_pub_torch.training depth {soft|hard} {cnn|mlp} {coco|original}

Each configuration trains ``--exp-time`` times (default 3, runs 0, 1, 2)
for ``--epochs`` epochs (default ``ConfigTrain.num_epochs``), on the CUDA
card unless ``--device cpu``, from the dataset, vocabulary and output
directories of ``ConfigTrain`` (paths relative to the working directory).
Each run writes its CSV and JSONL losses and its best-validation
components in the JAX trainer's files under ``exp_result/``, which
``evaluation.py`` and the JAX evaluation scripts read.

The depth grammar first builds the train set's depth-map cache with the
DPT (``engine/depth_cache.py``, under the configuration's save directory;
reused when complete) and computes validation depth per batch;
``--no-depth-cache`` computes both per batch. ``--dpt-size``, ``--gelu`` and
``--dpt-head`` set the DPT's input side and knobs (``cli.add_dpt_flags``);
``--dpt-weights`` (or $DPT_WEIGHTS) names the Omnidata DPT-hybrid
``.ckpt`` (or ``utils.convert``'s ``.msgpack`` of it); without weights
the DPT is drawn at random with a warning. ``--resnet-weights`` (or
$RESNET152_WEIGHTS) takes torchvision's ResNet-152 ``.pth``
(IMAGENET1K_V2) or an encoder msgpack file (a trainer's
``*_encoder_best_*.pth.msgpack``, or ``utils.convert --kind
resnet152``'s); without it the backbone is drawn at random with a
warning. $DCAP_RESNET_LAYERS and $DCAP_TINY_DPT shrink the backbone and
the DPT.

``--checkpoint-every N`` writes a full-state checkpoint every N epochs
(``--checkpoint-keep K`` keeps the newest K) and arms the SIGTERM save: a
preempted run saves where it stopped, mid-epoch or at an epoch's end,
and exits with status 0. ``--resume`` continues each run from its latest
checkpoint, a mid-epoch one at the next batch, as the straight run would
have gone on (``engine/train.train``).

Not ported yet, each exits with status 2 naming its ROADMAP.md item:
``--feature-cache``, ``--grad-accum`` above 1, ``--decoder-dtype
bfloat16`` and ``--profile*``.
"""

from __future__ import annotations

import argparse
import random
import sys
from typing import List, Optional

import numpy as np
import torch

from depth_image_captioning_pub_torch import cli
from depth_image_captioning_pub_torch.config import ConfigTrain
from depth_image_captioning_pub_torch.engine.steps import TRAIN_REST_ITEM

EXP_TIME = 3
DATAS = ("coco", "original")
USAGE = ("training base {soft|hard} {coco|original} | base nic | "
         "depth {soft|hard} {cnn|mlp} {coco|original}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("words", nargs="+", help=USAGE)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--exp-time", type=int, default=EXP_TIME)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--no-depth-cache", action="store_true",
                   help="depth: compute train depth maps per batch too")
    p.add_argument("--dpt-weights", default=None)
    p.add_argument("--resnet-weights", default=None)
    cli.add_dpt_flags(p)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="full-state checkpoint every N epochs; arms the "
                        "SIGTERM save")
    p.add_argument("--checkpoint-keep", type=int, default=0,
                   help="keep the newest K checkpoints (0: all)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest full-state checkpoint")
    # not ported yet: exit 2 when asked for
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--decoder-dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--feature-cache", action="store_true")
    p.add_argument("--profile", default=None)
    p.add_argument("--profile-start", type=int, default=None)
    p.add_argument("--profile-stop", type=int, default=None)
    return p


def _unported(args: argparse.Namespace) -> List[str]:
    """The unported flags asked for, each with its ROADMAP.md item."""
    asked = []
    if args.feature_cache:
        asked.append(f"--feature-cache ({TRAIN_REST_ITEM}.2)")
    if args.grad_accum != 1:
        asked.append(f"--grad-accum ({TRAIN_REST_ITEM}.3)")
    if args.decoder_dtype != "float32":
        asked.append(f"--decoder-dtype bfloat16 ({TRAIN_REST_ITEM}.4)")
    for flag in ("profile", "profile_start", "profile_stop"):
        if getattr(args, flag) is not None:
            asked.append(f"--{flag.replace('_', '-')} ({TRAIN_REST_ITEM}.5)")
    return asked


def _kind(words: List[str]):
    """(kind, use_data, depth encoder) of the grammar, or None."""
    if words == ["base", "nic"]:
        return "nic", "coco", None
    if (len(words) == 3 and words[0] == "base"
            and words[1] in ("soft", "hard") and words[2] in DATAS):
        return f"base-{words[1]}", words[2], None
    if (len(words) == 4 and words[0] == "depth"
            and words[1] in ("soft", "hard") and words[2] in ("cnn", "mlp")
            and words[3] in DATAS):
        prefix = "depth" if words[2] == "cnn" else "mdepth"
        return f"{prefix}-{words[1]}", words[3], words[2]
    return None


def depth_providers(cfg: ConfigTrain, atten: str, use_data: str, device,
                    cache: bool):
    """(train provider, val provider) of a depth run: the train set's depth
    cache (built first if it is not complete) and per-batch validation
    depth, or per-batch depth for both."""
    from depth_image_captioning_pub_torch.data.coco import CocoCaptions
    from depth_image_captioning_pub_torch.engine.depth_cache import (
        DepthMapCache, cached_depth_provider, online_depth_provider)
    depth_fn = cli.eval_depth_fn(cfg, device)
    online = online_depth_provider(depth_fn, device)
    if not cache:
        return online, online
    use_ori = use_data == "original"
    anno = cfg.ori_train_anno_file if use_ori else cfg.train_anno_file
    train_ds = CocoCaptions(cfg.train_img_directory, anno)
    dc = DepthMapCache(f"{cfg.save_dir('depth_' + atten, use_ori)}"
                       f"/depth_cache_{use_data}.npy", len(train_ds))
    if not dc.exists():
        dc.build(train_ds, depth_fn, device)
    return cached_depth_provider(dc), online


def main(argv: Optional[List[str]] = None) -> int:
    from depth_image_captioning_pub_torch.engine.train import train
    args = build_parser().parse_args(argv)
    asked = _unported(args)
    if asked:
        print(f"{', '.join(asked)}: not ported yet", file=sys.stderr)
        return 2
    parsed = _kind(args.words)
    if parsed is None:
        print(f"input {USAGE}", file=sys.stderr)
        return 1
    kind, use_data, _ = parsed
    cfg = ConfigTrain()
    cfg.checkpoint_keep = args.checkpoint_keep
    cfg.dpt_image_size, cfg.dpt_gelu, cfg.dpt_head = (
        args.dpt_size, args.gelu, args.dpt_head)
    if args.dpt_weights:
        cfg.dpt_weights = args.dpt_weights
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    provider = val_provider = None
    if kind not in ("nic",) and not kind.startswith("base"):
        provider, val_provider = depth_providers(
            cfg, args.words[1], use_data, args.device,
            cache=not args.no_depth_cache)
    layers = cli.resnet_layers_from_env()
    resnet = cli.load_resnet_variables(args.resnet_weights, kind == "nic",
                                       layers)
    for ext in range(args.exp_time):
        out = train(kind, ext=ext, use_data=use_data, cfg=cfg,
                    depth_provider=provider, val_depth_provider=val_provider,
                    num_epochs=args.epochs, resnet_variables=resnet,
                    resnet_layers=layers, device=args.device,
                    checkpoint_every=args.checkpoint_every,
                    resume=args.resume)
        if out.get("preempted"):    # stop cleanly; --resume continues
            return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
