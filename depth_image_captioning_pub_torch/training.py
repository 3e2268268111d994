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
``--dpt-weights`` behaves as in ``evaluation.py`` (the Omnidata loader is
not ported, so an existing file raises; without weights the DPT is drawn
at random with a warning). ``--resnet-weights`` takes an encoder file in
the JAX trainer's msgpack format (``*_encoder_best_*.pth.msgpack``);
without it, or $RESNET152_WEIGHTS, the backbone is drawn at random with a
warning. $DCAP_RESNET_LAYERS and $DCAP_TINY_DPT shrink the backbone and
the DPT.

Not ported yet, each exits with status 2 naming its ROADMAP.md item: a
torchvision ``.pth`` for ``--resnet-weights``, ``--grad-accum`` above 1,
``--decoder-dtype bfloat16``, ``--checkpoint-every``, ``--checkpoint-keep``,
``--resume``, ``--feature-cache`` and ``--profile*``.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
from typing import List, Optional

import numpy as np
import torch

from depth_image_captioning_pub_torch import cli
from depth_image_captioning_pub_torch.config import ConfigTrain

EXP_TIME = 3
DATAS = ("coco", "original")
TRAIN_REST = ("ROADMAP.md, Queue A item 7: full-state checkpoints, resume "
              "and preemption, the feature cache, gradient accumulation, "
              "the bf16 decoder and the profiler")
PTH_ITEM = ("reading a torchvision .pth is not ported yet (ROADMAP.md, "
            "Queue A item 3)")
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
    # not ported yet: exit 2 when asked for
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--decoder-dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--checkpoint-keep", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--feature-cache", action="store_true")
    p.add_argument("--profile", default=None)
    p.add_argument("--profile-start", type=int, default=None)
    p.add_argument("--profile-stop", type=int, default=None)
    return p


def _unported(args: argparse.Namespace) -> List[str]:
    asked = []
    if args.grad_accum != 1:
        asked.append("--grad-accum")
    if args.decoder_dtype != "float32":
        asked.append("--decoder-dtype bfloat16")
    for flag in ("checkpoint_every", "checkpoint_keep", "resume",
                 "feature_cache", "profile", "profile_start",
                 "profile_stop"):
        if getattr(args, flag):
            asked.append("--" + flag.replace("_", "-"))
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


def load_resnet_variables(path: Optional[str], nic: bool):
    """The frozen encoder's flax tree from an encoder file that the JAX
    trainer (or this one) wrote; None, with a warning, without a file.
    NIC takes the backbone's own ``{"params", "batch_stats"}``."""
    from depth_image_captioning_pub_torch.utils.checkpoint import (
        load_component)
    path = path or os.environ.get("RESNET152_WEIGHTS")
    if not path or not os.path.exists(path):
        print("WARNING: no ResNet-152 weights (set --resnet-weights or "
              "$RESNET152_WEIGHTS); encoder uses random init",
              file=sys.stderr)
        return None
    tree = load_component(path)
    if nic and "backbone" in tree["params"]:
        return {"params": tree["params"]["backbone"],
                "batch_stats": tree["batch_stats"]["backbone"]}
    return tree


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
        print(f"{', '.join(asked)}: not ported yet ({TRAIN_REST})",
              file=sys.stderr)
        return 2
    if args.resnet_weights and args.resnet_weights.endswith(
            (".pth", ".pt", ".ckpt")) and not os.path.exists(
                args.resnet_weights + ".msgpack"):
        print(f"--resnet-weights {args.resnet_weights}: {PTH_ITEM}",
              file=sys.stderr)
        return 2
    parsed = _kind(args.words)
    if parsed is None:
        print(f"input {USAGE}", file=sys.stderr)
        return 1
    kind, use_data, _ = parsed
    cfg = ConfigTrain()
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
    resnet = load_resnet_variables(args.resnet_weights, kind == "nic")
    for ext in range(args.exp_time):
        train(kind, ext=ext, use_data=use_data, cfg=cfg,
              depth_provider=provider, val_depth_provider=val_provider,
              num_epochs=args.epochs, resnet_variables=resnet,
              resnet_layers=cli.resnet_layers_from_env(),
              device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
