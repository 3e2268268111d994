"""Command-line captioning with the port's pipeline.

    python -m depth_image_captioning_pub_torch.cli caption \\
        --images batch.npy [--kind depth-soft] [--weights params.npz] \\
        [--vocab word_to_id.pkl] [--device cpu] [--batch-buckets 1,16,64] \\
        [--beam 5 [--length-penalty 0.7]] \\
        [--sample [--temperature 0.8] [--top-k 40] [--top-p 0.9]]

``--images`` is a uint8 ``.npy`` array [N, H, W, 3] (or [H, W, 3]);
``--random N`` captions N seeded random images instead. ``--kind`` is
``base-soft`` (default), ``depth-soft`` or ``nic``. ``--beam N`` (N > 1)
captions with beam search, ranked by score / length**``--length-penalty``.
``--sample`` draws captions from the filtered distribution
(``--temperature``, ``--top-k``, ``--top-p``; ``--seed`` seeds the draws).
It runs on the CUDA card; ``--device cpu`` runs the plain PyTorch versions
of the kernels on the CPU instead. Weights come from an ``.npz``
that ``utils/jax_bridge.load_npz`` reads (the JAX package's parameter
trees; for depth-soft also the depth encoder, its BN statistics and,
under ``frozen/dpt``, the DPT) or, without ``--weights``, are drawn from
``--seed``; a depth-soft run without DPT weights warns, as the JAX CLI
does. ``--tiny-dpt`` shrinks the DPT to the tests' size (64x64 input).
Without ``--vocab`` a placeholder vocabulary of ``--vocab-size`` words is
used, which is only good for seeded weights. Prints one caption per line.

The module also holds what the scored evaluation
(``depth_image_captioning_pub_torch.evaluation``) and
``CaptionPipeline.from_experiment`` share with the JAX package's
``cli.py``: the data and checkpoint tables of the reference's ``useData``
switch and ``load_eval_components``, which reads one checkpoint set that
the JAX trainer wrote.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from depth_image_captioning_pub_torch.config import ConfigEval
from depth_image_captioning_pub_torch.data.tokenizer import SPECIAL


def placeholder_vocab(size: int) -> Tuple[Dict[str, int], Dict[int, str]]:
    """``size`` words: w0, w1, ... then the four special tokens, in the
    order ``data/vocab.build_vocab`` assigns them."""
    words = [f"w{i}" for i in range(size - 4)]
    words += [SPECIAL.start, SPECIAL.end, SPECIAL.unk, SPECIAL.null]
    return ({w: i for i, w in enumerate(words)},
            {i: w for i, w in enumerate(words)})


def _ints(text: str) -> Tuple[int, ...]:
    return tuple(int(x) for x in text.split(",") if x)


def make_depth_fn(dpt_variables=None, *, tiny: bool = False,
                  device="cuda", seed: int = 0,
                  hint: str = "pass DPT weights under frozen/dpt of "
                              "--weights"):
    """The bf16 DPT's standardized-depth function (counterpart of the JAX
    ``cli.make_depth_fn``). ``dpt_variables`` is the flax DPT tree
    ({"params": ...}); without it the weights are drawn from ``seed``, with
    the JAX CLI's warning (``hint`` says where weights would come from).
    ``tiny`` builds the tests' DPT (``dpt.TINY_DPT`` at 64x64)."""
    from depth_image_captioning_pub_torch.models.dpt import (
        TINY_DPT, DPTDepthEstimator)
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        dpt_params_from_jax)
    kw = dict(TINY_DPT, image_size=64) if tiny else {}
    est = DPTDepthEstimator(device=device, **kw)
    if dpt_variables is not None:
        dpt_params_from_jax(est, dpt_variables)
    else:
        print(f"WARNING: no DPT weights found ({hint}); using random init "
              f"— depth maps will be noise", file=sys.stderr)
        est.init(torch.Generator().manual_seed(seed))
    return est.depth_fn()


def resnet_layers_from_env() -> Optional[Tuple[int, ...]]:
    """$DCAP_RESNET_LAYERS="1,1,1,1" shrinks the backbone (tests, CPU
    runs); unset -> ResNet-152."""
    raw = os.environ.get("DCAP_RESNET_LAYERS")
    return _ints(raw) if raw else None


def eval_depth_fn(cfg, device="cuda"):
    """The DPT of a scored depth evaluation: the Omnidata weights of
    ``cfg.dpt_weights`` / $DPT_WEIGHTS are not readable yet, so without
    them the DPT is drawn from seed 0 with the JAX warning;
    $DCAP_TINY_DPT builds the tests' DPT."""
    weights = cfg.dpt_weights or os.environ.get("DPT_WEIGHTS")
    if weights and os.path.exists(weights):
        raise NotImplementedError(
            f"DPT weights {weights}: the Omnidata checkpoint loader is not "
            f"yet ported (ROADMAP.md, Queue A item 7)")
    return make_depth_fn(tiny=bool(os.environ.get("DCAP_TINY_DPT")),
                         device=device,
                         hint="set --dpt-weights or $DPT_WEIGHTS")


def eval_data_selection(cfg: ConfigEval, use_data: str
                        ) -> Tuple[str, str, str, Optional[str], bool]:
    """(word_to_id_path, id_to_word_path, anno_file, index_file, use_ori)
    per the reference's useData switch."""
    if use_data == "coco":
        return (cfg.word_to_id_file, cfg.id_to_word_file, cfg.val_anno_file,
                cfg.index_dir, False)
    if use_data == "rem_coco":
        return (cfg.ori_word_to_id_file, cfg.ori_id_to_word_file,
                cfg.remCOCO_ori_val_anno_file,
                cfg.remCOCO_500_ori_index_dir, True)
    if use_data == "rem_original":
        return (cfg.ori_word_to_id_file, cfg.ori_id_to_word_file,
                cfg.rem_ori_val_anno_file, None, True)
    raise ValueError("input coco or rem_coco or rem_original")


def eval_tables(cfg: ConfigEval, atten: str, use_ori: bool, depth: bool,
                encoder: str = "cnn") -> Tuple[str, Dict[int, list]]:
    """(save_directory, checkpoint-filename table) of one configuration;
    ``encoder="mlp"`` selects the mdepth_* tables."""
    if depth:
        m = encoder == "mlp"
        if atten == "soft":
            return ((cfg.save_directory_Cdep_soft_ori,
                     cfg.mdepth_soft_ori_parameter_files if m else
                     cfg.depth_soft_ori_parameter_files) if use_ori else
                    (cfg.save_directory_Cdep_soft,
                     cfg.mdepth_soft_parameter_files if m else
                     cfg.depth_soft_parameter_files))
        return ((cfg.save_directory_Cdep_hard_ori,
                 cfg.mdepth_hard_ori_parameter_files if m else
                 cfg.depth_hard_ori_parameter_files) if use_ori else
                (cfg.save_directory_Cdep_hard,
                 cfg.mdepth_hard_parameter_files if m else
                 cfg.depth_hard_parameter_files))
    if atten == "soft":
        return ((cfg.save_directory_soft_ori,
                 cfg.base_soft_ori_parameter_files) if use_ori else
                (cfg.save_directory_soft, cfg.base_soft_parameter_files))
    return ((cfg.save_directory_hard_ori,
             cfg.base_hard_ori_parameter_files) if use_ori else
            (cfg.save_directory_hard, cfg.base_hard_parameter_files))


def load_eval_components(save_directory: str, files, cap):
    """One checkpoint set that the JAX trainer wrote: (frozen encoder,
    trainable params, batch_stats), the trees ``params_from_jax`` takes
    (with ``frozen={"encoder": ...}``). ``files`` is a row of a
    ``*_parameter_files`` table: encoder, decoder and, for depth kinds,
    the depth encoder's ``{"params", "batch_stats"}`` bundle; NIC's
    projection is a file of its own, the encoder's name with "encoder"
    replaced by "enc_linear"."""
    from depth_image_captioning_pub_torch.utils.checkpoint import (
        load_component)

    def load(name):
        return load_component(os.path.join(save_directory, name))

    frozen_enc = load(files[0])
    params = {"decoder": load(files[1])}
    stats: Dict = {}
    if cap.spec.is_nic:
        params["enc_linear"] = load(files[0].replace("encoder", "enc_linear"))
    elif cap.spec.uses_depth:
        bundle = load(files[2])
        params["depth_encoder"] = bundle["params"]
        stats = bundle["batch_stats"]
    return frozen_enc, params, stats


def build_pipeline(args: argparse.Namespace):
    from depth_image_captioning_pub_torch.data.vocab import load_vocab
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
    cap = build_captioner(args.kind, len(word_to_id), cfg,
                          resnet_layers=args.resnet_layers or None,
                          device=args.device)
    frozen = {}
    if args.weights:
        trainable, frozen, batch_stats = load_npz(args.weights)
        params_from_jax(cap, trainable, frozen, batch_stats)
    else:
        cap.init(torch.Generator().manual_seed(args.seed))
    depth_fn = None
    if cap.spec.uses_depth:
        depth_fn = make_depth_fn(frozen.get("dpt"), tiny=args.tiny_dpt,
                                 device=args.device, seed=args.seed)
    return CaptionPipeline(cap, word_to_id, id_to_word, depth_fn=depth_fn,
                           max_length=args.max_length,
                           batch_buckets=args.batch_buckets,
                           image_hw=(args.image_size, args.image_size),
                           beam_size=args.beam,
                           length_penalty=args.length_penalty,
                           sample=args.sample, temperature=args.temperature,
                           top_k=args.top_k, top_p=args.top_p,
                           seed=args.seed)


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
    c.add_argument("--kind", default="base-soft",
                   choices=("base-soft", "depth-soft", "nic"))
    c.add_argument("--weights", help=".npz of the JAX parameter trees")
    c.add_argument("--vocab", help="word_to_id.pkl")
    c.add_argument("--vocab-size", type=int, default=9956)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    c.add_argument("--resnet-layers", type=_ints, default=None,
                   help="e.g. 3,8,36,3 (ResNet-152, the default)")
    c.add_argument("--tiny-dpt", action="store_true",
                   help="the tests' small DPT (64x64 input)")
    c.add_argument("--image-size", type=int, default=224)
    c.add_argument("--max-length", type=int, default=30)
    c.add_argument("--batch-buckets", type=_ints, default=(1, 16, 64))
    c.add_argument("--beam", type=int, default=1,
                   help="beam width; 1 (default) is greedy decode")
    c.add_argument("--length-penalty", type=float, default=0.0,
                   help="GNMT alpha for ranking beams (0: log-prob)")
    c.add_argument("--sample", action="store_true",
                   help="stochastic decoding instead of greedy argmax")
    c.add_argument("--temperature", type=float, default=1.0)
    c.add_argument("--top-k", type=int, default=0,
                   help="keep the k most likely tokens (0 = off)")
    c.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus mass to keep (1.0 = off)")
    args = p.parse_args(argv)
    for line in caption(args):
        sys.stdout.write(line + "\n")


if __name__ == "__main__":
    main()
