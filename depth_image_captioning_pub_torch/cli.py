"""Command-line captioning with the port's pipeline.

    python -m depth_image_captioning_pub_torch.cli caption \\
        --images batch.npy [--kind depth-soft] [--weights params.npz] \\
        [--vocab word_to_id.pkl] [--device cpu] [--batch-buckets 1,16,64] \\
        [--beam 5 [--length-penalty 0.7]] \\
        [--sample [--temperature 0.8] [--top-k 40] [--top-p 0.9]]

``--images`` is a uint8 ``.npy`` array [N, H, W, 3] (or [H, W, 3]);
``--random N`` captions N seeded random images instead. ``--kind`` is
``base-soft`` (default), ``base-hard``, ``depth-soft``, ``depth-hard``,
``mdepth-soft``, ``mdepth-hard`` or ``nic``. ``--beam N`` (N > 1)
captions with beam search, ranked by score / length**``--length-penalty``.
``--sample`` draws captions from the filtered distribution
(``--temperature``, ``--top-k``, ``--top-p``; ``--seed`` seeds the draws,
and hard attention's region draws, which repeat on every run).
It runs on the CUDA card; ``--device cpu`` runs the plain PyTorch versions
of the kernels on the CPU instead. Weights come from an ``.npz``
that ``utils/jax_bridge.load_npz`` reads (the JAX package's parameter
trees; for a depth kind also the depth encoder, its BN statistics and,
under ``frozen/dpt``, the DPT) or, without ``--weights``, are drawn from
``--seed``; a depth run without DPT weights warns, as the JAX CLI
does. ``--tiny-dpt`` shrinks the DPT to the tests' size (64x64 input);
``--dpt-size``, ``--gelu`` and ``--dpt-head`` set its input side and
its throughput knobs (``add_dpt_flags``).
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


def make_depth_fn(dpt_variables=None, *, cfg=None, tiny: bool = False,
                  device="cuda", seed: int = 0,
                  hint: str = "pass DPT weights under frozen/dpt of "
                              "--weights, or set $DPT_WEIGHTS"):
    """The bf16 DPT's standardized-depth function (counterpart of the JAX
    ``cli.make_depth_fn``). ``dpt_variables`` is the flax DPT tree
    ({"params": ...}); without it the weights come from the file that
    ``cfg.dpt_weights`` or $DPT_WEIGHTS names (an Omnidata ``.ckpt``, or
    ``utils.convert``'s ``.msgpack``: ``DPTDepthEstimator.load_weights``)
    and, without an existing file, are drawn from ``seed``, with the JAX
    CLI's warning (``hint`` says where weights would come from).
    ``cfg`` (a ``ConfigEval``, default values without it) gives the DPT's
    input side ``dpt_image_size``, its GELU ``dpt_gelu`` ("erf" or "tanh")
    and its head ``dpt_head`` ("full" or "lowres"); another GELU or head
    raises. ``tiny`` builds the tests' DPT (``dpt.TINY_DPT`` at 64x64)."""
    from depth_image_captioning_pub_torch.models.dpt import (
        TINY_DPT, DPTDepthEstimator)
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        dpt_params_from_jax)
    cfg = cfg or ConfigEval()
    kw = dict(image_size=cfg.dpt_image_size, gelu=cfg.dpt_gelu,
              head=cfg.dpt_head)
    if tiny:
        kw.update(TINY_DPT, image_size=64)
    est = DPTDepthEstimator(device=device, **kw)
    weights = cfg.dpt_weights or os.environ.get("DPT_WEIGHTS")
    if dpt_variables is not None:
        dpt_params_from_jax(est, dpt_variables)
    elif weights and os.path.exists(weights):
        est.load_weights(weights)
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
    """The DPT of a scored depth evaluation, of the serving entry points and
    of training, at ``cfg``'s ``dpt_image_size``, ``dpt_gelu`` and
    ``dpt_head``, on the weights of ``cfg.dpt_weights`` / $DPT_WEIGHTS
    (``make_depth_fn``); $DCAP_TINY_DPT builds the tests' DPT."""
    return make_depth_fn(cfg=cfg, tiny=bool(os.environ.get("DCAP_TINY_DPT")),
                         device=device,
                         hint="set --dpt-weights or $DPT_WEIGHTS")


def load_resnet_variables(path: Optional[str], nic: bool = False,
                          layers: Optional[Tuple[int, ...]] = None):
    """The frozen encoder's flax tree for training (counterpart of the JAX
    ``cli.load_resnet_variables``): from ``path`` or $RESNET152_WEIGHTS,
    a torchvision ResNet ``.pth`` (IMAGENET1K_V2; through
    ``torch_bridge.encoder_to_flax`` with the backbone's ``layers``,
    default ResNet-152) or an encoder msgpack file (a trainer's
    ``*_encoder_best_*.pth.msgpack``, or ``utils.convert --kind
    resnet152``'s). None, with a warning, without a file. NIC takes the
    backbone's own ``{"params", "batch_stats"}``."""
    from depth_image_captioning_pub_torch.models.resnet import (
        RESNET152_LAYERS)
    from depth_image_captioning_pub_torch.utils import torch_bridge as tb
    from depth_image_captioning_pub_torch.utils.checkpoint import (
        load_component)
    path = path or os.environ.get("RESNET152_WEIGHTS")
    if not path or not os.path.exists(path):
        print("WARNING: no ResNet-152 weights (set --resnet-weights or "
              "$RESNET152_WEIGHTS); encoder uses random init",
              file=sys.stderr)
        return None
    if path.endswith(".msgpack"):
        tree = load_component(path)
    else:
        tree = tb.encoder_to_flax(tb.load_state_dict(path),
                                  layers or RESNET152_LAYERS)
    if nic and "backbone" in tree["params"]:
        return {"params": tree["params"]["backbone"],
                "batch_stats": tree["batch_stats"]["backbone"]}
    return tree


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
    """One checkpoint set: (frozen encoder, trainable params,
    batch_stats), the trees ``params_from_jax`` takes (with
    ``frozen={"encoder": ...}``). ``files`` is a row of a
    ``*_parameter_files`` table: encoder, decoder and, for depth kinds,
    the depth encoder. Each component is read from its msgpack twin (the
    JAX trainer's files, or this one's) where there is one, else from the
    reference's own ``.pth`` file through ``utils/torch_bridge``, else
    raises ``FileNotFoundError`` (counterpart of the JAX
    ``cli.load_eval_components``). The depth encoder's msgpack is a
    ``{"params", "batch_stats"}`` bundle (the MLP's statistics are
    empty); the reference's depth CNN ``.pth`` holds both, its MLP
    ``.pth`` the weights alone. NIC's projection is a msgpack file of its
    own, the encoder's name with "encoder" replaced by "enc_linear", or
    the ``linear`` layer of the reference's encoder ``.pth``, which
    bundles the backbone and the projection."""
    from depth_image_captioning_pub_torch.utils import torch_bridge as tb
    from depth_image_captioning_pub_torch.utils.checkpoint import (
        load_component)
    backbone = cap.backbone if cap.spec.is_nic else cap.encoder.backbone
    layers = backbone.layers

    def path(name):
        return os.path.join(save_directory, name)

    def load(name, bridge):
        if os.path.exists(path(name) + ".msgpack"):
            return load_component(path(name))
        if os.path.exists(path(name)):
            return bridge(tb.load_state_dict(path(name)))
        raise FileNotFoundError(path(name) + "(.msgpack)")

    stats: Dict = {}
    if cap.spec.is_nic:
        frozen_enc = load(files[0],
                          lambda sd: tb.resnet_to_flax(sd, layers))
        lin = files[0].replace("encoder", "enc_linear")
        if os.path.exists(path(lin) + ".msgpack"):
            enc_linear = load_component(path(lin))
        elif os.path.exists(path(files[0])):
            enc_linear = tb.nic_encoder_linear_to_flax(
                tb.load_state_dict(path(files[0])))
        else:
            raise FileNotFoundError(
                f"{path(lin)}.msgpack, or the reference's encoder "
                f"{path(files[0])} that bundles the projection")
        params = {"enc_linear": enc_linear,
                  "decoder": load(files[1], tb.nic_decoder_to_flax)}
        return frozen_enc, params, stats
    frozen_enc = load(files[0], lambda sd: tb.encoder_to_flax(sd, layers))
    params = {"decoder": load(files[1], tb.attention_decoder_to_flax)}
    if cap.spec.uses_depth:
        bridge = (tb.depth_cnn_to_flax if cap.spec.depth_encoder == "cnn"
                  else lambda sd: {"params": tb.depth_mlp_to_flax(sd)})
        bundle = load(files[2], bridge)
        params["depth_encoder"] = bundle["params"]
        stats = bundle.get("batch_stats", {})
    return frozen_enc, params, stats


def add_dpt_flags(p: argparse.ArgumentParser) -> None:
    """The DPT's flags of the JAX package's depth evaluation, serve and
    caption CLIs (depth kinds only): its input side and two throughput
    knobs that change the depth maps, off by default."""
    p.add_argument("--dpt-size", type=int, default=384,
                   help="DPT input side (224 -> 384 upscale by default)")
    p.add_argument("--gelu", default="erf", choices=("erf", "tanh"),
                   help="the DPT ViT MLPs' GELU: erf (exact, the default) "
                        "or tanh")
    p.add_argument("--dpt-head", default="full", choices=("full", "lowres"),
                   help="lowres runs the head's convs before its x2 "
                        "upsample (not exact)")


def dpt_cfg(args: argparse.Namespace) -> ConfigEval:
    """A ``ConfigEval`` with ``add_dpt_flags``' values."""
    cfg = ConfigEval()
    cfg.dpt_image_size, cfg.dpt_gelu, cfg.dpt_head = (
        args.dpt_size, args.gelu, args.dpt_head)
    return cfg


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
    cfg = dpt_cfg(args)
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
        depth_fn = make_depth_fn(frozen.get("dpt"), cfg=cfg,
                                 tiny=args.tiny_dpt,
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
    from depth_image_captioning_pub_torch.models.captioner import (
        PORTED_KINDS)
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    c = sub.add_parser("caption", help="caption uint8 image arrays")
    src = c.add_mutually_exclusive_group(required=True)
    src.add_argument("--images", help="uint8 .npy [N,H,W,3] or [H,W,3]")
    src.add_argument("--random", type=int, help="caption N seeded images")
    c.add_argument("--kind", default="base-soft", choices=PORTED_KINDS)
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
    add_dpt_flags(c)
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
