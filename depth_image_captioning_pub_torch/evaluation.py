"""Scored evaluation of trained checkpoint sets (the counterpart of the JAX
package's ``base_evaluation.py`` / ``depth_evaluation.py`` score modes):

    python -m depth_image_captioning_pub_torch.evaluation \\
        {base|depth} {soft|hard} score {coco|rem_coco|rem_original} [--mlp]
    python -m depth_image_captioning_pub_torch.evaluation \\
        {base|depth} {soft|hard} sample <pic_name> {coco|original} [--mlp] \\
        [--stochastic --temperature T --top-k K --top-p P --seed S]
    python -m depth_image_captioning_pub_torch.evaluation nic

Each run captions the frozen val subset (``data_index/np_val_index.npy``
for coco) with each of ``--num-sets`` (default 3) checkpoint sets that
the JAX trainer wrote under ``exp_result/`` (``ConfigEval``'s tables,
paths relative to the working directory), scores BLEU-1..4, METEOR,
ROUGE-L and CIDEr, and pickles the per-metric lists to
``<save_dir>/<useData>_scores.pkl`` (``nic_scores.pkl`` for nic). ``--mlp``
(depth only) scores the MLP-depth ``mdepth_*`` sets into
``<save_dir>/mdepth_<useData>_scores.pkl``. Hard attention draws set k's
Gumbel region noise from a generator seeded with k.

Options: ``--beam W`` (beam search, W > 1; soft attention on the card
takes W = 2..8, the beam kernel's instances), ``--batch-size B`` (default
``ConfigEval.batch_size``), ``--device`` (``cuda``, the default: the
CUDA kernels; ``cpu`` runs their plain PyTorch versions), ``--dpt-weights
PATH`` (depth: the Omnidata DPT-hybrid ``.ckpt`` or ``utils.convert``'s
``.msgpack`` of it, also $DPT_WEIGHTS; without weights the DPT is drawn at
random with a warning),
``--dpt-size``, ``--gelu`` and ``--dpt-head`` (depth: the DPT's input
side, 384 by default, and its throughput knobs, ``cli.add_dpt_flags``).
$DCAP_RESNET_LAYERS and $DCAP_TINY_DPT shrink the backbone and the DPT.

The frozen stages run once: with more than one set, set 1's RGB features
and depth maps (NIC: its pooled features) stay on the card and the later
sets replay them (``engine/evaluate.evaluate``; a set whose encoder
differs recomputes its features; ``$DCAP_EVAL_CACHE_GB``, default 8,
bounds them, above it only depth maps are kept). ``--no-eval-cache`` (or
its alias ``--no-depth-eval-cache``) recomputes every stage for every
set, as the reference does. ``--eval-cache-dir DIR`` (or
``$DCAP_EVAL_CACHE_DIR``) also writes them to DIR, keyed by the dataset
and the frozen weights, and a later run replays them from there, also
with ``--num-sets 1``.

``sample`` mode captions the images of one ``sample_pic`` set
(``ConfigEval.sample_dirs[pic_name]``) with checkpoint set 1 and writes,
under ``<sample_dir>/{base|depth|mdepth}_<atten>/``, one overlay PNG per
word of each caption (``<stem>/NN_<word>.png``, the word's attention map
over the image), ``<stem>/input.png`` and ``caption.txt``
(``engine/visualize.sample_directory``). It decodes greedily (all 30
steps, the attention weights kept: ``AttentionDecoder.greedy_alphas``), or
with ``--stochastic`` draws from the filtered distribution
(``--temperature``, ``--top-k``, ``--top-p``). Each image draws from a
``torch.Generator`` of its own, seeded from ``--seed`` and the image's
position, so a rerun repeats its captions; hard attention's greedy region
draws come from it too.

Data parallel: under ``torchrun`` (``WORLD_SIZE`` > 1) each process joins
the group (``parallel/multihost.initialize``: NCCL on the cards, gloo with
``--device cpu``) on ``cuda:LOCAL_RANK`` and captions its rows of every
batch; rank 0 scores, writes the pickle and prints (sample mode runs on
rank 0 alone):

    torchrun --nproc-per-node 8 \\
        -m depth_image_captioning_pub_torch.evaluation depth soft score coco
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
from typing import Dict, List, Optional

import numpy as np

from depth_image_captioning_pub_torch import cli
from depth_image_captioning_pub_torch.config import ConfigEval
from depth_image_captioning_pub_torch.data.coco import (
    CocoCaptions, Subset, load_index_file)
from depth_image_captioning_pub_torch.engine.evaluate import evaluate
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.parallel import multihost

EVAL_DATA = ("coco", "rem_coco", "rem_original")
SAMPLE_DATA = ("coco", "original")


def _load_vocabs(w2i_path: str, i2w_path: str):
    with open(w2i_path, "rb") as f:
        word_to_id = pickle.load(f)
    if os.path.exists(i2w_path):
        with open(i2w_path, "rb") as f:
            id_to_word = pickle.load(f)
    else:
        id_to_word = {i: w for w, i in word_to_id.items()}
    return word_to_id, id_to_word


def _report(scores) -> int:
    if multihost.process_index() == 0:
        print({k: float(np.mean(v)) for k, v in scores.items()})
    return 0


def score_mode(atten: str, use_data: str, cfg: ConfigEval, depth: bool,
               num_sets: int, beam_size: int, encoder: str, cache: Dict,
               device) -> int:
    """``encoder="mlp"`` (depth only) scores the mdepth sets; their pickle
    gets an ``mdepth_`` prefix, as in the JAX package, so that it does not
    overwrite the CNN-depth scores in the same directory. ``cache``:
    ``evaluate``'s ``depth_eval_cache`` and ``eval_cache_dir``."""
    w2i_p, i2w_p, anno, index_file, use_ori = cli.eval_data_selection(
        cfg, use_data)
    word_to_id, id_to_word = _load_vocabs(w2i_p, i2w_p)
    save_directory, tables = cli.eval_tables(cfg, atten, use_ori, depth,
                                             encoder=encoder)
    ds = CocoCaptions(cfg.val_img_directory, anno)
    if index_file:
        ds = Subset(ds, load_index_file(index_file))
        if multihost.process_index() == 0:
            print(f"subset size : {len(ds)}")
    mlp = depth and encoder == "mlp"
    kind = f"{('mdepth' if mlp else 'depth') if depth else 'base'}-{atten}"
    depth_fn = cli.eval_depth_fn(cfg, device) if depth else None
    cap = build_captioner(kind, len(word_to_id), cfg,
                          resnet_layers=cli.resnet_layers_from_env(),
                          device=device)
    return _report(evaluate(
        kind, use_data, cap,
        lambda i: cli.load_eval_components(save_directory, tables[i], cap),
        ds, word_to_id, id_to_word, cfg, depth_fn=depth_fn,
        num_sets=num_sets, beam_size=beam_size,
        scores_pickle=f"{save_directory}/{'mdepth_' if mlp else ''}"
                      f"{use_data}_scores.pkl", **cache))


def image_seed(seed: int, i: int) -> int:
    """The seed of image ``i``'s generator in sample mode (the counterpart
    of the JAX ``fold_in(PRNGKey(seed), i)``)."""
    return (seed * (1 << 32) + i) % (1 << 63)


def sample_mode(atten: str, pic_name: str, use_data: str, cfg: ConfigEval,
                depth: bool, encoder: str, device, sampling=None,
                seed: int = 0, noise=None, att_noise=None) -> int:
    """Caption and overlay the images of one sample_pic set (the JAX
    ``sample_mode``). ``sampling`` ({"temperature", "top_k", "top_p"})
    draws the tokens; without it the decode is greedy. ``noise(i)`` and
    ``att_noise(i)``, when given, are image i's token-noise hook (``t`` ->
    [1, V]) and region-noise hook (``(t, shape)`` -> Gumbel noise), in
    place of its generator's draws (the tests replay the JAX package's
    through them). ``encoder="mlp"`` (depth only) samples the mdepth sets,
    into ``<sample_dir>/mdepth_<atten>``."""
    import torch
    from depth_image_captioning_pub_torch.data.tokenizer import SPECIAL
    from depth_image_captioning_pub_torch.engine.evaluate import (
        make_caption_fn)
    from depth_image_captioning_pub_torch.engine.visualize import (
        sample_directory)
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        params_from_jax)

    if pic_name not in cfg.sample_dirs:
        print("Input correct name", file=sys.stderr)
        return 1
    use_ori = use_data == "original"
    word_to_id, id_to_word = _load_vocabs(
        cfg.ori_word_to_id_file if use_ori else cfg.word_to_id_file,
        cfg.ori_id_to_word_file if use_ori else cfg.id_to_word_file)
    save_directory, tables = cli.eval_tables(cfg, atten, use_ori, depth,
                                             encoder=encoder)
    prefix = ("mdepth" if encoder == "mlp" else "depth") if depth else "base"
    cap = build_captioner(f"{prefix}-{atten}", len(word_to_id), cfg,
                          resnet_layers=cli.resnet_layers_from_env(),
                          device=device)
    frozen_enc, params, stats = cli.load_eval_components(
        save_directory, tables[1], cap)
    params_from_jax(cap, params, {"encoder": frozen_enc}, stats)
    start_id = word_to_id[SPECIAL.start]
    frozen = make_caption_fn(
        cap, start_id, cfg.max_length,
        depth_fn=cli.eval_depth_fn(cfg, device) if depth else None).frozen
    depth_encoder = cap.depth_encoder_apply()
    position = iter(range(1 << 30))

    @torch.inference_mode()
    def caption_one(arr: np.ndarray):
        i = next(position)
        gen = torch.Generator(device=cap.device).manual_seed(
            image_seed(seed, i))
        entry = frozen(torch.from_numpy(arr[None]).to(cap.device))
        dep = (None if depth_encoder is None
               else depth_encoder(entry["depth_maps"]))
        hooks = {"att_noise": None if att_noise is None else att_noise(i)}
        if sampling is not None:
            tokens, alphas = cap.decoder.stochastic_sample(
                entry["feats"], start_id, gen, dep,
                max_length=cfg.max_length,
                noise=None if noise is None else noise(i), **sampling,
                **hooks)
        else:
            tokens, alphas = cap.decoder.greedy_alphas(
                entry["feats"], start_id, dep, max_length=cfg.max_length,
                generator=gen, **hooks)
        return tokens[0].cpu().numpy(), alphas[0].cpu().numpy()

    src = cfg.sample_dirs[pic_name]
    caps = sample_directory(src, os.path.join(src, f"{prefix}_{atten}"),
                            caption_one, id_to_word)
    for path, caption in caps.items():
        print(f"{os.path.basename(path)}: {caption}")
    return 0


def nic_mode(cfg: ConfigEval, num_sets: int, beam_size: int, cache: Dict,
             device) -> int:
    """``cache``: as ``score_mode``'s."""
    word_to_id, id_to_word = _load_vocabs(cfg.word_to_id_file,
                                          cfg.id_to_word_file)
    ds = Subset(CocoCaptions(cfg.val_img_directory, cfg.val_anno_file),
                load_index_file(cfg.index_dir))
    cap = build_captioner("nic", len(word_to_id), cfg,
                          resnet_layers=cli.resnet_layers_from_env(),
                          device=device)
    return _report(evaluate(
        "nic", "coco", cap,
        lambda i: cli.load_eval_components(
            cfg.save_directory_nic, cfg.nic_parameter_files[i], cap),
        ds, word_to_id, id_to_word, cfg, num_sets=num_sets,
        beam_size=beam_size,
        scores_pickle=f"{cfg.save_directory_nic}/nic_scores.pkl", **cache))


def main(argv: Optional[List[str]] = None) -> int:
    if multihost.launched_ranks() == 1:
        return _main(argv)
    args = _parser().parse_args(argv)
    device = multihost.local_device(args.device)
    multihost.initialize(device=device)
    try:
        multihost.build_kernels(device)
        if "sample" in args.words[2:3] and multihost.process_index() != 0:
            return 0
        return _main(argv, device)
    finally:
        multihost.shutdown()


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("words", nargs="+",
                   help="{base|depth} {soft|hard} score {coco|rem_coco|"
                        "rem_original}, {base|depth} {soft|hard} sample "
                        "<pic_name> {coco|original}, or nic")
    p.add_argument("--num-sets", type=int, default=3)
    p.add_argument("--beam", type=int, default=1,
                   help="beam width; 1 (default) is greedy decode")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    p.add_argument("--dpt-weights", default=None)
    cli.add_dpt_flags(p)
    p.add_argument("--mlp", action="store_true",
                   help="depth: the MLP-depth (mdepth-*) checkpoint sets")
    p.add_argument("--no-eval-cache", "--no-depth-eval-cache",
                   dest="eval_cache", action="store_false",
                   help="recompute the frozen stages for every set")
    p.add_argument("--eval-cache-dir", default=None, metavar="DIR",
                   help="persist the frozen stages' outputs in DIR "
                        "(default $DCAP_EVAL_CACHE_DIR)")
    p.add_argument("--stochastic", action="store_true",
                   help="sample mode: draw the tokens instead of argmax")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0,
                   help="sample mode: seeds each image's draws")
    return p


def _main(argv, device=None) -> int:
    """The evaluation on ``device`` (default ``--device``)."""
    args = _parser().parse_args(argv)
    if device is not None:
        args.device = device
    cache = {"depth_eval_cache": args.eval_cache,
             "eval_cache_dir": (args.eval_cache_dir
                                or os.environ.get("DCAP_EVAL_CACHE_DIR")
                                or None)}
    words = args.words
    cfg = cli.dpt_cfg(args)
    if args.batch_size:
        cfg.batch_size = args.batch_size
    if args.dpt_weights:
        cfg.dpt_weights = args.dpt_weights
    if words == ["nic"]:
        return nic_mode(cfg, args.num_sets, args.beam, cache, args.device)
    if (len(words) == 4 and words[0] in ("base", "depth")
            and words[1] in ("soft", "hard") and words[2] == "score"):
        if words[3] not in EVAL_DATA:
            print("input coco or rem_coco or rem_original", file=sys.stderr)
            return 1
        return score_mode(words[1], words[3], cfg, words[0] == "depth",
                          args.num_sets, args.beam,
                          "mlp" if args.mlp else "cnn", cache, args.device)
    if (len(words) == 5 and words[0] in ("base", "depth")
            and words[1] in ("soft", "hard") and words[2] == "sample"):
        if words[4] not in SAMPLE_DATA:
            print("input coco or original", file=sys.stderr)
            return 1
        sampling = ({"temperature": args.temperature, "top_k": args.top_k,
                     "top_p": args.top_p} if args.stochastic else None)
        return sample_mode(words[1], words[3], words[4], cfg,
                           words[0] == "depth",
                           "mlp" if args.mlp else "cnn", args.device,
                           sampling=sampling, seed=args.seed)
    print("evaluation {base|depth} {soft|hard} score {coco|rem_coco|"
          "rem_original} [--mlp] | {base|depth} {soft|hard} sample "
          "<pic_name> {coco|original} [--mlp] | nic", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
