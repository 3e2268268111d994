"""Scored evaluation of trained checkpoint sets (the counterpart of the JAX
package's ``base_evaluation.py`` / ``depth_evaluation.py`` score modes):

    python -m depth_image_captioning_pub_torch.evaluation \\
        {base|depth} soft score {coco|rem_coco|rem_original}
    python -m depth_image_captioning_pub_torch.evaluation nic

Each run captions the frozen val subset (``data_index/np_val_index.npy``
for coco) with each of ``--num-sets`` (default 3) checkpoint sets that
the JAX trainer wrote under ``exp_result/`` (``ConfigEval``'s tables,
paths relative to the working directory), scores BLEU-1..4, METEOR,
ROUGE-L and CIDEr, and pickles the per-metric lists to
``<save_dir>/<useData>_scores.pkl`` (``nic_scores.pkl`` for nic).

Options: ``--beam W`` (beam search, W > 1), ``--batch-size B`` (default
``ConfigEval.batch_size``), ``--device`` (``cuda``, the default: the
CUDA kernels; ``cpu`` runs their plain PyTorch versions), ``--dpt-weights
PATH`` (depth: the Omnidata loader is not ported yet, so an existing file
raises; without weights the DPT is drawn at random with a warning).
$DCAP_RESNET_LAYERS and $DCAP_TINY_DPT shrink the backbone and the DPT.
Hard attention, ``--mlp`` (``mdepth-*``) and ``sample`` are not ported:
they exit with status 2 and name their ROADMAP.md items.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
from typing import List, Optional

import numpy as np

from depth_image_captioning_pub_torch import cli
from depth_image_captioning_pub_torch.config import ConfigEval
from depth_image_captioning_pub_torch.data.coco import (
    CocoCaptions, Subset, load_index_file)
from depth_image_captioning_pub_torch.engine.evaluate import evaluate
from depth_image_captioning_pub_torch.models.captioner import build_captioner

EVAL_DATA = ("coco", "rem_coco", "rem_original")
NOT_PORTED = {
    "hard": "hard attention is not ported yet (ROADMAP.md, Queue A item 5)",
    "--mlp": "mdepth-* scoring is not ported yet (ROADMAP.md, Queue A "
             "item 6)",
    "sample": "sample mode and its attention overlays are not ported yet "
              "(ROADMAP.md, Queue A item 10)",
}


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
    print({k: float(np.mean(v)) for k, v in scores.items()})
    return 0


def score_mode(atten: str, use_data: str, cfg: ConfigEval, depth: bool,
               num_sets: int, beam_size: int, device) -> int:
    w2i_p, i2w_p, anno, index_file, use_ori = cli.eval_data_selection(
        cfg, use_data)
    word_to_id, id_to_word = _load_vocabs(w2i_p, i2w_p)
    save_directory, tables = cli.eval_tables(cfg, atten, use_ori, depth)
    ds = CocoCaptions(cfg.val_img_directory, anno)
    if index_file:
        ds = Subset(ds, load_index_file(index_file))
        print(f"subset size : {len(ds)}")
    kind = f"{'depth' if depth else 'base'}-{atten}"
    depth_fn = cli.eval_depth_fn(cfg, device) if depth else None
    cap = build_captioner(kind, len(word_to_id), cfg,
                          resnet_layers=cli.resnet_layers_from_env(),
                          device=device)
    return _report(evaluate(
        kind, use_data, cap,
        lambda i: cli.load_eval_components(save_directory, tables[i], cap),
        ds, word_to_id, id_to_word, cfg, depth_fn=depth_fn,
        num_sets=num_sets, beam_size=beam_size,
        scores_pickle=f"{save_directory}/{use_data}_scores.pkl"))


def nic_mode(cfg: ConfigEval, num_sets: int, beam_size: int, device) -> int:
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
        scores_pickle=f"{cfg.save_directory_nic}/nic_scores.pkl"))


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("words", nargs="+",
                   help="{base|depth} soft score {coco|rem_coco|"
                        "rem_original}, or nic")
    p.add_argument("--num-sets", type=int, default=3)
    p.add_argument("--beam", type=int, default=1,
                   help="beam width; 1 (default) is greedy decode")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    p.add_argument("--dpt-weights", default=None)
    p.add_argument("--mlp", action="store_true",
                   help="mdepth-* checkpoints (not ported yet)")
    args = p.parse_args(argv)
    words = args.words
    asked = [w for w in ("hard", "sample") if w in words]
    for key in asked + (["--mlp"] if args.mlp else []):
        print(NOT_PORTED[key], file=sys.stderr)
        return 2
    cfg = ConfigEval()
    if args.batch_size:
        cfg.batch_size = args.batch_size
    if args.dpt_weights:
        cfg.dpt_weights = args.dpt_weights
    if words == ["nic"]:
        return nic_mode(cfg, args.num_sets, args.beam, args.device)
    if (len(words) == 4 and words[0] in ("base", "depth")
            and words[1] == "soft" and words[2] == "score"):
        if words[3] not in EVAL_DATA:
            print("input coco or rem_coco or rem_original", file=sys.stderr)
            return 1
        return score_mode("soft", words[3], cfg, words[0] == "depth",
                          args.num_sets, args.beam, args.device)
    print("evaluation {base|depth} soft score {coco|rem_coco|rem_original}"
          " | nic", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
