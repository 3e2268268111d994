"""Caption image files and directories with a trained experiment (the
port's counterpart of the JAX ``caption.py``): a thin shell over
``CaptionPipeline.from_experiment``, on the CUDA card unless ``--device
cpu``.

    python -m depth_image_captioning_pub_torch.caption img.jpg photos/ \\
        --kind depth-soft --beam 3
    python -m depth_image_captioning_pub_torch.caption *.png \\
        --kind base-soft --sample --temperature 0.8 --json

Output: one ``path<TAB>caption`` line per image (or a JSON array of
``{"path", "caption"}`` objects with ``--json``), in argument order;
directories expand to their image files sorted by name. A file that does
not decode is reported on stderr and captioned ``<decode failed>``; the
run exits 1 when no file decodes. Files decode as the pipeline decodes
paths (``data/native_loader.decode_batch``), so the captions equal those
of passing the paths to the pipeline. ``--export-dir DIR`` captions with
the artifact that ``depth_image_captioning_pub_torch.export`` wrote to DIR
instead of the ``exp_result/`` files (its decode settings are baked in;
the model flags are ignored; ``--device`` and ``--seed`` apply).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from depth_image_captioning_pub_torch import cli

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def expand_paths(args: List[str]) -> List[str]:
    """Files pass through (any extension — the decoder decides); directories
    contribute their image-suffixed files sorted by name."""
    out: List[str] = []
    for a in args:
        if os.path.isdir(a):
            out.extend(sorted(
                os.path.join(a, f) for f in os.listdir(a)
                if f.lower().endswith(IMAGE_EXTS)))
        else:
            out.append(a)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m depth_image_captioning_pub_torch.caption",
        description="Caption images with a trained experiment "
                    "(exp_result/ layout).")
    p.add_argument("paths", nargs="+", help="image files and/or directories")
    p.add_argument("--kind", default="base-soft",
                   help="model configuration (nic, base-soft, base-hard, "
                        "depth-soft, depth-hard, mdepth-soft, mdepth-hard)")
    p.add_argument("--use-data", default="coco", choices=("coco", "original"))
    p.add_argument("--set-idx", type=int, default=1,
                   help="checkpoint set 1-3 (the reference trains each "
                        "config 3x)")
    p.add_argument("--beam", type=int, default=1,
                   help="beam width (1 = greedy, the reference's decode)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--sample", action="store_true",
                   help="stochastic decoding instead of greedy/beam")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    cli.add_dpt_flags(p)
    p.add_argument("--export-dir", default=None,
                   help="caption from an export.py artifact instead of "
                        "exp_result/ checkpoints (decode settings are baked "
                        "into the artifact; model flags are ignored)")
    p.add_argument("--json", action="store_true",
                   help='emit [{"path": ..., "caption": ...}, ...]')
    p.add_argument("--output", default=None,
                   help="write results to this file instead of stdout")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    paths = expand_paths(args.paths)
    if not paths:
        print("no images found", file=sys.stderr)
        return 1
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"not found: {', '.join(missing)}", file=sys.stderr)
        return 1

    from depth_image_captioning_pub_torch.data.native_loader import (
        decode_batch)
    if args.export_dir:
        from depth_image_captioning_pub_torch.export import (
            META_NAME, ExportedPipeline)
        if not os.path.isfile(os.path.join(args.export_dir, META_NAME)):
            print(f"no export artifact in {args.export_dir} ({META_NAME} "
                  f"missing)", file=sys.stderr)
            return 1
        pipe = ExportedPipeline.load(args.export_dir, device=args.device,
                                     seed=args.seed)
    else:
        from depth_image_captioning_pub_torch.pipeline import (
            CaptionPipeline)
        pipe = CaptionPipeline.from_experiment(
            args.kind, args.use_data, cfg=cli.dpt_cfg(args),
            set_idx=args.set_idx, device=args.device, beam_size=args.beam,
            batch_size=args.batch_size, sample=args.sample,
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, seed=args.seed)
    # tolerant decode: one truncated file does not end a directory run
    failed: List[int] = []
    arrays = decode_batch(paths, pipe.image_hw, on_error="zero",
                          failed=failed)
    bad = set(failed)
    good_idx = [i for i in range(len(paths)) if i not in bad]
    for i in sorted(bad):
        print(f"decode failed: {paths[i]}", file=sys.stderr)
    if not good_idx:
        print("no decodable images", file=sys.stderr)
        return 1
    good_caps = pipe([arrays[i] for i in good_idx])
    captions = ["<decode failed>"] * len(paths)
    for i, c in zip(good_idx, good_caps):
        captions[i] = c

    if args.json:
        text = json.dumps([{"path": p, "caption": c}
                           for p, c in zip(paths, captions)], indent=2)
    else:
        text = "\n".join(f"{p}\t{c}" for p, c in zip(paths, captions))
    if args.output:
        with open(args.output, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
