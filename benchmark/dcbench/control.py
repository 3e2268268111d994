"""The control: the plain reference put in the program's place, computed
in the precision below the one the configuration states (float8 e4m3
for the bfloat16 encoders and depth CNN, TF32 for the float32 decoder),
and judged as a run's output is. Its readings set each limit's upper end:
a limit has to fail it.

    python3 benchmark/dcbench/control.py --workload depth-soft.offline \\
        --seeds 5 6 7 [--fault alter_token]

``--fault NAME`` runs the program instead, with that fault of
``faults.py`` planted (``none``: as it is), through a short window, and
prints its readings. The benchmark's runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

if __name__ == "__main__":      # the harness and the program importable
    _here = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_here), str(_here.parent)]

from dcbench import judge, program, spec
from reference import decoder as ref_decoder
from reference.depth_cnn import depth_features
from reference.ops import Rounding, tf32
from reference.resnet import grid_features

LOW = Rounding("fp8")


def offline(cell: spec.Cell, seed: int, device) -> Dict[str, float]:
    """The control over the requests a run compares (the seeded one and
    the next), as the program would caption them."""
    cfg, tr = cell.config, cell.traffic
    served = program.build(cfg, seed, device, cell.dpt).served
    n, p = tr["images_per_request"], tr["distinct_requests"]
    pool = program.images(seed, n * p, cfg["image_size"], device).numpy(
    ).reshape(p, n, cfg["image_size"], cfg["image_size"], 3)
    first = int(np.random.default_rng(seed).integers(0, p))
    records = [dict(_captions(cfg, served, pool[req], device, cell.dpt),
                    request=req)
               for req in sorted({first, (first + 1) % p})]
    return judge.captions(cfg, served, records, pool, device, cell.dpt)


def _captions(cfg, served, images, device, dpt) -> Dict:
    """The control's record of captioning ``images`` (host uint8), in
    blocks: each stage's output and the tokens (``dpt``: the depth
    model, whose reference makes the maps)."""
    ids = program.special_ids(cfg["vocab_size"])
    dec = ref_decoder.weights(served)
    feats, maps, dep, toks = [], [], [], []
    for lo in range(0, len(images), judge.BLOCK):
        x = torch.as_tensor(images[lo:lo + judge.BLOCK]).to(device)
        with torch.no_grad():
            f = LOW(grid_features(served, x, cfg["resnet_layers"],
                                  cfg["enc_img_size"], r=LOW))
            fused = f
            if "dpt" in cfg:
                m = LOW(dpt.reference.depth_maps(
                    judge.dpt_weights(served), x, cfg["dpt"], r=LOW))
                g = LOW(depth_features(served, m, cfg["enc_img_size"],
                                       r=LOW))
                maps.append(m)
                dep.append(g)
                fused = f + g
            with tf32(True):
                toks.append(ref_decoder.greedy(
                    dec, fused, ids["start"], ids["end"],
                    cfg["max_length"]).cpu().numpy())
        feats.append(f)
    return {"feats": feats, "maps": maps, "dep": dep,
            "tokens": np.concatenate(toks)}


class Patch:
    """``setattr`` that ``undo`` reverses (the faults' patcher)."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved = []


def with_fault(name: str):
    """The program's readings with fault ``name`` planted, at the cell's
    size through a one-second window."""
    from dcbench import faults
    from dcbench.bench import run_cell

    def fn(cell, seed, device):
        patch = Patch()
        if name != "none":
            faults.BY_NAME[name](patch)
        try:
            out = run_cell(Path.cwd(), cell.name, seed, 1.0, False, device,
                           t_origin=0.0)
        finally:
            patch.undo()
        return {k: v["value"] for k, v in out["checks"].items()}
    return fn


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    cell = spec.resolve(Path.cwd(), args.workload)
    fn = offline
    if args.fault:
        fn = with_fault(args.fault)
    for seed in args.seeds:
        t = time.time()
        got = fn(cell, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": round(time.time() - t, 1),
                          "readings": got}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
