"""A benchmark root at a size a CPU test holds: the real cells' traffic
kinds, readers and depth models' files over tiny configurations (ResNet
blocks 1,1,1,1, a DPT of one block more than it has taps at 64x64, a
60-word vocabulary)."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from dcbench.spec import DPT_FILES

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def tiny_dpt(d: dict) -> dict:
    """A ``dpt`` block at 64x64 in float32: width 128 of 4 heads,
    features 32, the taps after blocks 1.. and one block more, one
    ResNetV2 block a stage (where the model has them)."""
    d = dict(d, image_size=64, pretrain_grid=4, vit_dim=128, vit_heads=4,
             features=32, dtype="float32", vit_blocks=len(d["hooks"]) + 1,
             hooks=list(range(1, len(d["hooks"]) + 1)))
    if "resnet_layers" in d:
        d["resnet_layers"] = [1] * len(d["resnet_layers"])
    return d


def tiny_config(name: str) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(resnet_layers=[1, 1, 1, 1], vocab_size=60,
               encoder_dtype="float32")
    if "dpt" in cfg:
        cfg["dpt"] = tiny_dpt(cfg["dpt"])
        cfg["depth_cnn"] = dict(cfg["depth_cnn"], dtype="float32")
    return cfg


def tiny_traffic(name: str) -> dict:
    tr = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    tr.update(images_per_request=6, batch_buckets=[1, 4], distinct_requests=2,
              trace_seconds=0.5)
    return tr


def make_root(tmp: Path, cells: dict = None) -> Path:
    """``tmp`` laid out as a checkout's benchmark: ``BENCHMARK.json`` (the
    real one's cells and metrics), tiny configurations and traffic, the
    real readers and depth models' files, and the ``cells`` files
    (default: the real ones' reports and no limits, so every check
    passes)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp / "benchmark"
    for sub in ("configs", "traffic", "cells"):
        (b / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("layer_metrics",) + DPT_FILES:
        shutil.copytree(BENCH / sub, b / sub, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for c in spec["configs"]:
        (b / "configs" / f"{c['name']}.json").write_text(json.dumps(
            tiny_config(c["name"])))
    for w in spec["workloads"]:
        (b / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(
            tiny_traffic(w["traffic"])))
        own = json.loads((BENCH / "cells" / f"{w['name']}.json").read_text())
        own = (cells or {}).get(w["name"], dict(own, limits={}))
        (b / "cells" / f"{w['name']}.json").write_text(json.dumps(own))
    (tmp / "BENCHMARK.json").write_text(json.dumps(copy.deepcopy(spec)))
    return tmp
