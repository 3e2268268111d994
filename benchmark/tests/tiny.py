"""A benchmark root at a size a CPU test holds: the real cells' traffic
kinds and readers over tiny configurations (ResNet blocks 1,1,1,1, a
3-block DPT at 64x64, a 60-word vocabulary)."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TINY_DPT = {"image_size": 64, "patch": 16, "pretrain_grid": 4, "vit_dim": 128,
            "vit_heads": 4, "vit_blocks": 3, "mlp_ratio": 4, "hooks": [1, 2],
            "resnet_layers": [1, 1, 1], "features": 32, "dtype": "float32",
            "gelu": "erf", "head": "full"}


def tiny_config(name: str) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(resnet_layers=[1, 1, 1, 1], vocab_size=60,
               encoder_dtype="float32")
    if "dpt" in cfg:
        cfg["dpt"] = dict(TINY_DPT)
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
    real readers, and the ``cells`` files (default: the real ones'
    reports and no limits, so every check passes)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp / "benchmark"
    for sub in ("configs", "traffic", "cells"):
        (b / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "layer_metrics", b / "layer_metrics",
                    dirs_exist_ok=True)
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
