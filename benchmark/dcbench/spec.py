"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (its ``file``), its traffic mix (``traffic/<mix>.json``),
its own file (``cells/<cell>.json``: the ``limits`` of its checks, and
under ``reports`` the count each end-to-end metric reports where the two
names differ) and each per-layer metric's reader (``layer_metrics/
<metric>.py``, else ``layer_metrics/<stem>.py`` for a metric
``<stem>.<suffix>``: a function ``read(ctx)``). A new cell, mix,
configuration or metric is a new file and new entries; nothing here
changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List

SPEC = "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    reports: Dict[str, str]       # end-to-end metric -> count
    end_to_end: List[Dict]
    per_layer: List[Dict]
    bench_dir: Path


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def resolve(root: Path, workload: str) -> Cell:
    """The cell named ``workload`` of ``root``'s ``BENCHMARK.json``."""
    root = Path(root)
    spec = _json(root / SPEC)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {SPEC}; one of "
                       f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench_dir = root / spec["paths"][0]
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", [workload])
                 and m["moves"] in names]
    own = _json(bench_dir / "cells" / f"{workload}.json")
    reports = {m["name"]: own.get("reports", {}).get(m["name"], m["name"])
               for m in e2e if m["name"] != "setup_s"}
    return Cell(workload, int(w["chips"]), _json(root / conf["file"]),
                _json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                own.get("limits", {}), reports, e2e, per_layer, bench_dir)


def reader(bench_dir: Path, metric: str) -> Callable:
    """The ``read(ctx)`` of ``layer_metrics/<metric>.py``, or of the
    stem's file where the metric has none of its own."""
    path = Path(bench_dir) / "layer_metrics" / f"{metric}.py"
    if not path.exists():
        path = path.with_name(metric.split(".")[0] + ".py")
    mod_name = "layer_metric_" + re.sub(r"\W", "_", metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
