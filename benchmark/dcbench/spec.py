"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (its ``file``), its traffic mix (``traffic/<mix>.json``),
its own file (``cells/<cell>.json``: the ``limits`` of its checks, and
under ``reports`` the count each end-to-end metric reports where the two
names differ), each per-layer metric's reader (``layer_metrics/
<metric>.py``, else ``layer_metrics/<stem>.py`` for a metric
``<stem>.<suffix>``: a function ``read(ctx)``) and the depth model a
configuration's ``dpt`` block names under ``model`` (``dpt_hybrid`` where
it names none): its plain reference ``reference/<model>.py`` (a function
``depth_maps(w, images_u8, cfg, r)``), its count ``counts/<model>.py``
(``ops(cfg)``, the operations of one image) and its weight draw
``weight_rules/<model>.py`` (``rule(name, shape, res)``, as
``dcbench/weights.py``'s rules). A new cell, mix, configuration, metric
or depth model is new files and new entries; nothing here changes.

A new depth model adds those three files and ``configs/<name>.json``
(its ``dpt`` block: ``model``, ``dtype``, and the keywords its port's
``DPTDepthEstimator`` takes, ``program.dpt_kwargs``), and to
``BENCHMARK.json`` its ``configs`` entry, its ``workloads`` and the
cell's name in the ``workloads`` of the metrics it reports, such as
``captions_per_s``. A configuration that names a model with a file
missing fails at ``resolve``, before set-up."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

SPEC = "BENCHMARK.json"
BENCH = Path(__file__).resolve().parents[1]     # the benchmark's own files
DPT_DEFAULT = "dpt_hybrid"
DPT_FILES = ("reference", "counts", "weight_rules")
# the files ``load`` has run, by path: like an import, once a process
_LOADED: Dict[Path, ModuleType] = {}


def load(path: Path) -> ModuleType:
    """The module of the file ``path`` (found by name, not imported: a
    test's temporary root holds files of the same names)."""
    if path not in _LOADED:
        name = re.sub(r"\W", "_", f"bench_{path.parent.name}_{path.stem}")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def dpt_name(dpt: Dict) -> str:
    """The depth model a configuration's ``dpt`` block names."""
    name = dpt.get("model", DPT_DEFAULT)
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"dpt model {name!r} is no file name")
    return name


@dataclasses.dataclass(frozen=True)
class DepthModel:
    """A depth model's files under ``bench_dir``, found by its name."""
    name: str
    bench_dir: Path

    def path(self, kind: str) -> Path:
        return self.bench_dir / kind / f"{self.name}.py"

    @property
    def reference(self) -> ModuleType:
        return load(self.path("reference"))

    @property
    def counts(self) -> ModuleType:
        return load(self.path("counts"))

    @property
    def rule(self) -> Callable:
        return load(self.path("weight_rules")).rule


def depth_model(cfg: Dict, bench_dir: Path = BENCH) -> Optional[DepthModel]:
    """The depth model of configuration ``cfg`` (None: it has no ``dpt``
    block); every file it needs is there, or this raises."""
    if "dpt" not in cfg:
        return None
    model = DepthModel(dpt_name(cfg["dpt"]), Path(bench_dir))
    for kind in DPT_FILES:
        if not model.path(kind).is_file():
            raise FileNotFoundError(
                f"configuration {cfg.get('name')!r} names the depth model "
                f"{model.name!r}, whose file {model.path(kind)} is missing")
    return model


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
    dpt: Optional[DepthModel]


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
    cfg = _json(root / conf["file"])
    return Cell(workload, int(w["chips"]), cfg,
                _json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                own.get("limits", {}), reports, e2e, per_layer, bench_dir,
                depth_model(cfg, bench_dir))


def reader(bench_dir: Path, metric: str) -> Callable:
    """The ``read(ctx)`` of ``layer_metrics/<metric>.py``, or of the
    stem's file where the metric has none of its own."""
    path = Path(bench_dir) / "layer_metrics" / f"{metric}.py"
    if not path.exists():
        path = path.with_name(metric.split(".")[0] + ".py")
    return load(path).read
