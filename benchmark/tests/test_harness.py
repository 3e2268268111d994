"""The harness on the CPU at tiny sizes: names resolve through files (a
traffic mix and a per-layer metric added from a temporary directory run
with no change to the harness), a sound run comes out correct, and the
control and each planted fault of a cell come out not correct under the
cell's limits."""

import json
import shutil

import pytest
import torch

from dcbench import control, faults, spec
from dcbench.bench import run_cell
from tiny import BENCH, make_root

CELLS = ("depth-soft.offline", "base-soft.offline")


def cell_files():
    return {c: json.loads((BENCH / "cells" / f"{c}.json").read_text())
            for c in CELLS}


@pytest.fixture
def root(tmp_path):
    torch.manual_seed(0)
    return make_root(tmp_path, cell_files())


def run(root, cell, trace=False, seed=2 ** 31 + 11):
    return run_cell(root, cell, seed, 0.2, trace, device="cpu", t_origin=0)


def test_added_mix_and_metric_resolve_by_name(root):
    """A new mix, a new cell and a new per-layer metric: files and
    entries only."""
    b = root / "benchmark"
    mix = json.loads((b / "traffic" / "offline.json").read_text())
    mix.update(images_per_request=3, batch_buckets=[1, 2])
    (b / "traffic" / "tiny_mix.json").write_text(json.dumps(mix))
    (b / "layer_metrics" / "requests_seen.tiny_mix.py").write_text(
        "def read(ctx):\n    return float(ctx.counts['attempted'])\n")
    (b / "cells" / "base-soft.tiny_mix.json").write_text(json.dumps(
        {"reports": {"captions_per_s.base": "captions"}}))
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["workloads"].append({"name": "base-soft.tiny_mix", "config":
                           "base-soft", "traffic": "tiny_mix", "chips": 1,
                           "why": "test"})
    e2e = {m["name"]: m for m in s["end_to_end"]}
    e2e["captions_per_s.base"]["workloads"].append("base-soft.tiny_mix")
    layer = {m["name"]: m for m in s["per_layer"]}
    layer["mfu.base"]["workloads"].append("base-soft.tiny_mix")
    s["per_layer"].append({"name": "requests_seen.tiny_mix", "unit": "n",
                           "better": "higher", "source": "program_counter",
                           "layer": "entry", "moves": "captions_per_s.base",
                           "workloads": ["base-soft.tiny_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    cell = spec.resolve(root, "base-soft.tiny_mix")
    assert cell.traffic["images_per_request"] == 3
    assert [m["name"] for m in cell.per_layer][-1] == "requests_seen.tiny_mix"
    out = run(root, "base-soft.tiny_mix", trace=True)
    got = out["metrics"]["requests_seen.tiny_mix"]
    assert got == {"value": float(out["attempted"]), "unit": "n"}
    # a metric with no reader of its own is read by its stem's
    assert out["metrics"]["mfu.base"]["value"] > 0
    plain = run(root, "base-soft.tiny_mix")      # the count it names
    assert plain["metrics"]["captions_per_s.base"]["value"] == plain[
        "info"]["captions"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    out = run(root, cell)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(cell_files()[cell]["limits"])
    names = {m["name"] for m in spec.resolve(root, cell).end_to_end}
    assert set(out["metrics"]) == names


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    """The reference in the precision below the stated one fails."""
    c = spec.resolve(root, cell)
    got = control.offline(c, 2 ** 31 + 5, "cpu")
    assert any(got[k] > lim for k, lim in c.limits.items()), got


FAULTS = [(c, f) for c in CELLS for f in faults.CAPTIONING]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_planted_fault_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run(root, cell)
    assert not out["correct"], out["checks"]


def test_run_needs_its_files(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(
        (BENCH.parent / "BENCHMARK.json").read_text())
    shutil.copytree(BENCH / "configs", tmp_path / "benchmark" / "configs")
    with pytest.raises(OSError):
        spec.resolve(tmp_path, CELLS[0])
