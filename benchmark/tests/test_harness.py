"""The harness on the CPU at tiny sizes: names resolve through files (a
traffic mix, a per-layer metric and a depth model added from a temporary
directory run with no change to the harness), a sound run comes out
correct, and the control and each planted fault of a cell come out not
correct under the cell's limits."""

import json
import shutil
import types

import pytest
import torch

from dcbench import bench, control, faults, program, spec
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


def add_depth_model(root, model, offset=None):
    """A configuration ``depth-twin`` whose ``dpt`` block names ``model``,
    a copy of the DPT-hybrid's files under that name (its reference's
    maps moved by ``offset``), and its cell ``depth-twin.offline``: new
    files and entries only: the configuration is the DPT-hybrid's, with
    ``model`` added."""
    b = root / "benchmark"
    for kind in spec.DPT_FILES:
        text = (BENCH / kind / "dpt_hybrid.py").read_text()
        if kind == "reference" and offset is not None:
            text += ("\n_maps = depth_maps\n\n\ndef depth_maps(*a, **k):\n"
                     f"    return _maps(*a, **k) + {offset}\n")
        (b / kind / f"{model}.py").write_text(text)
    cfg = json.loads((b / "configs" / "depth-soft.json").read_text())
    cfg["dpt"] = dict(cfg["dpt"], model=model)
    (b / "configs" / "depth-twin.json").write_text(json.dumps(cfg))
    (b / "cells" / "depth-twin.offline.json").write_text(
        (BENCH / "cells" / "depth-soft.offline.json").read_text())
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "depth-twin", "source": "test",
                         "file": "benchmark/configs/depth-twin.json",
                         "reduced": [], "why": "test"})
    s["workloads"].append({"name": "depth-twin.offline", "config":
                           "depth-twin", "traffic": "offline", "chips": 1,
                           "why": "test"})
    for m in s["end_to_end"] + s["per_layer"]:
        if "depth-soft.offline" in m.get("workloads", []):
            m["workloads"].append("depth-twin.offline")
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    return cfg


def test_added_depth_model_resolves_by_name(root):
    """A depth model named by a configuration: its reference, count and
    weight rule are the files of its name in the cell's own directory."""
    cfg = add_depth_model(root, "dpt_twin")
    cell = spec.resolve(root, "depth-twin.offline")
    assert cell.dpt.name == "dpt_twin"
    b = root / "benchmark"
    assert cell.dpt.path("reference") == b / "reference" / "dpt_twin.py"
    hybrid_cfg = dict(cfg, dpt={k: v for k, v in cfg["dpt"].items()
                                if k != "model"})
    hybrid = spec.depth_model(hybrid_cfg)
    assert hybrid.name == "dpt_hybrid"
    assert cell.dpt.counts.ops(cfg["dpt"]) == hybrid.counts.ops(cfg["dpt"])
    out = run(root, "depth-twin.offline", trace=True)
    assert out["correct"], out["checks"]
    assert "depth_map" in out["checks"]
    assert out["metrics"]["mfu.offline"]["value"] > 0
    assert all(cell.dpt.path(k) in spec._LOADED for k in spec.DPT_FILES)
    twin = program.build(cfg, 5, "cpu", cell.dpt).served
    same = program.build(hybrid_cfg, 5, "cpu", hybrid).served
    assert twin.keys() == same.keys()
    assert all(torch.equal(twin[k], same[k]) for k in twin)


def test_named_reference_is_the_one_read(root):
    """The copy's reference, its maps moved by 0.5, fails ``depth_map``."""
    add_depth_model(root, "dpt_offset", offset=0.5)
    out = run(root, "depth-twin.offline")
    assert not out["correct"]
    assert out["checks"]["depth_map"]["value"] > 0.5 - 1e-3 > out[
        "checks"]["depth_map"]["limit"]
    assert all(v["value"] <= v["limit"] for k, v in out["checks"].items()
               if k != "depth_map")


def test_missing_depth_model_fails_at_resolve(root, monkeypatch, capsys):
    add_depth_model(root, "dpt_gone")
    (root / "benchmark" / "counts" / "dpt_gone.py").unlink()
    with pytest.raises(FileNotFoundError, match="counts/dpt_gone.py"):
        spec.resolve(root, "depth-twin.offline")
    monkeypatch.chdir(root)
    assert bench.main(["--workload", "depth-twin.offline", "--seed", "1",
                       "--seconds", "1"]) == 2
    got = capsys.readouterr()
    assert "dpt_gone" in got.err and got.out == ""


def test_roofline_k6_reads_the_group_norm_launches(root):
    """``roofline_k6``: the bound of each chunk's 52 GroupNorms over the
    two kernels' device time; nothing where the launches do not match."""
    cell = spec.resolve(root, "depth-soft.offline")
    norms = cell.dpt.counts.group_norms(cell.config["dpt"])
    chunks = [[12] * 4, [9] * 1]
    ops = [(f"void dcap::gn::{k}_kernel<float, 4>(...)", 0, 1000, 0)
           for _ in range(len(chunks) * len(norms))
           for k in ("stats", "apply")]
    ops += [("attention_bf16_kernel", 0, 10 ** 9, 0)]
    trace = types.SimpleNamespace(
        ops_named=lambda w: [o for o in ops if w in o[0]])
    ctx = types.SimpleNamespace(cell=cell, trace=trace,
                                counts={"chunk_steps": chunks})
    read = spec.reader(cell.bench_dir, "roofline_k6.offline")
    from counts import kernels
    least = sum(kernels.group_norm_seconds(len(rows), s * s, c, res, 4)
                for rows in chunks for s, c, res in norms)
    want = 100.0 * least / (2 * len(chunks) * len(norms) * 1e-6)
    assert read(ctx) == pytest.approx(want, rel=1e-12)
    ctx.counts = {"chunk_steps": chunks + [[9]]}
    assert read(ctx) is None
    base = spec.resolve(root, "base-soft.offline")
    assert read(types.SimpleNamespace(cell=base, trace=trace,
                                      counts={"chunk_steps": chunks})) is None


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
