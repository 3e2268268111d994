"""The command as the driver runs it: from a directory that holds only
``BENCHMARK.json`` and the benchmark's files it exits non-zero and prints
no result; here, with no card, the same; on the card (``cuda``), every
cell at a tiny size comes out correct."""

import json
import shutil
import subprocess
import sys

import pytest

from dcbench.bench import run_cell
from tiny import BENCH, make_root

ARGS = ["--workload", "depth-soft.offline", "--seed", "2147483711",
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _run(tmp_path)
    assert got.returncode != 0
    assert got.stdout.strip() == ""


def test_no_card_gives_no_result(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    got = _run(BENCH.parent)
    assert got.returncode != 0
    assert got.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["depth-soft.offline", "base-soft.offline"])
def test_tiny_cells_on_the_card(cuda_device, tmp_path, cell):
    cells = {c: json.loads((BENCH / "cells" / f"{c}.json").read_text())
             for c in ("depth-soft.offline", "base-soft.offline")}
    root = make_root(tmp_path, cells)
    out = run_cell(root, cell, 2147483713, 0.5, True, device=cuda_device,
                   t_origin=0)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
