"""Benchmark of the PyTorch/CUDA captioning port: one run of one cell.

    python3 benchmark/run.py --workload depth-soft.offline --seed 7 \
        --seconds 20 --trace 0

Run from the root of a checkout. Cells, metrics and bounds are in
``BENCHMARK.json``; the harness is ``benchmark/dcbench``.
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]   # the harness; the program

if __name__ == "__main__":      # (a spawned client imports this file too)
    from dcbench.bench import main
    sys.exit(main())
