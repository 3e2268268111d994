"""The benchmark's tests: the harness, the reference and the counts on the
CPU (at tiny sizes), and the card's checks under the ``cuda`` marker.

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest

_BENCH = Path(__file__).resolve().parents[1]
for _p in (str(_BENCH.parent), str(_BENCH), str(_BENCH / "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
