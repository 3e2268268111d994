"""Training logs (counterpart of the JAX ``utils/logging.py``): the
reference's per-epoch ``epoch, loss`` CSV files, one JSON object a line of
structured metrics, and the moving-average progress line. The profiler
window of the JAX package (``ProfilerTrace``) is not ported; the trainer's
``--profile`` flags say so.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import deque
from typing import Dict


class CsvLossLog:
    """Append-only 'epoch, loss' CSV, the reference's format."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def append(self, epoch: int, loss: float) -> None:
        with open(self.path, "a") as f:
            print(f"{epoch}, {loss}", file=f)


class JsonlLog:
    """Structured metrics, one JSON object per line, each with its
    ``time``."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def append(self, record: Dict) -> None:
        record = dict(record, time=time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


class ProgressMeter:
    """Moving-average loss line on stderr every ``print_every`` steps."""

    def __init__(self, window: int = 100, desc: str = "", quiet: bool = False,
                 print_every: int = 50):
        self.losses: deque = deque(maxlen=window)
        self.desc = desc
        self.quiet = quiet
        self.print_every = print_every
        self.count = 0
        self._t0 = time.time()

    def update(self, loss: float) -> None:
        self.losses.append(loss)
        self.count += 1
        if not self.quiet and self.count % self.print_every == 0:
            avg = sum(self.losses) / len(self.losses)
            rate = self.count / (time.time() - self._t0)
            print(f"\r{self.desc} step {self.count} "
                  f"loss(ma{self.losses.maxlen})={avg:.4f} "
                  f"{rate:.2f} it/s", end="", file=sys.stderr)

    def update_lazy(self, loss_fn) -> None:
        """Like ``update``, but fetches the loss (``loss_fn()``, a device
        value) only on the steps that print, so the loop does not wait on
        the card every step."""
        self.count += 1
        if not self.quiet and self.count % self.print_every == 0:
            loss = float(loss_fn())
            self.losses.append(loss)
            rate = self.count / (time.time() - self._t0)
            print(f"\r{self.desc} step {self.count} loss={loss:.4f} "
                  f"{rate:.2f} it/s", end="", file=sys.stderr)

    def close(self) -> None:
        if not self.quiet:
            print(file=sys.stderr)

    @property
    def moving_avg(self) -> float:
        return sum(self.losses) / len(self.losses) if self.losses else 0.0
