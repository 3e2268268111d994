"""Training logs (counterpart of the JAX ``utils/logging.py``): the
reference's per-epoch ``epoch, loss`` CSV files, one JSON object a line of
structured metrics, the moving-average progress line, and
``ProfilerTrace``, the trainer's profiler window (``--profile DIR
--profile-start N --profile-stop M``): ``torch.profiler`` over the host
steps [N, M), CPU and CUDA activities, exported as a Chrome trace into
DIR.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import deque
from typing import Dict, Optional


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


class ProfilerTrace:
    """A ``torch.profiler`` window around a run of steps (the JAX
    package's ``jax.profiler`` trace window). ``maybe_start`` opens it
    (CPU activities, and CUDA's when a card is present), ``maybe_stop``
    closes it and writes ``trace_<pid>_<n>.json`` (a Chrome trace) into
    ``log_dir``, returning its path; both are no-ops when there is nothing
    to do, so the loop can always call ``maybe_stop`` on its way out."""

    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self.paths = []
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def maybe_start(self) -> None:
        if not self.log_dir or self._prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof = profile(activities=activities)
        self._prof.__enter__()

    def maybe_stop(self) -> Optional[str]:
        if self._prof is None:
            return None
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        path = os.path.join(self.log_dir, f"trace_{os.getpid()}_"
                                          f"{len(self.paths)}.json")
        prof.export_chrome_trace(path)
        self.paths.append(path)
        return path
