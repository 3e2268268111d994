"""What a run needs of its machine and what it records about it."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "depth_image_captioning_pub_tpu")


def process_seconds() -> float:
    """Seconds since this process started (its start time in /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.process_time()


def cuda_problem(chips: int) -> str:
    """Why the card cannot run a cell of ``chips`` cards ("" if it can)."""
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"{torch.cuda.device_count()} CUDA devices, the cell needs "
                f"{chips}")
    return ""


def cuda_context(device) -> None:
    """The card's CUDA context, made (set-up's ``context`` part)."""
    import torch
    torch.empty(1, device=device)
    torch.cuda.synchronize(device)


def kernel_library() -> None:
    """The program's kernel library, loaded from ``build/`` of the
    checkout (built there first where it is not)."""
    from depth_image_captioning_pub_torch.ops.kernels import _build
    _build.load()


def card() -> Dict[str, str]:
    """The card's name and power limit (nvidia-smi), for the records."""
    import torch
    out = {"name": torch.cuda.get_device_name(0), "power_limit": "unknown"}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        if q.returncode == 0 and q.stdout.strip():
            out["power_limit"] = q.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    the whole name compared (the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
