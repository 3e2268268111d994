"""One run of one cell: set-up, the measured (or traced) window, the
check, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (``setup_s``) runs from the process's start to the first timed
request, in parts that every run reports on standard error
(``setup_parts``): ``import`` (the interpreter, torch and the harness),
``program`` (the port's package), ``context`` (the card's CUDA context),
``kernels`` (the kernel library: built into ``build/`` of the checkout on
a first run, loaded after), and the traffic's own: ``weights`` (drawn on
the card from the seed), ``inputs`` and ``warmup`` (the cell's shapes).
The window then runs the traffic for ``--seconds`` (``--trace 1``: the
traffic's ``trace_seconds`` untraced, then as long under the profiler).
Once it has closed, the peak memory is read, the program freed and the
reference run; every number compared is printed beside its limit, last
on standard error and last in the result line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from dcbench import env, spec
from dcbench.judge import worst_to_checks
from dcbench.trace import Trace


def modes():
    from dcbench import offline
    return {"closed_loop": offline.ClosedLoop}


# counts a run reports beside its metrics, on standard error
INFO = ("caption_steps", "chunks_ended_early", "captions", "request_ms")


class Laps:
    """Seconds of each part of set-up, from the origin on."""

    def __init__(self, origin: float):
        self.at = origin
        self.parts: Dict[str, float] = {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = now - self.at
        self.at = now


@dataclasses.dataclass
class ReaderContext:
    """What a per-layer reader may read: the cell's files, the traced
    window (``trace``: ``trace.TraceData``; ``window_s``), the counts the
    traffic made in it, and those of an untraced window of the same
    length just before it (``plain``: the profiler slows a launch-bound
    host by half again, so host-clock rates come from there). Counts hold
    ``model_flops`` and ``work`` (captions) done over
    ``work_s`` seconds."""
    cell: spec.Cell
    trace: object
    window_s: float
    counts: Dict
    plain: Dict


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t_origin: Optional[float] = None,
             laps: Optional[Laps] = None) -> Dict:
    """The result of one run (the dict printed as the last line).
    ``t_origin``: the seconds set-up had taken before the call (default:
    since the process started); ``laps``: its parts so far."""
    import torch
    t_origin = time.perf_counter() - (env.process_seconds()
                                      if t_origin is None else t_origin)
    laps = laps or Laps(t_origin)
    cell = spec.resolve(root, workload)
    if torch.device(device).type == "cuda":
        env.cuda_context(device)
        laps("context")
        env.kernel_library()
        laps("kernels")
    tr = Trace(trace)
    mode = modes()[cell.traffic["kind"]](cell, seed, device, tr, laps)
    setup_s = time.perf_counter() - t_origin
    window = min(seconds, cell.traffic["trace_seconds"]) if trace else seconds
    plain = mode.window(window) if trace else None
    with tr.window(device):
        counts = mode.window(window)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    readings = mode.judge()
    checks = worst_to_checks(readings, cell.limits)
    for name in cell.limits:
        if name not in readings:
            raise RuntimeError(f"limit {name!r} names no reading")
    info = {"tokens_compared": readings.get("tokens_compared"),
            "setup_parts": laps.parts}
    info.update({k: counts[k] for k in INFO if k in counts})
    if trace:
        ctx = ReaderContext(cell, tr.data, tr.window_s, counts, plain)
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(cell.bench_dir, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": setup_s if m["name"] == "setup_s"
                               else counts[cell.reports[m["name"]]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": all(c.ok for c in checks) and bool(checks),
           "attempted": counts["attempted"], "failed": counts["failed"],
           "metrics": metrics, "device": dev}
    if trace:
        data = tr.data
        dev["busy_s"] = data.busy_ns() / 1e9
        dev["window_s"] = tr.window_s
        out["breakdown"] = data.breakdown()
        info["unmatched_device_ops"] = data.unmatched
    out["info"] = info
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return out


def check_lines(result: Dict) -> List[str]:
    return [f"check {k}: {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}"
            for k, v in result["checks"].items()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    laps = Laps(time.perf_counter() - env.process_seconds())
    laps("import")
    try:
        cell = spec.resolve(root, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    try:
        import torch  # noqa: F401
        import depth_image_captioning_pub_torch  # noqa: F401
        laps("program")
    except ImportError as e:
        print(f"benchmark: the program is not importable: {e}",
              file=sys.stderr)
        return 2
    problem = env.cuda_problem(cell.chips)
    if problem:
        print(f"benchmark: no card to run on: {problem}", file=sys.stderr)
        return 3
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), laps=laps)
    card = env.card()       # after the window: nvidia-smi is no set-up
    print(f"card: {card['name']}, power limit {card['power_limit']}",
          file=sys.stderr)
    result["info"]["power_limit"] = card["power_limit"]
    bad = env.forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package are loaded: "
              f"{bad}", file=sys.stderr)
        return 4
    print(json.dumps(result["info"]), file=sys.stderr)
    for line in check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
