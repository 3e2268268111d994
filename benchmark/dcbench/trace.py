"""The traced run: the benchmark's spans around its calls into the program
(host intervals it stamps itself, on the clock the profiler stamps with,
opened and closed by the benchmark and by forward hooks it registers on
the program's modules), one profiler window of the device's activity
(``torch.profiler`` with CUDA activity alone: CPU op recording doubled a
launch-bound step's host time on the card), and what the per-layer
readers take from them: the device's operations, each attributed to the
span in which the host launched it, the busy and idle time of the
window, and the breakdown.

Untraced runs stamp no span and register no hook.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "bench/"
WINDOW = PREFIX + "window"
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")


class Trace:
    """Spans and the profiler window; inert unless ``enabled``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.window_s = 0.0
        self._hooks = []
        self.spans: List[Tuple[str, int, int]] = []
        self.data: Optional["TraceData"] = None

    @contextlib.contextmanager
    def _stamp(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((PREFIX + name, t0, time.time_ns()))

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return self._stamp(name)

    def hook(self, module: torch.nn.Module, name: str) -> None:
        """A span around every forward of ``module``."""
        if not self.enabled:
            return
        opened = []

        def pre(mod, args):
            opened.append(time.time_ns())

        def post(mod, args, out):
            self.spans.append((PREFIX + name, opened.pop(), time.time_ns()))

        self._hooks += [module.register_forward_pre_hook(pre),
                        module.register_forward_hook(post)]

    def wrap(self, obj, attr: str, name: str) -> None:
        """A span around every call of ``obj.attr`` (a bound method; set on
        the instance, before anything takes a reference to it)."""
        if not self.enabled:
            return
        fn = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        setattr(obj, attr, wrapped)

    @contextlib.contextmanager
    def window(self, device):
        """The profiled window (a ``bench/window`` span inside it)."""
        if not self.enabled:
            yield
            return
        cuda = torch.device(device).type == "cuda"
        if cuda:
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.spans = []
        t0 = time.perf_counter()
        try:
            with self.span("window"):
                yield
                if cuda:
                    torch.cuda.synchronize()
            self.window_s = time.perf_counter() - t0
        finally:
            if cuda:
                self.prof.__exit__(None, None, None)
            for h in self._hooks:
                h.remove()
        self.data = TraceData.of(self.prof, self.spans)


class TraceData:
    """What one profiler window holds, in nanoseconds of its clock."""

    def __init__(self, ops, spans, window, unmatched):
        self.ops: List[Tuple[str, int, int, int]] = ops  # name, s, e, launch
        self.spans: List[Tuple[str, int, int]] = spans
        self.window = window
        self.unmatched = unmatched       # device ops with no launch found

    @classmethod
    def of(cls, prof, spans) -> "TraceData":
        """The device's operations of ``prof`` (None: none) and the host
        ``spans``."""
        events = prof.profiler.kineto_results.events() if prof else []
        cpu = torch.autograd.DeviceType.CPU
        launches, device = {}, []
        for e in events:
            if e.device_type() == cpu:
                if any(w in e.name() for w in LAUNCH_WORDS):
                    launches[e.correlation_id()] = e.start_ns()
            elif not e.is_user_annotation():
                device.append(e)
        ops, unmatched = [], 0
        for e in device:
            launch = launches.get(e.correlation_id())
            if launch is None:
                launch = launches.get(e.linked_correlation_id())
            if launch is None:
                unmatched += 1
                launch = e.start_ns()
            ops.append((e.name(), e.start_ns(), e.end_ns(), launch))
        ops.sort(key=lambda o: o[1])
        win = [s for s in spans if s[0] == WINDOW]
        window = (win[0][1], win[0][2]) if win else (
            (ops[0][1], ops[-1][2]) if ops else (0, 0))
        return cls(ops, spans, window, unmatched)

    def busy_ns(self) -> int:
        """The union of the device operations' intervals in the window."""
        lo, hi = self.window
        busy, end = 0, lo
        for _, s, e, _ in self.ops:
            s, e = max(s, end), min(e, hi)
            if e > s:
                busy += e - s
                end = e
        return busy

    def span_ops(self, name: str) -> List[Tuple[str, int, int, int]]:
        """The device operations launched inside any ``bench/<name>``."""
        ivs = sorted((s, e) for n, s, e in self.spans
                     if n == PREFIX + name)
        starts = [s for s, _ in ivs]
        out = []
        for op in self.ops:
            i = bisect.bisect_right(starts, op[3]) - 1
            if i >= 0 and op[3] <= ivs[i][1]:
                out.append(op)
        return out

    def span_count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.spans if n == PREFIX + name)

    def ops_named(self, word: str) -> List[Tuple[str, int, int, int]]:
        return [op for op in self.ops if word in op[0]]

    def host_spans_at(self, times: List[int]) -> List[str]:
        """The innermost benchmark span open on the host at each time."""
        marks = [(s, 0, n) for n, s, _ in self.spans]
        marks += [(e, 2, n) for n, _, e in self.spans]
        marks += [(t, 1, i) for i, t in enumerate(times)]
        out = ["outside spans"] * len(times)
        stack: List[str] = []
        for _, kind, what in sorted(marks, key=lambda m: (m[0], m[1])):
            if kind == 0:
                stack.append(what)
            elif kind == 2:
                if what in stack:
                    del stack[len(stack) - 1 - stack[::-1].index(what)]
            elif stack:
                out[what] = stack[-1][len(PREFIX):]
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_op = defaultdict(int)
        for name, s, e, _ in self.ops:
            by_op[name[:160]] += e - s
        lo, hi = self.window
        idle, end = [], lo
        for _, s, e, _ in self.ops + [("", hi, hi, hi)]:
            if s > end and end < hi:
                idle.append((end, min(s, hi) - end))
            end = max(end, e)
        gaps = defaultdict(int)
        for (_, ns), name in zip(idle, self.host_spans_at(
                [t for t, _ in idle])):
            gaps[name] += ns
        pick = lambda d: [[k, v / 1e9] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": pick(by_op), "idle_gaps": pick(gaps)}
