"""The port's spans and counters: one in-memory record, off by default.

    from depth_image_captioning_pub_torch.utils import tracing

    tracing.start()                      # clears the record, turns it on
    pipe.caption_tokens(images)
    spans, counters = tracing.stop()     # turns it off, returns the record

Code marks its layers with ``with tracing.span("pipeline.chunk", rows=64,
bucket=64):`` (``tracing.request(...)`` for the span a request's work
hangs from) and adds to counters with ``tracing.count("rows", 64)``. While
tracing is off, ``span`` and ``request`` return one shared context manager
that does nothing, and ``count`` returns at once: a call costs a read of
this module's flag, no clock read and no ``torch`` call.

While it is on, a span records its name, its start and end in
``time.time_ns()`` (the clock whose readings ``torch.profiler``'s events
carry, so a device operation can be charged to the span its launch fell
in), the index of its parent (the innermost span open on the same thread:
a server captions on a worker thread), the index of the request span it
belongs to and its integer attributes. ``count_later`` takes a count that
needs a device result the caller does not wait for: ``stop()`` computes
it.

The spans of the caption path (``pipeline.py``, ``engine/evaluate.py``):

    pipeline.request      a ``caption_tokens`` call
      pipeline.chunk      a chunk's padding, host tensor and launch (rows,
                          bucket)
        pipeline.h2d      the images' copy to the device (one a replica)
        frozen.rgb_encoder  /255, ImageNet normalization, the RGB encoder
        frozen.depth      the depth function (resizes, DPT, standardize)
        decode.depth_encoder  the depth CNN or MLP
        decode            the decode call, whatever its mode
      pipeline.drain      a chunk's tokens to the host

and its counters: ``chunks``, ``rows``, ``padding_rows`` and
``decode.row_steps`` (each valid row's steps up to and including its
first <end>), added by the drain from the tokens, and
``decode.steps_run`` (the rows a decode call ran times the steps it ran),
added by the decode path that runs the steps (``models/decoder.py``,
``ops/kernels/decode_seq.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]    # None: still open when the record was stopped
    parent: int              # index of the enclosing span; -1: none
    request: int             # index of the request span; -1: none
    attrs: Dict[str, int]


class _Off:
    """The context manager of every span while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()

_on = False
_session = 0             # start() count: stacks outlive a record
_lock = threading.Lock()
_local = threading.local()
_spans: List[list] = []
_counters: Dict[str, int] = {}
_later: List[tuple] = []     # (counter, fn, args) for stop()


class _Open:
    __slots__ = ("name", "attrs", "is_request", "rec")

    def __init__(self, name: str, attrs: Dict[str, int], is_request: bool):
        self.name, self.attrs, self.is_request = name, attrs, is_request

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent, req = -1, -1
        if stack and stack[-1][0] == _session:
            _, parent, req = stack[-1]
        spans = _spans
        self.rec = [self.name, time.time_ns(), None, parent, req, self.attrs]
        with _lock:
            index = len(spans)
            spans.append(self.rec)
        if self.is_request:
            req = self.rec[4] = index
        stack.append((_session, index, req))
        return None

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        _local.stack.pop()
        return False


def span(name: str, **attrs: int):
    """A context manager that records ``name`` over its block while
    tracing is on."""
    if not _on:
        return OFF
    return _Open(name, attrs, False)


def request(name: str, **attrs: int):
    """``span``, for a request: the spans inside it carry its index."""
    if not _on:
        return OFF
    return _Open(name, attrs, True)


def enabled() -> bool:
    return _on


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def count_later(name: str, fn: Callable[..., int], *args) -> None:
    """Add ``fn(*args)`` to the counter ``name`` at ``stop()`` while
    tracing is on: for a count read from a device result, which the
    caller does not wait for."""
    if not _on:
        return
    with _lock:
        _later.append((name, fn, args))


def start() -> None:
    """Clear the record and turn tracing on."""
    global _on, _session, _spans, _counters, _later
    with _lock:
        _session += 1
        _spans, _counters, _later = [], {}, []
    _on = True


def stop() -> Tuple[List[Span], Dict[str, int]]:
    """Turn tracing off; the spans in the order they opened and the
    counters since ``start()`` (none if it was not started)."""
    global _on, _spans, _counters, _later
    _on = False
    with _lock:
        spans, counters, later = _spans, _counters, _later
        _spans, _counters, _later = [], {}, []
    counters = dict(counters)
    for name, fn, args in later:
        counters[name] = counters.get(name, 0) + int(fn(*args))
    return [Span(*rec) for rec in spans], counters
