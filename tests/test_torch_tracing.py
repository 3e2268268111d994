"""The port's tracer (``utils/tracing.py``) on the caption path.

Tiny base-soft and depth-soft captioners (ResNet blocks 1,1,1,1 at 64x64,
f32 encoders, the tests' tiny DPT, as in ``test_torch_slice.py`` and
``test_torch_depth_slice.py``, with seeded weights of the port's own
initializers) caption one 130-image request at buckets (1, 16, 64): three
chunks of 64, 64 and 2 rows, the last padded to 16. The span tree and the
counters are checked against the request's shape and against counts made
here from the tokens returned; the decode's step count against the steps
the plain greedy decode ran; with tracing off nothing is recorded; the
spans share their clock with ``torch.profiler``'s events."""

import sys
import threading

import numpy as np
import pytest
import torch

from depth_image_captioning_pub_torch.config import ConfigTrain
from depth_image_captioning_pub_torch.data.tokenizer import SPECIAL
from depth_image_captioning_pub_torch.engine.evaluate import make_caption_fn
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.models.dpt import (
    TINY_DPT, DPTDepthEstimator)
from depth_image_captioning_pub_torch.ops.kernels import decode_seq
from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
from depth_image_captioning_pub_torch.utils import tracing
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

LAYERS = (1, 1, 1, 1)
HW = 64
MAX_LEN = 8
N_IMAGES = 130
BUCKETS = (1, 16, 64)
CHUNKS = ((64, 64), (64, 64), (2, 16))      # (valid rows, bucket)
WORDS = ["a", "dog", "runs", "in", "park", "cat", "sits", "on", "mat",
         "man", "rides", "bike", "red", "blue", SPECIAL.start, SPECIAL.end,
         SPECIAL.unk, SPECIAL.null]


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.stop()
    yield
    tracing.stop()


@pytest.fixture(scope="module")
def vocab():
    w2i = {w: i for i, w in enumerate(WORDS)}
    return w2i, {i: w for w, i in w2i.items()}


def _scale_convs(module, factor):
    """Default conv inits shrink activations layer by layer, which would
    give every image one caption; scaled kernels keep them apart."""
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() == 4:
                p.mul_(factor)


def _captioner(kind, w2i):
    cap = build_captioner(kind, len(w2i), ConfigTrain(),
                          encoder_dtype=torch.float32, resnet_layers=LAYERS,
                          device="cpu")
    cap.init(torch.Generator().manual_seed(0))
    _scale_convs(cap.encoder, 3.0)
    if cap.depth_module is not None:
        _scale_convs(cap.depth_module, 6.0)
    with torch.no_grad():       # rows end at different steps
        cap.decoder.out_b[w2i[SPECIAL.end]] += 0.5
    return cap


@pytest.fixture(scope="module")
def captioners(vocab):
    w2i, _ = vocab
    est = DPTDepthEstimator(dtype=torch.float32, image_size=HW, device="cpu",
                            **TINY_DPT)
    est.init(torch.Generator().manual_seed(1))
    return {"base-soft": (_captioner("base-soft", w2i), None),
            "depth-soft": (_captioner("depth-soft", w2i), est.depth_fn())}


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(3).integers(
        0, 256, (N_IMAGES, HW, HW, 3), dtype=np.uint8)


def _pipeline(captioners, vocab, kind, **kwargs):
    cap, depth_fn = captioners[kind]
    return CaptionPipeline(cap, *vocab, depth_fn=depth_fn, max_length=MAX_LEN,
                           batch_buckets=BUCKETS, image_hw=(HW, HW), **kwargs)


def _steps(tokens, end_id):
    """Each row's steps up to and including its first <end>, counted
    here."""
    out = []
    for row in tokens:
        hits = [t for t, tok in enumerate(row) if tok == end_id]
        out.append(hits[0] + 1 if hits else len(row))
    return np.array(out)


def _children(spans, parent, name=None):
    return [(i, s) for i, s in enumerate(spans) if s.parent == parent
            and (name is None or s.name == name)]


@pytest.mark.parametrize("kind", ["base-soft", "depth-soft"])
def test_span_tree_and_counters(kind, captioners, vocab, images):
    w2i, _ = vocab
    pipe = _pipeline(captioners, vocab, kind)
    want = pipe.caption_tokens(images)              # tracing off
    tracing.start()
    got = pipe.caption_tokens(images)
    spans, counters = tracing.stop()
    np.testing.assert_array_equal(got, want)

    requests = [(i, s) for i, s in enumerate(spans)
                if s.name == "pipeline.request"]
    assert len(requests) == 1
    req, rs = requests[0]
    assert (rs.parent, rs.request, rs.attrs) == (-1, req, {})
    for s in spans:
        assert s.request == req
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    chunks = _children(spans, req, "pipeline.chunk")
    assert [(s.attrs["rows"], s.attrs["bucket"]) for _, s in chunks] == \
        list(CHUNKS)
    inner = ["pipeline.h2d", "frozen.rgb_encoder", "decode"]
    if kind == "depth-soft":
        inner[2:2] = ["frozen.depth", "decode.depth_encoder"]
    for i, s in chunks:
        kids = _children(spans, i)
        assert [k.name for _, k in kids] == inner
        assert all(k.attrs == {} for _, k in kids)
        assert all(not _children(spans, j) for j, _ in kids)
    drains = _children(spans, req, "pipeline.drain")
    assert [s.attrs for _, s in drains] == [{}] * 3
    assert len(spans) == 1 + len(chunks) * (1 + len(inner)) + len(drains)
    # a chunk is drained after the next one's launch
    assert chunks[1][1].end_ns <= drains[0][1].start_ns

    steps = _steps(got, w2i[SPECIAL.end])
    run, lo = 0, 0
    for valid, bucket in CHUNKS:
        run += bucket * steps[lo:lo + valid].max()   # padding: row lo again
        lo += valid
    assert run < len(CHUNKS) * 64 * MAX_LEN          # some chunks end early
    assert counters == {
        "chunks": 3, "rows": 130, "padding_rows": 14,
        "decode.row_steps": int(steps.sum()), "decode.steps_run": int(run)}


def test_replicas_copy_apart(captioners, vocab, images):
    """Over two replicas each chunk has one copy a replica, and each
    replica's decode counts its own longest row."""
    w2i, _ = vocab
    pipe = _pipeline(captioners, vocab, "base-soft", devices=["cpu", "cpu"])
    tracing.start()
    got = pipe.caption_tokens(images)
    spans, counters = tracing.stop()
    for i, s in enumerate(spans):
        if s.name == "pipeline.chunk":
            assert [k.name for _, k in _children(spans, i)] == [
                "pipeline.h2d", "frozen.rgb_encoder", "decode"] * 2
    steps = _steps(got, w2i[SPECIAL.end])
    # buckets (2, 16, 64) over two replicas: the last chunk is 2 rows, one
    # a replica, with no padding
    parts = np.split(steps, [32, 64, 96, 128, 129])
    assert counters["decode.steps_run"] == sum(
        len(p) * int(p.max()) for p in parts)
    assert counters["decode.row_steps"] == int(steps.sum())
    assert (counters["chunks"], counters["padding_rows"]) == (3, 0)


@pytest.mark.parametrize("mode,kwargs", [
    ("greedy", {}), ("beam", {"beam_size": 2}),
    ("sample", {"sampling": {"top_k": 3}})])
def test_decode_span_by_mode(mode, kwargs, captioners, vocab, images):
    """The two stages outside a pipeline (as scored evaluation calls them)
    record their spans with no request, under one decode span whatever the
    mode; beam search counts no steps."""
    w2i, _ = vocab
    cap, _ = captioners["base-soft"]
    fn = make_caption_fn(cap, w2i[SPECIAL.start], max_length=MAX_LEN,
                         end_id=w2i[SPECIAL.end],
                         generator=torch.Generator().manual_seed(0),
                         **kwargs)
    x = torch.from_numpy(images[:4])
    tracing.start()
    tokens = fn.decode(fn.frozen(x)).numpy()
    spans, counters = tracing.stop()
    assert [(s.name, s.parent, s.request) for s in spans] == [
        ("frozen.rgb_encoder", -1, -1), ("decode", -1, -1)]
    steps = {"greedy": _steps(tokens, w2i[SPECIAL.end]).max(),
             "sample": MAX_LEN}
    assert counters == ({} if mode == "beam" else
                        {"decode.steps_run": 4 * int(steps[mode])})


def test_steps_run_counts_the_steps_the_decode_ran(captioners, vocab, images,
                                                   monkeypatch):
    """``decode.steps_run`` equals the rows times the steps of the greedy
    decode's plain version, counted here at its step function."""
    ran = []
    step = decode_seq.attention_lstm_step

    def counted(features, *args):
        ran.append(features.shape[0])
        return step(features, *args)
    monkeypatch.setattr(decode_seq, "attention_lstm_step", counted)
    pipe = _pipeline(captioners, vocab, "base-soft")
    tracing.start()
    pipe.caption_tokens(images)
    _, counters = tracing.stop()
    assert 0 < counters["decode.steps_run"] == sum(ran) < 3 * 64 * MAX_LEN


def test_steps_run_rule():
    """A call stops after the step in which its last row ends; it runs
    every step without an end id or with a row that never ends."""
    e = 5
    tokens = torch.tensor([[1, e, e, e], [2, 3, e, e], [e, e, e, e]])
    assert decode_seq.steps_run(tokens, e) == 3 * 3
    assert decode_seq.steps_run(tokens, -1) == 3 * 4
    tokens[1, 2:] = 4
    assert decode_seq.steps_run(tokens, e) == 3 * 4


def test_count_later_waits_for_stop():
    """A deferred count is computed at ``stop()``, added to the counter's
    direct counts, and dropped while tracing is off."""
    calls = []

    def value(n):
        calls.append(n)
        return n
    tracing.count_later("n", value, 7)
    tracing.start()
    tracing.count("n", 2)
    tracing.count_later("n", value, 3)
    assert calls == []
    assert tracing.stop() == ([], {"n": 5})
    assert calls == [3]


def test_sampling_counts_every_step(captioners, vocab, images):
    """Sampling runs max_length steps whatever the tokens; beam search
    counts no steps."""
    pipe = _pipeline(captioners, vocab, "base-soft", sample=True, top_k=3)
    tracing.start()
    got = pipe.caption_tokens(images[:20])
    _, counters = tracing.stop()
    assert counters["decode.steps_run"] == 64 * MAX_LEN     # one chunk
    assert counters["decode.row_steps"] == int(
        _steps(got, vocab[0][SPECIAL.end]).sum())
    pipe = _pipeline(captioners, vocab, "base-soft", beam_size=2)
    tracing.start()
    pipe.caption_tokens(images[:20])
    _, counters = tracing.stop()
    assert counters["rows"] == 20 and "decode.steps_run" not in counters


def test_tracing_off_records_nothing(captioners, vocab, images):
    off = tracing.span("pipeline.chunk", rows=1, bucket=1)
    assert off is tracing.span("x") is tracing.request("y") is tracing.OFF
    tracing.count("rows", 3)
    _pipeline(captioners, vocab, "depth-soft").caption_tokens(images[:20])
    assert not tracing.enabled()
    assert tracing.stop() == ([], {})


def test_threads_keep_their_own_parents():
    """A span opened on another thread does not hang from the spans open on
    this one; each thread's request is its own."""
    tracing.start()
    inside = threading.Event()
    done = threading.Event()

    def worker():
        with tracing.request("worker.request"):
            with tracing.span("worker.step"):
                inside.set()
                done.wait(10)

    t = threading.Thread(target=worker)
    with tracing.request("main.request"):
        t.start()
        inside.wait(10)
        with tracing.span("main.step"):
            done.set()
        t.join()
    spans, _ = tracing.stop()
    by = {s.name: (i, s) for i, s in enumerate(spans)}
    mi, wi = by["main.request"][0], by["worker.request"][0]
    assert (by["main.request"][1].parent, by["worker.request"][1].parent) \
        == (-1, -1)
    assert (by["main.step"][1].parent, by["main.step"][1].request) == (mi, mi)
    assert (by["worker.step"][1].parent, by["worker.step"][1].request) == \
        (wi, wi)


def test_threads_lose_no_update():
    """More threads than cores open spans and add to one counter with the
    interpreter switching threads every microsecond: no span and no count
    is lost, and every span hangs from its own thread's request."""
    threads, rounds = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tracing.start()

        def worker(k):
            with tracing.request("request", thread=k):
                for _ in range(rounds):
                    with tracing.span("step", thread=k):
                        tracing.count("steps")

        pool = [threading.Thread(target=worker, args=(k,))
                for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
        assert not any(t.is_alive() for t in pool)
        spans, counters = tracing.stop()
    finally:
        sys.setswitchinterval(interval)
    assert counters["steps"] == threads * rounds
    assert len(spans) == threads * (rounds + 1)
    for s in spans:
        if s.name == "step":
            req = spans[s.parent]
            assert s.request == s.parent
            assert (req.name, req.attrs) == ("request", s.attrs)


def test_restart_clears_the_record():
    """``start`` drops the record, also under a span that is still open:
    what opens after it hangs from nothing of the old record."""
    tracing.start()
    with tracing.span("a"):
        tracing.count("n", 2)
        tracing.start()
        with tracing.span("b", k=1):
            tracing.count("n")
    spans, counters = tracing.stop()
    assert [(s.name, s.parent, s.attrs) for s in spans] == [
        ("b", -1, {"k": 1})]
    assert counters["n"] == 1


def test_spans_share_the_profilers_clock():
    """An operation launched inside a span has its profiler event inside
    the span's interval: the clock the benchmark charges device work
    by."""
    a = torch.randn(256, 256)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tracing.start()
        with tracing.span("outer"):
            torch.mm(a, a)
        spans, _ = tracing.stop()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm"]
    assert len(events) == 1 and len(spans) == 1
    assert spans[0].start_ns <= events[0].start_ns() <= \
        events[0].end_ns() <= spans[0].end_ns
