"""The port's caption server (``depth_image_captioning_pub_torch/serve.py``)
on the CPU: each test of ``tests/test_serve.py`` on the port, and

* parity: the JAX server and the port's, on one set of bridged weights
  (f32 encoders), answer the same caption for the same PNG and JPEG bytes;
* a refused request (413, 404, 400) closes its connection (the JAX server
  leaves a 413's body unread on a keep-alive connection);
* decompression bombs and a negative or unreadable Content-Length get a
  400, and the server answers on;
* ``/reload`` over a pipeline built by ``from_experiment`` lands the
  rewritten files' weights exactly (a fresh pipeline's captions);
* ``--sample``: two servers with one seed answer the same captions to the
  same sequential requests;
* ``--devices`` above 1 takes that many cards (raising when fewer are
  visible); ``--export-dir`` serves an artifact.

Every server binds port 0 and is stopped in its fixture's teardown or a
``finally``; every request carries its own timeout.
"""

import http.client
import io
import json
import pickle
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from depth_image_captioning_pub_tpu.config import ConfigEval as JConfigEval
from depth_image_captioning_pub_tpu.models import captioner as jcaptioner
from depth_image_captioning_pub_tpu.pipeline import (
    CaptionPipeline as JCaptionPipeline)
from depth_image_captioning_pub_tpu.serve import serve as jserve
from depth_image_captioning_pub_torch import cli
from depth_image_captioning_pub_torch import serve as serve_mod
from depth_image_captioning_pub_torch.config import ConfigEval
from depth_image_captioning_pub_torch.data.image_io import decode_image_bytes
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
from depth_image_captioning_pub_torch.serve import (
    CaptionService, _Job, _run_forever, serve)
from depth_image_captioning_pub_torch.utils.checkpoint import save_component
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    params_from_jax, params_to_jax)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

TIMEOUT = 60
LAYERS = (1, 1, 1, 1)


def _vocab():
    w2i = {f"w{i}": i for i in range(16)}
    w2i.update({"<start>": 16, "<end>": 17, "<unk>": 18, "<null>": 19})
    return w2i, {i: w for w, i in w2i.items()}


def _tiny_pipeline(batch_size=4, **kw):
    w2i, i2w = _vocab()
    cap = build_captioner("base-soft", len(w2i), resnet_layers=LAYERS,
                          device="cpu")
    cap.init(torch.Generator().manual_seed(0))
    return CaptionPipeline(cap, w2i, i2w, batch_size=batch_size, **kw)


def _png_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _jpeg_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd.server_address[1]


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()
    httpd.service.stop()


@pytest.fixture()
def server():
    pipe = _tiny_pipeline(batch_size=4)
    # a generous window: the posting threads' decodes must all land inside
    # one window on a loaded test machine
    httpd = serve(pipe, host="127.0.0.1", port=0, batch_window_ms=250.0)
    _start(httpd)
    yield httpd, pipe
    _stop(httpd)


def _post(port: int, payload: bytes, path="/caption") -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=payload, method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=TIMEOUT) as r:
        return json.loads(r.read())


def test_caption_endpoint_and_microbatching(server):
    httpd, pipe = server
    port = httpd.server_address[1]
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, (3, 224, 224, 3), dtype=np.uint8)
    bodies = [_png_bytes(imgs[0]), _jpeg_bytes(imgs[1]),
              _png_bytes(imgs[2][:100, :150])]     # off-size: resized

    # concurrent posts land in one micro-batch (window 250 ms, cap 4)
    results = [None] * 3

    def worker(i):
        results[i] = _post(port, bodies[i])
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert all("caption" in r for r in results)

    # server captions == pipeline captions on the same decoded bytes
    expect = pipe([decode_image_bytes(b, pipe.image_hw) for b in bodies])
    assert [r["caption"] for r in results] == expect

    svc = httpd.service
    assert svc.images_served >= 3
    assert svc.batches_run <= 2  # micro-batching batched

    health = _get(port, "/healthz")
    assert health["ok"] and health["images_served"] >= 3

    m = _get(port, "/metrics")
    assert m["images_served"] == svc.images_served
    assert sum(m["batch_size_hist"].values()) == m["batches_run"]
    assert sum(int(k) * v for k, v in m["batch_size_hist"].items()) \
        == m["images_served"]
    lat = m["request_latency"]
    assert lat["n"] >= 3 and 0 < lat["p50_ms"] <= lat["p99_ms"]
    dev = m["device_batch"]
    assert dev["n"] == m["batches_run"] and dev["p50_ms"] > 0
    assert m["queue_depth"] == 0


class FakeHTTPD:
    def serve_forever(self):
        raise KeyboardInterrupt  # main() returns at once
    service = type("S", (), {"stop": staticmethod(lambda: None)})()

    def server_close(self):
        pass


def _fake_main(monkeypatch, argv):
    """serve.main(argv) with from_experiment and serve faked: the keyword
    arguments from_experiment got, and main's return code."""
    seen = {}

    def fake_from_experiment(kind, use_data, **kw):
        seen.update(kind=kind, use_data=use_data, **kw)
        return object()

    monkeypatch.setattr(
        "depth_image_captioning_pub_torch.pipeline.CaptionPipeline."
        "from_experiment", staticmethod(fake_from_experiment))
    monkeypatch.setattr(serve_mod, "serve", lambda *a, **k: FakeHTTPD())
    return seen, serve_mod.main(argv)


def test_main_threads_sampling_flags(monkeypatch):
    seen, rc = _fake_main(monkeypatch, [
        "--kind", "base-soft", "--sample", "--temperature", "1.5",
        "--top-k", "7", "--top-p", "0.9", "--seed", "11",
        "--batch-buckets", "1,4", "--devices", "1", "--beam", "3",
        "--batch-size", "8", "--set-idx", "2"])
    assert rc == 0
    assert seen["sample"] is True and seen["temperature"] == 1.5
    assert seen["top_k"] == 7 and seen["top_p"] == 0.9 and seen["seed"] == 11
    assert seen["batch_buckets"] == [1, 4] and seen["batch_size"] == 8
    assert seen["beam_size"] == 3 and seen["set_idx"] == 2
    assert seen["device"] == "cuda"      # the card unless asked otherwise
    cfg = seen["cfg"]                    # the DPT flags' defaults
    assert (cfg.dpt_image_size, cfg.dpt_gelu, cfg.dpt_head) == (
        384, "erf", "full")


def test_main_devices_above_one_raises(monkeypatch):
    """``--devices N`` above 1 takes the first N cards and raises when
    fewer are visible, or with ``--export-dir``; on the CPU it takes N
    replicas there."""
    import torch
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 CUDA devices"):
        _fake_main(monkeypatch, ["--devices", "2"])
    with pytest.raises(ValueError, match="one device"):
        _fake_main(monkeypatch, ["--devices", "2", "--export-dir", "x"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    seen, rc = _fake_main(monkeypatch, ["--devices", "3"])
    assert rc == 0 and seen["devices"] == ["cuda:0", "cuda:1", "cuda:2"]
    seen, rc = _fake_main(monkeypatch, ["--devices", "2", "--device",
                                        "cpu"])
    assert rc == 0 and seen["devices"] == ["cpu", "cpu"]
    seen, rc = _fake_main(monkeypatch, ["--devices", "1"])
    assert rc == 0 and seen["devices"] is None


def test_main_export_dir(monkeypatch, capsys):
    """``--export-dir`` serves the artifact (``ExportedPipeline.load`` on
    the card unless asked otherwise, seeded by ``--seed``), not the
    experiment's files."""
    loaded = {}

    def fake_load(export_dir, device=None, seed=0):
        loaded.update(export_dir=export_dir, device=device, seed=seed)
        return object()

    monkeypatch.setattr(
        "depth_image_captioning_pub_torch.export.ExportedPipeline.load",
        staticmethod(fake_load))
    seen, rc = _fake_main(monkeypatch, ["--export-dir", "art", "--seed", "5"])
    assert rc == 0 and seen == {}
    assert loaded == {"export_dir": "art", "device": "cuda", "seed": 5}
    assert "serving export art" in capsys.readouterr().out


def test_main_threads_gelu_flag(monkeypatch):
    seen, rc = _fake_main(monkeypatch, ["--kind", "depth-soft", "--gelu",
                                        "tanh", "--device", "cpu"])
    assert rc == 0 and seen["device"] == "cpu"
    assert seen["cfg"] is not None and seen["cfg"].dpt_gelu == "tanh"


def test_main_threads_dpt_head_flag(monkeypatch):
    seen, rc = _fake_main(monkeypatch, ["--kind", "depth-soft", "--dpt-head",
                                        "lowres"])
    assert rc == 0
    assert seen["cfg"].dpt_head == "lowres"
    assert seen["cfg"].dpt_gelu == "erf"


def _raw_request(port: int, head: bytes, body: bytes = b"") -> bytes:
    """Send one request on a fresh socket and read until the server closes
    it; a connection left open times out instead."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(head + body)
        chunks = []
        while True:
            try:
                data = s.recv(65536)
            except socket.timeout:
                raise AssertionError("the server kept the connection open "
                                     "after a refusal") from None
            if not data:
                return b"".join(chunks)
            chunks.append(data)


def test_oversized_post_rejected_413(server, monkeypatch):
    """A POST whose Content-Length exceeds MAX_REQUEST_BYTES is refused
    before its body is read, and its connection is closed."""
    httpd, _ = server
    port = httpd.server_address[1]
    monkeypatch.setattr(serve_mod, "MAX_REQUEST_BYTES", 1024)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, b"x" * 4096)
    assert e.value.code == 413
    assert "exceeds limit" in json.loads(e.value.read())["error"]
    # normal-sized requests still work once the limit is back
    monkeypatch.setattr(serve_mod, "MAX_REQUEST_BYTES", 32 * 1024 * 1024)
    img = np.random.default_rng(2).integers(0, 255, (224, 224, 3),
                                            dtype=np.uint8)
    assert "caption" in _post(port, _png_bytes(img))


def test_413_closes_the_connection(server, monkeypatch):
    """Keep-alive is asked for and the body follows the headers: the 413
    says ``Connection: close`` and the server closes the socket, so the
    unread body is never parsed as a next request."""
    httpd, _ = server
    port = httpd.server_address[1]
    monkeypatch.setattr(serve_mod, "MAX_REQUEST_BYTES", 1024)
    body = b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n" * 200
    reply = _raw_request(port, (
        f"POST /caption HTTP/1.1\r\nHost: x\r\nConnection: keep-alive\r\n"
        f"Content-Length: {len(body)}\r\n\r\n").encode(), body)
    assert reply.startswith(b"HTTP/1.1 413")
    assert b"Connection: close" in reply
    assert reply.count(b"HTTP/1.1") == 1   # the body was not served
    for head, code in ((b"GET /nope HTTP/1.1\r\nHost: x\r\n\r\n", b"404"),
                       (b"POST /nope HTTP/1.1\r\nHost: x\r\n"
                        b"Content-Length: 3\r\n\r\nabc", b"404"),
                       (b"POST /caption HTTP/1.1\r\nHost: x\r\n"
                        b"Content-Length: 3\r\n\r\nabc", b"400")):
        reply = _raw_request(port, head)
        assert reply.startswith(b"HTTP/1.1 " + code)
        assert b"Connection: close" in reply


def _png_header_only(w: int, h: int, stream: bytes) -> bytes:
    """A PNG stating w x h RGB over ``stream`` as its image data."""
    import zlib

    def chunk(tag, body):
        return (len(body).to_bytes(4, "big") + tag + body
                + zlib.crc32(tag + body).to_bytes(4, "big"))
    header = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
              + bytes([8, 2, 0, 0, 0]))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", stream) + chunk(b"IEND", b""))


def test_bombs_and_bad_lengths_get_400(server):
    """Decompression bombs (a header past Pillow's pixel limit over a few
    kB of deflate, a one-row image 2**30 pixels wide) and a negative or
    unreadable Content-Length each get a 400 that closes the connection;
    a stream longer than its header's image is captioned, and the server
    answers on."""
    import zlib
    httpd, pipe = server
    port = httpd.server_address[1]
    zeros = zlib.compress(b"\x00" * (1 << 22), 9)
    for body in (_png_header_only(20000, 20000, zeros),
                 _png_header_only(2 ** 30, 1, zeros)):
        reply = _raw_request(port, (
            f"POST /caption HTTP/1.1\r\nHost: x\r\nContent-Length: "
            f"{len(body)}\r\n\r\n").encode(), body)
        assert reply.startswith(b"HTTP/1.1 400"), reply[:80]
        assert b"decompression bomb" in reply
    for path in ("/caption", "/reload"):
        for declared in (b"-1", b"-5000", b"lots"):
            reply = _raw_request(port, b"POST " + path.encode()
                                 + b" HTTP/1.1\r\nHost: x\r\n"
                                 b"Content-Length: " + declared
                                 + b"\r\n\r\nabc")
            assert reply.startswith(b"HTTP/1.1 400"), reply[:80]
            assert b"Connection: close" in reply
            assert b"bad Content-Length" in reply
    img = np.random.default_rng(5).integers(0, 255, (16, 16, 3),
                                            dtype=np.uint8)
    rows = b"".join(b"\x00" + r.tobytes() for r in img.reshape(16, 48))
    long_stream = zlib.compress(rows + b"\x00" * (1 << 24), 9)
    got = _post(port, _png_header_only(16, 16, long_stream))["caption"]
    assert got == pipe(img)
    assert _get(port, "/healthz")["ok"]


class StubPipeline:
    batch_size = 4
    image_hw = (4, 4)
    id_to_word = {0: "ok", 1: "<end>"}
    delay = 0.0
    reload_delay = 0.0
    reload_calls = 0

    def caption_tokens(self, arrays):
        time.sleep(self.delay)
        return np.zeros((arrays.shape[0], 3), np.int32)

    def reload_from_experiment(self):
        time.sleep(self.reload_delay)
        type(self).reload_calls += 1


def _stub(**kw):
    return type("Stub", (StubPipeline,), dict(kw, reload_calls=0))()


def test_stop_drains_in_flight_jobs():
    """stop(): jobs already queued are captioned before the worker exits,
    even when the shutdown sentinel lands in their batch."""
    svc = CaptionService(_stub(batch_size=8, delay=0.05),
                         batch_window_ms=100.0)
    jobs = [_Job(np.zeros((4, 4, 3), np.uint8)) for _ in range(3)]
    for j in jobs:
        svc.queue.put(j)
    svc.stop()                      # sentinel queued behind the jobs
    for j in jobs:
        assert j.event.wait(5.0)
        assert j.error is None and j.caption is not None
    svc.worker.join(timeout=5.0)
    assert not svc.worker.is_alive()


def test_stop_drains_backlog_beyond_one_batch():
    """Jobs queued past the batch cap at stop() time are captioned too."""
    svc = CaptionService(_stub(delay=0.02), batch_window_ms=5.0)
    jobs = [_Job(np.zeros((4, 4, 3), np.uint8)) for _ in range(11)]
    for j in jobs:
        svc.queue.put(j)            # 11 jobs = 3 batches at cap 4
    svc.stop()
    for j in jobs:
        assert j.event.wait(5.0)
        assert j.error is None and j.caption is not None
    svc.worker.join(timeout=5.0)
    assert not svc.worker.is_alive()


def test_reload_timeout_cancels_queued_job():
    """A reload that times out while still queued is cancelled: the worker
    skips it and the error says no swap will occur."""
    stub = _stub(delay=0.6)         # keeps the worker busy past the timeout
    svc = CaptionService(stub, batch_window_ms=5.0)
    try:
        j = _Job(np.zeros((4, 4, 3), np.uint8))
        svc.queue.put(j)
        time.sleep(0.15)            # the worker starts the batch
        with pytest.raises(TimeoutError, match="no weight swap"):
            svc.reload(timeout=0.05)
        assert j.event.wait(5.0)
        time.sleep(0.3)             # the worker drains the cancelled job
        assert svc.reloads_done == 0
        assert type(stub).reload_calls == 0
    finally:
        svc.stop()


def test_reload_timeout_midswap_says_so():
    """A reload that times out while running cannot be cancelled: the
    error says the swap may still land, and it lands."""
    svc = CaptionService(_stub(reload_delay=0.4), batch_window_ms=5.0)
    try:
        with pytest.raises(TimeoutError, match="may still land"):
            svc.reload(timeout=0.05)    # claimed at once by the idle worker
        deadline = time.monotonic() + 5.0
        while svc.reloads_done == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert svc.reloads_done == 1
    finally:
        svc.stop()


def test_reload_with_body_keeps_keepalive_in_sync(server):
    """POST /reload with a body on a keep-alive connection: the body is
    drained before the reply, so the next request on the socket parses."""
    httpd, _ = server
    port = httpd.server_address[1]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/reload", body=b"x" * 4096,
                     headers={"Content-Type": "application/octet-stream"})
        r1 = conn.getresponse()
        body1 = r1.read()
        # the tiny pipeline has no experiment: 500, on a kept connection
        assert r1.status == 500
        json.loads(body1)
        conn.request("GET", "/healthz")
        r2 = conn.getresponse()
        assert r2.status == 200
        assert json.loads(r2.read())["ok"] is True
    finally:
        conn.close()


def test_bad_requests(server):
    httpd, _ = server
    port = httpd.server_address[1]
    req = urllib.request.Request(f"http://127.0.0.1:{port}/caption",
                                 data=b"not an image", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e2:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
    assert e2.value.code == 404


def test_run_forever_drain_order():
    """Shutdown joins the in-flight handler threads (server_close) before
    it stops the caption worker."""
    order = []

    class StubService:
        def stop(self):
            order.append("stop")

    class StubHTTPD:
        service = StubService()

        def serve_forever(self):
            order.append("serve")
            raise KeyboardInterrupt

        def server_close(self):
            order.append("close")

    assert _run_forever(StubHTTPD()) == 0
    assert order == ["serve", "close", "stop"]


def test_submit_after_stop_refused():
    svc = CaptionService(_stub(batch_size=2), batch_window_ms=1.0)
    svc.stop()
    with pytest.raises(RuntimeError, match="shutting down"):
        svc.submit(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(RuntimeError, match="shutting down"):
        svc.reload()


def test_reload_endpoint(server, monkeypatch):
    """POST /reload: 500 with the error where the pipeline cannot reload,
    200 and the counter once it can; serving goes on after the swap."""
    httpd, pipe = server
    port = httpd.server_address[1]

    def post_reload():
        try:
            return 200, _post(port, b"", "/reload")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    code, body = post_reload()           # not built by from_experiment
    assert code == 500 and "from_experiment" in body["error"]

    calls = []
    monkeypatch.setattr(pipe, "reload_from_experiment",
                        lambda: calls.append(1))
    code, body = post_reload()
    assert code == 200 and body["reloaded"] is True
    assert body["reloads_done"] == 1 and calls == [1]
    img = np.random.default_rng(1).integers(0, 255, (224, 224, 3),
                                            dtype=np.uint8)
    assert "caption" in _post(port, _png_bytes(img))
    assert _get(port, "/metrics")["reloads_done"] == 1


# ---- parity with the JAX server ---------------------------------------------

def _scale_kernels(tree, factor):
    """Random conv inits shrink activations layer by layer, which would
    give every image one caption; scaled kernels keep them apart."""
    return {k: (_scale_kernels(v, factor) if isinstance(v, dict)
                else np.asarray(v) * (factor if k == "kernel" else 1.0))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def bridged():
    """One set of f32 base-soft weights as a JAX pipeline and the port's
    (buckets of 4), the <end> bias raised so some captions end early."""
    w2i, i2w = _vocab()
    jcap = jcaptioner.build_captioner("base-soft", len(w2i), JConfigEval(),
                                      encoder_dtype=jnp.float32,
                                      resnet_layers=LAYERS)
    params, frozen, stats = jax.tree_util.tree_map(
        np.array, jcap.init(jax.random.PRNGKey(3)))
    params = dict(params)
    params["decoder"] = dict(params["decoder"])
    params["decoder"]["out_b"] = params["decoder"]["out_b"].copy()
    params["decoder"]["out_b"][w2i["<end>"]] += 0.5
    enc = _scale_kernels(frozen["encoder"], 3.0)
    jpipe = JCaptionPipeline(jcap, params, {"encoder": enc}, stats, w2i, i2w,
                             batch_size=4, devices=jax.devices()[:1])
    tcap = build_captioner("base-soft", len(w2i), encoder_dtype=torch.float32,
                           resnet_layers=LAYERS, device="cpu")
    params_from_jax(tcap, params, {"encoder": enc}, stats)
    return jpipe, CaptionPipeline(tcap, w2i, i2w, batch_size=4)


def test_port_server_answers_as_the_jax_server(bridged):
    jpipe, tpipe = bridged
    rng = np.random.default_rng(7)
    bodies = []
    for i in range(6):
        arr = np.asarray(Image.fromarray(rng.integers(
            0, 255, (24, 32, 3), dtype=np.uint8)).resize((320, 240)))
        bodies.append(_png_bytes(arr) if i % 2 else _jpeg_bytes(arr))
    caps = {}
    for name, make, pipe in (("jax", jserve, jpipe), ("port", serve, tpipe)):
        httpd = make(pipe, host="127.0.0.1", port=0, batch_window_ms=1.0)
        try:
            port = _start(httpd)
            caps[name] = [_post(port, b)["caption"] for b in bodies]
        finally:
            _stop(httpd)
    assert caps["port"] == caps["jax"]
    assert len(set(caps["port"])) > 1          # the images differ


def test_pipeline_inputs_equal_jax(bridged, tmp_path):
    """CaptionPipeline over paths (JPEG and PNG files), float arrays in
    [0, 1] and [0, 255], and arrays of other sizes: the port's tokens are
    the JAX pipeline's, integer for integer; a single path gives a single
    caption."""
    jpipe, tpipe = bridged
    rng = np.random.default_rng(11)
    photos = [np.asarray(Image.fromarray(rng.integers(
        0, 255, (24, 32, 3), dtype=np.uint8)).resize((200 + 7 * i, 150)))
        for i in range(4)]
    paths = []
    for i, arr in enumerate(photos):
        path = str(tmp_path / f"img{i}.{'png' if i % 2 else 'jpg'}")
        Image.fromarray(arr).save(path)
        paths.append(path)
    batch = paths + [
        photos[0].astype(np.float32) / 255.0,               # [0, 1], off-size
        photos[1][:100, :90].astype(np.float64),            # [0, 255]
        np.asarray(Image.fromarray(photos[2]).resize((224, 224))),
        np.asarray(Image.fromarray(photos[3]).resize((224, 224)))
        .astype(np.float32) / 255.0,                        # [0, 1], 224
        rng.integers(0, 255, (37, 301, 3), dtype=np.uint8),
    ]
    want = jpipe.caption_tokens(jpipe._to_arrays(batch))
    got = tpipe.caption_tokens(tpipe._to_arrays(batch))
    np.testing.assert_array_equal(got, want)
    assert tpipe(batch) == jpipe(batch)
    assert tpipe(paths[1]) == jpipe(paths[1]) == tpipe(batch)[1]
    assert len({tuple(r) for r in got.tolist()}) > 1


# ---- /reload over an experiment's files, and sampling ---------------------

@pytest.fixture
def experiment(tmp_path, monkeypatch):
    """A working directory with a vocabulary and base-soft set 1 written
    by the port in the JAX trainer's files; (cfg, save_dir, files,
    captioner)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DCAP_RESNET_LAYERS", "1,1,1,1")
    w2i, _ = _vocab()
    vocab = tmp_path / "dataset" / "coco2014"
    vocab.mkdir(parents=True)
    with open(vocab / "word_to_id.pkl", "wb") as f:
        pickle.dump(w2i, f)
    cfg = ConfigEval()
    save_dir, files = cli.eval_tables(cfg, "soft", False, False)
    cap = build_captioner("base-soft", len(w2i), resnet_layers=LAYERS,
                          device="cpu")
    cap.init(torch.Generator().manual_seed(5))
    with torch.no_grad():
        for name, p in cap.encoder.named_parameters():
            if p.dim() == 4:
                p.mul_(3.0)
    trainable, frozen, _ = params_to_jax(cap)
    save_component(f"{save_dir}/{files[1][0]}", frozen["encoder"])
    save_component(f"{save_dir}/{files[1][1]}", trainable["decoder"])
    return cfg, save_dir, files, cap


def test_reload_lands_the_new_files(experiment):
    cfg, save_dir, files, cap = experiment
    pipe = CaptionPipeline.from_experiment("base-soft", cfg=cfg,
                                           device="cpu", batch_size=4)
    rng = np.random.default_rng(8)
    bodies = [_png_bytes(rng.integers(0, 255, (224, 224, 3),
                                      dtype=np.uint8)) for _ in range(4)]
    httpd = serve(pipe, port=0, batch_window_ms=1.0)
    try:
        port = _start(httpd)
        before = [_post(port, b)["caption"] for b in bodies]
        cap.decoder.reset_parameters(torch.Generator().manual_seed(6))
        trainable, _, _ = params_to_jax(cap)
        save_component(f"{save_dir}/{files[1][1]}", trainable["decoder"])
        assert _post(port, b"", "/reload")["reloads_done"] == 1
        after = [_post(port, b)["caption"] for b in bodies]
    finally:
        _stop(httpd)
    fresh = CaptionPipeline.from_experiment("base-soft", cfg=cfg,
                                            device="cpu", batch_size=4)
    arrays = [decode_image_bytes(b, (224, 224)) for b in bodies]
    assert after == fresh(arrays)
    assert after != before


def test_sampled_requests_repeat_per_seed():
    """--sample: one generator draw per device call, so sequential
    requests to two servers with one seed get the same captions."""
    rng = np.random.default_rng(9)
    bodies = [_png_bytes(rng.integers(0, 255, (224, 224, 3),
                                      dtype=np.uint8)) for _ in range(3)]
    runs = []
    for _ in range(2):
        pipe = _tiny_pipeline(batch_size=2, sample=True, seed=4,
                              max_length=6)
        httpd = serve(pipe, port=0, batch_window_ms=1.0)
        try:
            port = _start(httpd)
            runs.append([_post(port, b)["caption"] for b in bodies * 2])
        finally:
            _stop(httpd)
    assert runs[0] == runs[1]
