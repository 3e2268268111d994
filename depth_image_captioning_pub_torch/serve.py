"""Caption server over ``CaptionPipeline`` (the port's counterpart of the
JAX ``serve.py``), on the standard library's ``http.server``.

* Requests are micro-batched: concurrent ``POST /caption`` bodies landing
  within ``batch_window_ms`` are captioned in one device call, up to the
  pipeline's largest bucket, and each chunk is padded to the smallest
  bucket that fits (``--batch-buckets``, default one bucket of
  ``--batch-size``).
* One worker thread owns the card. The decode kernels are cooperative
  launches that take every SM, so nothing else may use the card while a
  server is up: the handler threads only decode the request bytes on the
  host (``data/image_io.decode_image_bytes``: PNG and JPEG without Pillow,
  the JAX server's Pillow bytes) and wait for the worker.
* ``GET /metrics``: rolling-window request latency and device-call
  percentiles (p50/p90/p99/mean), the micro-batch size histogram, counters
  and queue depth; ``GET /healthz``: a cheap liveness probe.
* ``POST /reload`` re-reads the experiment's checkpoint files and swaps
  the weights on the worker thread between device calls.
* SIGTERM drains: the server stops accepting, the in-flight requests are
  answered, the process exits 0.
* Unlike the JAX server, every refusal (404, 400, 413) closes the
  connection: a refused request's body may be unread, and on a keep-alive
  connection its bytes would be read as the next request.
* With ``--sample`` the pipeline's ``torch.Generator`` advances once per
  device call: sequential requests are reproducible for a seed, concurrent
  ones are not (their grouping into batches varies), as in the JAX server.

Run (on the CUDA card; ``--device cpu`` runs the kernels' plain versions):

    python -m depth_image_captioning_pub_torch.serve --kind base-soft \\
        [--port 8000] [--beam 5] [--batch-size 16] [--batch-buckets 1,4,16]
    curl -s --data-binary @dog.png localhost:8000/caption

``--export-dir DIR`` serves the artifact that
``depth_image_captioning_pub_torch.export`` wrote to DIR instead of the
``exp_result/`` files (its decode settings are baked in; the model flags
are ignored; ``--device`` and ``--seed`` apply; ``POST /reload`` has no
files to re-read and answers with an error).

``--devices N`` (N > 1) serves over the first N visible cards, as the
JAX server's ``--devices`` takes the first N chips: the pipeline keeps a
replica on each and splits every device call's chunk over them
(``CaptionPipeline(devices=...)``; the buckets round up to multiples of
N). With ``--device cpu`` it takes N replicas on the CPU. 0 and 1 serve
on ``--device`` alone; an export is served on one device.
"""

from __future__ import annotations

import argparse
import collections
import json
import queue
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from depth_image_captioning_pub_torch import cli
from depth_image_captioning_pub_torch.data.image_io import decode_image_bytes
from depth_image_captioning_pub_torch.data.tokenizer import ids_to_caption



def serving_devices(device: str, n: int) -> List[str]:
    """The first ``n`` visible cards for a CUDA ``device`` (ValueError if
    fewer are visible), or ``n`` times ``device`` otherwise."""
    import torch
    if torch.device(device).type != "cuda":
        return [device] * n
    count = torch.cuda.device_count()
    if n > count:
        raise ValueError(f"--devices {n}: only {count} CUDA devices are "
                         f"visible")
    return [f"cuda:{i}" for i in range(n)]


class _Job:
    __slots__ = ("array", "event", "caption", "error")

    def __init__(self, array: np.ndarray):
        self.array = array
        self.event = threading.Event()
        self.caption: Optional[str] = None
        self.error: Optional[str] = None


class _ReloadJob:
    """Control job (POST /reload): run by the worker between caption
    batches, so the weight swap never races a device call.

    A timed-out caller cancels the job: the worker claims a job before it
    runs it, the caller's timeout cancels it if it is still pending, and
    exactly one side wins, so a TimeoutError means either "no swap will
    happen" (cancelled) or "the swap is running and may still land"
    (claimed), and its message says which."""
    __slots__ = ("event", "error", "_lock", "_state")

    def __init__(self):
        self.event = threading.Event()
        self.error: Optional[str] = None
        self._lock = threading.Lock()
        self._state = "pending"    # -> "running" (worker) | "cancelled"

    def try_claim(self) -> bool:
        with self._lock:
            if self._state == "pending":
                self._state = "running"
                return True
            return False

    def try_cancel(self) -> bool:
        with self._lock:
            if self._state == "pending":
                self._state = "cancelled"
                return True
            return False


class CaptionService:
    """Micro-batching worker around a ``CaptionPipeline``.

    ``submit`` blocks until the worker has captioned the image; the worker
    drains the queue up to ``pipeline.batch_size`` jobs at a time, waiting
    at most ``batch_window_ms`` for stragglers once the first job arrives.
    """

    def __init__(self, pipeline, batch_window_ms: float = 2.0,
                 metrics_window: int = 4096):
        self.pipeline = pipeline
        self.batch_window = batch_window_ms / 1000.0
        self.queue: "queue.Queue[_Job]" = queue.Queue()
        self._stop = threading.Event()
        self.batches_run = 0
        self.images_served = 0
        self.reloads_done = 0
        # rolling windows for GET /metrics: deque.append is atomic under
        # the GIL; readers take a list() before computing percentiles
        self._req_ms = collections.deque(maxlen=metrics_window)
        self._batch_ms = collections.deque(maxlen=metrics_window)
        self._batch_hist: dict = {}
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.worker.start()

    def _drain(self) -> List[_Job]:
        jobs = [self.queue.get()]
        t_end = time.monotonic() + self.batch_window
        while len(jobs) < self.pipeline.batch_size:
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                break
            try:
                jobs.append(self.queue.get(timeout=remaining))
            except queue.Empty:
                break
        return jobs

    def _run(self):
        # The worker ends only on the sentinel, which stop() queues behind
        # the real jobs: every request queued before stop() is answered.
        while True:
            jobs = self._drain()
            if any(j is _SENTINEL for j in jobs):
                jobs = [j for j in jobs if j is not _SENTINEL]
                if not jobs:
                    return
                # caption the jobs drained with it, then exit once the
                # queue is empty
                self.queue.put(_SENTINEL)
            # reloads first, between device calls (the jobs drained with
            # them get the new weights)
            reloads = [j for j in jobs if isinstance(j, _ReloadJob)]
            jobs = [j for j in jobs if not isinstance(j, _ReloadJob)]
            for r in reloads:
                if not r.try_claim():    # the caller timed out and cancelled
                    r.event.set()
                    continue
                try:
                    self.pipeline.reload_from_experiment()
                    self.reloads_done += 1
                except Exception as e:
                    r.error = str(e)
                r.event.set()
            if not jobs:
                continue
            try:
                t0 = time.monotonic()
                toks = self.pipeline.caption_tokens(
                    np.stack([j.array for j in jobs]))
                for j, row in zip(jobs, toks):
                    j.caption = ids_to_caption(row, self.pipeline.id_to_word)
                self._batch_ms.append((time.monotonic() - t0) * 1e3)
            except Exception as e:
                for j in jobs:
                    j.error = str(e)
            self.batches_run += 1
            self.images_served += len(jobs)
            n = len(jobs)
            self._batch_hist[n] = self._batch_hist.get(n, 0) + 1
            for j in jobs:
                j.event.set()

    def submit(self, array: np.ndarray, timeout: float = 60.0) -> str:
        if self._stop.is_set():
            # a job queued behind the sentinel would hold the worker past
            # its drain
            raise RuntimeError("caption service is shutting down")
        t0 = time.monotonic()
        job = _Job(array)
        self.queue.put(job)
        if not job.event.wait(timeout):
            raise TimeoutError("caption worker timed out")
        if job.error:
            raise RuntimeError(job.error)
        self._req_ms.append((time.monotonic() - t0) * 1e3)
        return job.caption

    def reload(self, timeout: float = 120.0) -> None:
        """Swap in the weights of the experiment's checkpoint files
        (``pipeline.reload_from_experiment``) on the worker thread, between
        device calls. Blocks until the swap happened; raises what the
        reload raised."""
        if self._stop.is_set():
            raise RuntimeError("caption service is shutting down")
        job = _ReloadJob()
        self.queue.put(job)
        if not job.event.wait(timeout):
            if job.try_cancel():
                raise TimeoutError(
                    "reload timed out while queued; cancelled — "
                    "no weight swap will occur")
            raise TimeoutError(
                "reload timed out mid-swap; the new weights may still "
                "land (check /metrics reloads_done)")
        if job.error:
            raise RuntimeError(job.error)

    def metrics(self) -> dict:
        """GET /metrics: request latency and device-call percentiles over
        the last ``metrics_window`` entries, the batch-size histogram,
        counters and the queue depth."""
        def pct(window):
            snap = sorted(window)
            if not snap:
                return None

            def q(p):
                return snap[min(len(snap) - 1, int(p * (len(snap) - 1) + 0.5))]
            return {"p50_ms": round(q(0.50), 3), "p90_ms": round(q(0.90), 3),
                    "p99_ms": round(q(0.99), 3),
                    "mean_ms": round(sum(snap) / len(snap), 3),
                    "n": len(snap)}

        return {"images_served": self.images_served,
                "batches_run": self.batches_run,
                "reloads_done": self.reloads_done,
                "queue_depth": self.queue.qsize(),
                "batch_size_hist": {str(k): v for k, v in
                                    sorted(self._batch_hist.items())},
                "request_latency": pct(list(self._req_ms)),
                "device_batch": pct(list(self._batch_ms))}

    def stop(self):
        self._stop.set()
        self.queue.put(_SENTINEL)
        # a backlog drains at one device call per batch_size jobs
        self.worker.join(timeout=60)


_SENTINEL = _Job(np.zeros((1, 1, 3), np.uint8))

# 32 MB fits any camera JPEG or PNG; a deployment can change it.
MAX_REQUEST_BYTES = 32 * 1024 * 1024


def make_handler(service: CaptionService):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: every reply carries Content-Length, and a
        # request whose body is not read closes the connection
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if code in (400, 404, 413):
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(body)

        def _length(self) -> Optional[int]:
            """The body's length, or None after a 400 or a 413."""
            declared = self.headers.get("Content-Length", "0")
            try:
                n = int(declared)
            except ValueError:
                n = -1
            if n < 0:
                # rfile.read(-1) would read until the client closes, past
                # the limit below
                self._reply(400, {"error": f"bad Content-Length "
                                           f"{declared!r}"})
                return None
            if n > MAX_REQUEST_BYTES:
                # refused before reading: an unbounded read would let one
                # oversized POST exhaust host memory
                self._reply(413, {"error": f"payload {n} bytes exceeds "
                                           f"limit {MAX_REQUEST_BYTES}"})
                return None
            return n

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True,
                                  "images_served": service.images_served,
                                  "batches_run": service.batches_run})
            elif self.path == "/metrics":
                self._reply(200, service.metrics())
            else:
                self._reply(404, {"error": "GET /healthz, GET /metrics or "
                                           "POST /caption"})

        def do_POST(self):
            if self.path == "/reload":
                try:
                    n = self._length()
                    if n is None:
                        return
                    if n:    # drained, so the connection stays in step
                        self.rfile.read(n)
                    service.reload()
                    self._reply(200, {"reloaded": True,
                                      "reloads_done": service.reloads_done})
                except Exception as e:
                    self._reply(500, {"error": str(e)})
                return
            if self.path != "/caption":
                self._reply(404, {"error": "POST /caption or POST /reload"})
                return
            try:
                n = self._length()
                if n is None:
                    return
                arr = decode_image_bytes(self.rfile.read(n),
                                         service.pipeline.image_hw)
                self._reply(200, {"caption": service.submit(arr)})
            except Exception as e:
                self._reply(400, {"error": str(e)})

    return Handler


def serve(pipeline, host: str = "127.0.0.1", port: int = 8000,
          batch_window_ms: float = 2.0) -> ThreadingHTTPServer:
    """Start (and return) the server; the caller runs serve_forever()."""
    service = CaptionService(pipeline, batch_window_ms)
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    httpd.service = service
    return httpd


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--kind", default="base-soft")
    p.add_argument("--use-data", default="coco")
    p.add_argument("--set-idx", type=int, default=1)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--beam", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--batch-buckets", default=None,
                   help="comma list, e.g. 1,4,16 (overrides --batch-size)")
    p.add_argument("--batch-window-ms", type=float, default=2.0)
    p.add_argument("--sample", action="store_true",
                   help="stochastic decoding instead of greedy")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    p.add_argument("--devices", type=int, default=0,
                   help="serve on the first N cards (0 or 1: --device "
                        "alone)")
    cli.add_dpt_flags(p)
    p.add_argument("--export-dir", default=None,
                   help="serve an export.py artifact instead of exp_result/ "
                        "checkpoints (decode settings are baked into the "
                        "artifact; model flags are ignored)")
    return p


def main(argv=None) -> int:
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    args = build_parser().parse_args(argv)
    devices = None
    if args.devices > 1:
        if args.export_dir:
            raise ValueError("--export-dir serves on one device; drop "
                             "--devices")
        devices = serving_devices(args.device, args.devices)
    if args.export_dir:
        from depth_image_captioning_pub_torch.export import ExportedPipeline
        pipe = ExportedPipeline.load(args.export_dir, device=args.device,
                                     seed=args.seed)
        httpd = serve(pipe, args.host, args.port, args.batch_window_ms)
        print(f"serving export {args.export_dir} on "
              f"http://{args.host}:{args.port}", flush=True)
        return _run_forever(httpd)
    buckets = ([int(b) for b in args.batch_buckets.split(",")]
               if args.batch_buckets else None)
    pipe = CaptionPipeline.from_experiment(
        args.kind, args.use_data, cfg=cli.dpt_cfg(args), set_idx=args.set_idx,
        device=args.device, beam_size=args.beam, batch_size=args.batch_size,
        batch_buckets=buckets, sample=args.sample,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        seed=args.seed, devices=devices)
    httpd = serve(pipe, args.host, args.port, args.batch_window_ms)
    print(f"serving {args.kind} on http://{args.host}:{args.port}"
          + (f" over {len(devices)} devices" if devices else ""),
          flush=True)
    return _run_forever(httpd)


def _run_forever(httpd) -> int:
    # SIGTERM: stop accepting, answer the in-flight requests, exit 0.
    # shutdown() must run off the serve_forever thread (it waits for the
    # loop to end).
    def _graceful(signum, frame):
        print("SIGTERM: draining in-flight requests, shutting down",
              flush=True)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    # server_close() joins the in-flight handler threads while the worker
    # still captions their jobs; stopping the worker first would strand
    # them
    httpd.server_close()
    httpd.service.stop()
    print("serve: clean exit", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
