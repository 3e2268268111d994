"""Traffic of kind ``closed_loop``: one client captions requests of seeded
images back to back through the program's ``CaptionPipeline.
caption_tokens``, each call waiting for the one before it.

Parameters (the traffic file): ``images_per_request``, ``batch_buckets``
(the pipeline's), ``distinct_requests`` (the seeded requests cycled
through, each captioned once in set-up), ``trace_seconds`` (the traced
window's length). On the card the requests' images sit in page-locked
host memory, as a loader's pinned batches do. The check
compares two requests: one drawn from the seed among the first
``distinct_requests``, and the last one completed.

A forward hook on the RGB encoder, and a pre- and post-hook on the depth
CNN, keep references to what the timed path produced (the features, the
depth maps it read, its features) for the requests compared; the check
reads them once the window has closed.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from counts import models as counts
from dcbench import judge, program
from dcbench.trace import Trace


class Capture:
    """References to the tensors each request's chunks produced."""

    def __init__(self, cap):
        self.cur: Dict[str, List[torch.Tensor]] = {"feats": [], "maps": [],
                                                   "dep": []}
        self.handles = [cap.encoder.register_forward_hook(
            lambda m, a, out: self.cur["feats"].append(out))]
        if cap.depth_module is not None:
            self.handles += [
                cap.depth_module.register_forward_pre_hook(
                    lambda m, a: self.cur["maps"].append(a[0])),
                cap.depth_module.register_forward_hook(
                    lambda m, a, out: self.cur["dep"].append(out))]

    def take(self) -> Dict[str, List[torch.Tensor]]:
        got, self.cur = self.cur, {k: [] for k in self.cur}
        return got

    def close(self):
        for h in self.handles:
            h.remove()


def row_steps(tokens: np.ndarray, end_id: int) -> np.ndarray:
    """Per row, the decode steps up to and including its first <end>."""
    ended = tokens == end_id
    return np.where(ended.any(1), ended.argmax(1) + 1, tokens.shape[1])


def chunk_rows(n: int, buckets) -> List[np.ndarray]:
    """The rows of each chunk the pipeline launches for ``n`` images,
    its padding rows as repeats of the chunk's first row."""
    size = max(buckets)
    out = []
    for lo in range(0, n, size):
        valid = min(size, n - lo)
        bucket = min(b for b in buckets if b >= valid)
        out.append(np.concatenate([np.arange(lo, lo + valid),
                                   np.full(bucket - valid, lo)]))
    return out


class ClosedLoop:
    def __init__(self, cell, seed: int, device, trace: Trace, laps):
        from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr, self.seed, self.device = cfg, tr, seed, device
        self.cell, self.trace = cell, trace
        self.prog = program.build(cfg, seed, device, cell.dpt)
        laps("weights")
        cap = self.prog.cap
        trace.hook(cap.encoder, "rgb_encoder")
        if self.prog.dpt is not None:
            trace.hook(self.prog.dpt.model, "dpt")
            trace.hook(cap.depth_module, "depth_cnn")
        trace.wrap(cap.decoder, "greedy_sample", "decode")
        self.pipe = CaptionPipeline(
            cap, self.prog.word_to_id, self.prog.id_to_word,
            depth_fn=self.prog.dpt.depth_fn() if self.prog.dpt else None,
            max_length=cfg["max_length"], batch_buckets=tr["batch_buckets"])
        n, p = tr["images_per_request"], tr["distinct_requests"]
        self.pool = program.images(
            seed, n * p, cfg["image_size"], device,
            pin=torch.device(device).type == "cuda").numpy().reshape(
            p, n, cfg["image_size"], cfg["image_size"], 3)
        self.end_id = program.special_ids(cfg["vocab_size"])["end"]
        rng = np.random.default_rng(seed)
        self.first_compared = int(rng.integers(0, p))
        self.capture = Capture(cap)
        laps("inputs")
        for request in self.pool:                       # the cell's shapes
            self.pipe.caption_tokens(request)
        self.sync()
        self.capture.take()
        laps("warmup")

    def sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float) -> Dict:
        """Requests back to back until ``seconds`` have passed; the counts
        the metrics are made from."""
        p = self.tr["distinct_requests"]
        reqs, kept, failed = [], {}, 0
        t_start = time.perf_counter()
        i = 0
        while True:
            t0 = time.perf_counter()
            try:
                with self.trace.span("request"):
                    toks = self.pipe.caption_tokens(self.pool[i % p])
            except Exception as e:      # a failed request counts as missing
                failed += 1
                print(f"request {i} failed: {e!r}", file=sys.stderr)
                toks = None
            t1 = time.perf_counter()
            got = self.capture.take()
            if toks is not None:
                reqs.append({"index": i, "t0": t0, "t1": t1,
                             "steps": row_steps(toks, self.end_id)})
                rec = dict(got, tokens=toks, request=i % p)
                if i == self.first_compared:
                    kept["first"] = rec
                kept["last"] = rec
            i += 1
            if t1 - t_start >= seconds:
                break
        self.kept = kept
        done = reqs
        captions = sum(len(r["steps"]) for r in done)
        span = (done[-1]["t1"] - done[0]["t0"]) if done else float("nan")
        dpt_ops = self.cell.dpt.counts.ops if self.cell.dpt else None
        flops = sum(counts.caption(self.cfg, int(s), dpt_ops)
                    for r in done for s in r["steps"])
        chunks = [r["steps"][rows] for r in done
                  for rows in chunk_rows(len(r["steps"]),
                                         self.tr["batch_buckets"])]
        lengths = np.concatenate([r["steps"] for r in done]) if done else []
        longest = self.cfg["max_length"]
        ms = [1e3 * (r["t1"] - r["t0"]) for r in done]
        return {"attempted": i, "failed": failed,
                "captions_per_s": captions / span, "captions": captions,
                "request_ms": [ms[:3], float(np.median(ms)) if ms else None,
                               ms[-3:]],
                "work": captions, "work_s": span,
                "model_flops": flops, "chunk_steps": chunks,
                "caption_steps": np.bincount(lengths, minlength=longest + 1)[
                    1:].tolist() if done else [],
                "chunks_ended_early": float(np.mean(
                    [c.max() < longest for c in chunks])) if chunks else 0.0}

    def judge(self) -> Dict[str, float]:
        """Free the program, then compare the requests kept."""
        served = self.prog.served
        self.capture.close()
        del self.pipe, self.prog
        records = list({id(r): r for r in self.kept.values()}.values())
        self.kept = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        return judge.captions(self.cfg, served, records, self.pool,
                              self.device, self.cell.dpt)
