#!/usr/bin/env python3
"""Device time by operator of the depth-soft caption program on one CUDA
card, from ``torch.profiler``.

    python3 tools/depth_profile.py [--out FILE.json]

Builds the depth-soft captioner (ResNet-152 bf16, DPT-hybrid bf16 at
384x384, ``DepthCNNEncoder``, V=9956) with seeded random weights, as phase 7
of ``chip_smoke.py`` does, warms it up on 64-image chunks, then profiles
two chunks of 64 images through ``CaptionPipeline.caption_tokens``.
Prints, per chunk, the device time of each PyTorch operator (the kernels it
launches itself) and of each of the package's own CUDA kernels (namespace
``dcap``), their share of all device time, and the card's busy share of the
wall time (with the profiler on). Run it in a process of its own: a
profiler window slows later work in the same process.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
VOCAB, MAX_LEN, CHUNK, CHUNKS = 9956, 30, 64, 2


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from depth_image_captioning_pub_torch.cli import placeholder_vocab
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.models.dpt import DPTDepthEstimator
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("depth_profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    w2i, i2w = placeholder_vocab(VOCAB)
    cap = build_captioner("depth-soft", VOCAB, device=dev)
    cap.init(torch.Generator().manual_seed(0))
    est = DPTDepthEstimator(device=dev)
    est.init(torch.Generator().manual_seed(1))
    pipe = CaptionPipeline(cap, w2i, i2w, depth_fn=est.depth_fn(),
                           max_length=MAX_LEN, batch_buckets=(CHUNK,))
    images = np.random.default_rng(1).integers(
        0, 256, (CHUNK * CHUNKS, 224, 224, 3), dtype=np.uint8)
    for _ in range(2):                      # warm-up
        pipe.caption_tokens(images[:CHUNK])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.caption_tokens(images)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, kernels_us = {}, 0.0
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if us <= 0:
            continue
        if evt.device_type == DeviceType.CUDA:
            kernels_us += us                  # every kernel, once
            if "dcap::" in evt.key:           # the package's own kernels
                name = evt.key.split("dcap::")[1].split("<")[0].split("(")[0]
                rows[name] = (rows.get(name, (0, 0.0))[0] + evt.count,
                              rows.get(name, (0, 0.0))[1] + us)
        else:
            rows[evt.key] = (evt.count, us)
    per = 1e-3 / CHUNKS                       # us over the window -> ms/chunk
    table = sorted(((name, n / CHUNKS, us * per) for name, (n, us)
                    in rows.items()), key=lambda r: -r[2])
    total = kernels_us * per
    wall_ms = wall * 1e3 / CHUNKS
    print(f"[profile] depth-soft, {CHUNKS} chunks of {CHUNK} images: "
          f"{total:.2f} ms of kernels per chunk, {wall_ms:.2f} ms of wall "
          f"time with the profiler on, busy {100 * total / wall_ms:.1f}% "
          f"[{smi}]", flush=True)
    for name, calls, ms in table[:25]:
        print(f"[profile] {ms:8.3f} ms {100 * ms / total:5.1f}% "
              f"{calls:7.1f} calls  {name}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({
            "card": smi, "chunks": CHUNKS, "kernels_ms": total,
            "wall_ms": wall_ms, "rows": [
                {"name": n, "calls": c, "ms": m} for n, c, m in table]},
            indent=1))


if __name__ == "__main__":
    main()
