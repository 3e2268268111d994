#!/usr/bin/env python3
"""What the TF32 guard costs the RGB encoder, on one CUDA card.

    python3 tools/encoder_guard_ab.py

Builds the base-soft captioner at full width (ResNet-152 bf16 at 224x224,
seeded random weights) and times its encoder on seeded random images at
B = 1, 16 and 64 with ``ResNetBackbone.forward`` as shipped, inside
``ops/precision.full_f32``, and with the same forward unwrapped, in turns
(guarded, bare, bare, guarded, four times). TF32 is off for the whole
process, as ``chip_smoke.py`` sets it, so both versions run the same
kernels. Each timing is the mean of 20 calls between CUDA events after one
warm-up call; prints the least and the median of the eight timings of
each, with the card's ``nvidia-smi`` name and power limit.
"""

import contextlib
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
VOCAB = 9956
ITERS = 20


def main():
    import torch
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.models.resnet import ResNetBackbone
    from depth_image_captioning_pub_torch.ops.image_ops import (
        imagenet_normalize, to_unit_float)
    if not torch.cuda.is_available():
        raise SystemExit("encoder_guard_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cap = build_captioner("base-soft", VOCAB, device=dev)
    cap.init(torch.Generator().manual_seed(0))
    bare = ResNetBackbone.forward.__wrapped__
    images = np.random.default_rng(0).integers(
        0, 256, (64, 224, 224, 3), dtype=np.uint8)

    def timed(x, guarded):
        with contextlib.ExitStack() as stack:
            if not guarded:
                stack.enter_context(
                    mock.patch.object(ResNetBackbone, "forward", bare))
            cap.encoder(x)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                cap.encoder(x)
            stop.record()
            torch.cuda.synchronize()
        return start.elapsed_time(stop) / ITERS

    with torch.inference_mode():
        for bsz in (1, 16, 64):
            x = imagenet_normalize(to_unit_float(
                torch.from_numpy(images[:bsz]).to(dev)))
            runs = {True: [], False: []}
            for guarded in (True, False, False, True) * 4:
                runs[guarded].append(timed(x, guarded))
            g, b = runs[True], runs[False]
            print(f"[encoder] B={bsz}: guarded least {min(g):.4f} median "
                  f"{statistics.median(g):.4f} ms, bare least {min(b):.4f} "
                  f"median {statistics.median(b):.4f} ms (runs guarded "
                  f"{', '.join(f'{t:.3f}' for t in g)}; bare "
                  f"{', '.join(f'{t:.3f}' for t in b)}) [{smi}]",
                  flush=True)


if __name__ == "__main__":
    main()
