#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port's main path: base-soft greedy captioning.

Run from the root of a checkout, on a machine with one CUDA card (written
for an NVIDIA H100):

    python3 chip_smoke.py

It imports nothing of JAX. Phases, one line each; any failure raises and
the script exits non-zero:

1. environment: torch, the card, ``nvidia-smi`` name and power limit; TF32
   off for matmuls and convolutions;
2. build: the CUDA kernels from ``depth_image_captioning_pub_torch/csrc``
   with nvcc for sm_90a (ptxas register/spill report printed);
3. decode_step kernel vs its plain version at full width (B=64, K=196,
   D=2048 bf16 features, A=E=H=128): max abs error <= 1e-4 on h', c',
   alpha (f32 sums in another order);
4. greedy decode kernel vs its plain version (B=64, V=9956, 30 steps,
   <end> set): token agreement >= 0.99 (random weights make near-ties
   possible and a flip cascades along its row), and exact equality with
   the <end> bias raised so every row ends at step 0;
5. main path: ``CaptionPipeline`` over a seeded random-weight base-soft
   captioner at full width (ResNet-152 bf16, 224x224, V=9956, buckets
   1/16/64) answers requests of 1, 16 and 100 images; the decode kernel's
   launch counter must grow by one per chunk and the plain greedy version
   must not run; tokens are checked against the plain version on one
   request; per-request latency and captions/s are printed.

The line before the last is a JSON object with the main path's kernel
(the greedy decode; the step kernel of phase 3 is not launched by the main
path, which runs the step inside the greedy kernel): its launches in phase
5, its error and its time beside the plain version's. The last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np

B, K, D, A, E, H = 64, 196, 2048, 128, 128, 128
VOCAB = 9956
MAX_LEN = 30
STEP_ATOL = 1e-4
MIN_AGREEMENT = 0.99
STEP_SRC = "depth_image_captioning_pub_torch/csrc/decode_step.cu"
SEQ_SRC = "depth_image_captioning_pub_torch/csrc/decode_seq.cu"
STEP_TPU = "depth_image_captioning_pub_tpu/ops/pallas/decode_step.py:175"
SEQ_TPU = "depth_image_captioning_pub_tpu/ops/pallas/decode_seq.py:287"


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters):
    """Mean device time of fn() over iters calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_env():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available"
                         "() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {smi}")
    log("env", f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from depth_image_captioning_pub_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    log("build", f"{_build.library_path()} in "
        f"{time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.BUILD_SECONDS:.1f} s)")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("build", "ptxas " + line.strip())


def phase_step(smi):
    import torch
    from depth_image_captioning_pub_torch.models.initializers import (
        torch_linear_kernel)
    from depth_image_captioning_pub_torch.ops.kernels import decode_step
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(1)

    def u(*shape):
        return torch_linear_kernel(shape, gen).to(dev)

    w = decode_step.pack_weights(u(H, A), u(A), u(A), u(1), u(H, D), u(D),
                                 u(E + D, 4 * H), u(H, 4 * H), u(4 * H),
                                 u(4 * H), dim_embedding=E)
    feats = torch.from_numpy(np.abs(rng.standard_normal((B, K, D)))
                             .astype(np.float32)).to(dev, torch.bfloat16)
    proj = torch.from_numpy(rng.standard_normal((B, K, A)).astype(
        np.float32) * 0.5).to(dev)
    emb, h, c = (torch.from_numpy(rng.standard_normal((B, n)).astype(
        np.float32) * 0.5).to(dev) for n in (E, H, H))
    args = (feats, proj, emb, h, c, w)
    got = decode_step.fused_decode_core(*args)
    torch.cuda.synchronize()
    want = decode_step.fused_decode_core_plain(*args)
    err = max((g - x).abs().max().item() for g, x in zip(got, want))
    if not all(torch.isfinite(g).all() for g in got):
        raise RuntimeError("decode_step kernel produced non-finite values")
    if err > STEP_ATOL:
        raise RuntimeError(f"decode_step max abs err {err} > {STEP_ATOL}")
    ms = cuda_ms(lambda: decode_step.fused_decode_core(*args), 50)
    plain_ms = cuda_ms(lambda: decode_step.fused_decode_core_plain(*args),
                       50)
    log("decode_step", f"B={B} K={K} D={D} bf16 A=E=H={H}: max abs err "
        f"{err:.3e} (tol {STEP_ATOL}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms [{smi}]; source {STEP_SRC}, replaces "
        f"{STEP_TPU}")


def phase_seq(smi):
    import torch
    from depth_image_captioning_pub_torch.cli import (
        SPECIAL, placeholder_vocab)
    from depth_image_captioning_pub_torch.models.decoder import (
        AttentionDecoder)
    from depth_image_captioning_pub_torch.ops.attention import (
        project_features)
    from depth_image_captioning_pub_torch.ops.kernels import decode_seq
    dev = torch.device("cuda")
    w2i, _ = placeholder_vocab(VOCAB)
    start_id, end_id = w2i[SPECIAL.start], w2i[SPECIAL.end]
    dec = AttentionDecoder(VOCAB, A, E, D, H, device=dev)
    dec.reset_parameters(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(np.abs(rng.standard_normal((B, K, D)))
                             .astype(np.float32)).to(dev, torch.bfloat16)
    with torch.inference_mode():
        proj = project_features(dec.att_params(), feats,
                                compute_dtype=torch.float32)
        state = dec.init_state(feats)
        w = dec.seq_weights()

        def run(fn, weights):
            return fn(feats, proj, state.h, state.c, weights,
                      max_length=MAX_LEN, start_id=start_id, end_id=end_id)

        got = run(decode_seq.fused_greedy_decode, w)
        torch.cuda.synchronize()
        want = run(decode_seq.fused_greedy_decode_plain, w)
        agree = (got == want).float().mean().item()
        distinct = len({tuple(r) for r in got.tolist()})
        if agree < MIN_AGREEMENT:
            raise RuntimeError(f"greedy token agreement {agree} < "
                               f"{MIN_AGREEMENT}")
        ms = cuda_ms(lambda: run(decode_seq.fused_greedy_decode, w), 10)
        plain_ms = cuda_ms(lambda: run(decode_seq.fused_greedy_decode_plain,
                                       w), 10)
        b_out = w.b_out.clone()
        b_out[0, end_id] += 100.0
        w_end = w._replace(b_out=b_out)
        got_end = run(decode_seq.fused_greedy_decode, w_end)
        torch.cuda.synchronize()
        want_end = run(decode_seq.fused_greedy_decode_plain, w_end)
        err = (got_end - want_end).abs().max().item()
        if err != 0 or not bool((got_end == end_id).all()):
            raise RuntimeError("greedy kernel with <end> forced differs "
                               "from the plain version")
    log("decode_seq", f"B={B} V={VOCAB} L={MAX_LEN} end_id={end_id}: token "
        f"agreement {agree:.4f} (min {MIN_AGREEMENT}), {distinct} distinct "
        f"rows; <end>-forced run exact; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms [{smi}]")
    return {"name": "decode_seq", "route": "cuda", "source": SEQ_SRC,
            "replaces": SEQ_TPU, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "token_agreement": agree}


def phase_main_path(smi):
    import torch
    from depth_image_captioning_pub_torch.cli import (
        SPECIAL, placeholder_vocab)
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.ops.attention import (
        project_features)
    from depth_image_captioning_pub_torch.ops.image_ops import (
        imagenet_normalize, to_unit_float)
    from depth_image_captioning_pub_torch.ops.kernels import (
        decode_seq, decode_step)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    dev = torch.device("cuda")
    w2i, i2w = placeholder_vocab(VOCAB)
    t0 = time.perf_counter()
    cap = build_captioner("base-soft", VOCAB, device=dev)
    cap.init(torch.Generator().manual_seed(0))
    pipe = CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                           batch_buckets=(1, 16, 64))
    log("main", f"base-soft ResNet-152 bf16 + decoder, V={VOCAB}, "
        f"{sum(p.numel() for p in cap.parameters()) / 1e6:.1f}M params, "
        f"built in {time.perf_counter() - t0:.1f} s")
    images = np.random.default_rng(0).integers(
        0, 256, (117, 224, 224, 3), dtype=np.uint8)
    requests = [images[:1], images[1:17], images[17:117]]
    for size in (1, 16, 64):          # warm-up: one call per bucket
        pipe.caption_tokens(images[:size])

    plain_calls = []
    plain = decode_seq.fused_greedy_decode_plain

    def counting_plain(*args, **kwargs):
        plain_calls.append(1)
        return plain(*args, **kwargs)

    decode_seq.fused_greedy_decode_plain = counting_plain
    decode_seq.LAUNCHES = 0
    decode_step.LAUNCHES = 0
    outputs, lines = [], []
    try:
        for req in requests:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = pipe.caption_tokens(req)
            dt = time.perf_counter() - t0
            outputs.append(toks)
            lines.append(f"{len(req)} images: {dt * 1e3:.1f} ms, "
                         f"{len(req) / dt:.1f} caps/s")
    finally:
        decode_seq.fused_greedy_decode_plain = plain
    launches = {"decode_seq": decode_seq.LAUNCHES,
                "decode_step": decode_step.LAUNCHES}
    chunks = sum(-(-len(r) // pipe.batch_size) for r in requests)
    if launches["decode_seq"] != chunks:
        raise RuntimeError(f"decode_seq launched {launches['decode_seq']} "
                           f"times for {chunks} chunks")
    if plain_calls:
        raise RuntimeError("the plain greedy version ran on the main path")
    for req, toks in zip(requests, outputs):
        if (toks.shape != (len(req), MAX_LEN) or toks.dtype != np.int32
                or toks.min() < 0 or toks.max() >= VOCAB):
            raise RuntimeError(f"bad tokens {toks.dtype} {toks.shape}")
    for line in lines:
        log("main", f"{line} [{smi}]")

    # reference on one request: the plain decode on the same features
    with torch.inference_mode():
        x = torch.from_numpy(requests[1]).to(dev)
        feats = cap.encoder(imagenet_normalize(to_unit_float(x)))
        if not bool(torch.isfinite(feats).all()):
            raise RuntimeError("encoder features are not finite")
        dec = cap.decoder
        proj = project_features(dec.att_params(), feats,
                                compute_dtype=torch.float32)
        state = dec.init_state(feats)
        ref = decode_seq.fused_greedy_decode_plain(
            feats, proj, state.h, state.c, dec.seq_weights(),
            max_length=MAX_LEN, start_id=w2i[SPECIAL.start],
            end_id=w2i[SPECIAL.end]).cpu().numpy()
    agree = float((ref == outputs[1]).mean())
    if agree < MIN_AGREEMENT:
        raise RuntimeError(f"main path vs plain decode agreement {agree}")
    caps = pipe(list(requests[0])) + pipe(list(requests[1][:2]))
    log("main", f"16-image request vs plain decode on the same features: "
        f"token agreement {agree:.4f}; features {tuple(feats.shape)} "
        f"{feats.dtype}, |feat| max {feats.abs().max().item():.3e}")
    for c in caps:
        log("main", f"caption: {c!r}")
    log("main", f"launches {launches} for {chunks} chunks; plain greedy "
        f"calls 0")
    return launches


def main():
    smi = phase_env()
    import torch
    phase_build()
    # the step kernel is checked and timed, but it is not a kernel of the
    # main path: the path runs its device step inside the greedy kernel
    phase_step(smi)
    seq = phase_seq(smi)
    seq["launches"] = phase_main_path(smi)["decode_seq"]
    print(smi)
    print(json.dumps({"kernels": [seq]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
