#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port's main paths: base-soft,
depth-soft and NIC greedy captioning, base-soft beam-5 captioning,
base-soft stochastic (nucleus) captioning, the scored evaluation of
base-soft checkpoint sets, the hard-attention and MLP-depth kinds
(base-hard, mdepth-soft, depth-hard, mdepth-hard) greedy, by beam search
and sampled, scored too, and the serving surface: the HTTP caption server
(greedy and sampled) and the caption CLI over PNG files with the DPT at
224x224.

Run from the root of a checkout, on a machine with one CUDA card (written
for an NVIDIA H100):

    python3 chip_smoke.py

It imports nothing of JAX. Phases, one line each; any failure raises and
the script exits non-zero:

1. environment: torch, the card, ``nvidia-smi`` name and power limit; TF32
   off for matmuls and convolutions;
2. build: the CUDA kernels from ``depth_image_captioning_pub_torch/csrc``
   with nvcc for sm_90a (ptxas register/spill report printed);
3. decode_step kernel (K1: one cooperative launch, one CTA per SM, on the
   shared decode phases) vs its plain version at full width (K=196,
   D=2048, A=E=H=128) at B = 1, 16 and 64 with bf16 and f32 features: max
   abs error <= 1e-4 on h', c', alpha (f32 sums in another order), two
   calls bit-identical; times (bf16: the kernel's own, from launches
   queued behind a spin kernel, and the rate of calls through the
   wrapper, which the host sets) and the bound at each B, and in the log
   line the launch's plan (``decode_step.LAST_PLAN``) and ptxas'
   registers/spills; then at B=64 on mdepth's f32 features at D=2080 and
   at an odd width (D=2044, A=50, E=H=100, zero-padded for the launch),
   with the same tolerance, in ``ms_by_shape``;
4. greedy decode kernel (K2: one cooperative launch, one CTA per SM,
   weights resident in shared memory) vs its plain version at B = 1, 16
   and 64 (V=9956, 30 steps, <end> set): token agreement >= 0.99 at each
   (random weights make near-ties possible and a flip cascades along its
   row), exact equality with the <end> bias raised so every row ends at
   step 0 (K2's ``max_abs_err`` is the largest token difference of these
   runs); times, the bound, and in the log line the per-step floor of
   re-reading the features, the CTA count and shared memory of the launch
   that ran (``decode_seq.LAST_PLAN``) and ptxas' registers/spills; the
   same at B=64 on mdepth's f32 features at D=2080 and at the odd width;
5. main path: ``CaptionPipeline`` over a seeded random-weight base-soft
   captioner at full width (ResNet-152 bf16, 224x224, V=9956, buckets
   1/16/64) answers requests of 1, 16 and 100 images; the decode kernel's
   launch counter must grow by one per chunk and the plain greedy version
   must not run; tokens are checked against the plain version on one
   request; per-request latency and captions/s are printed, and the time
   split of one chunk at each bucket (encoder, decoder set-up, K2, the
   whole caption program; CUDA events, each stage timed alone).
6. ViT attention kernel (K5, bf16 on the tensor cores) vs its plain version
   at full width (Z=64*12=768, N=577, d=64 bf16), unpadded and padded to
   N=584 with n_valid=577: max and mean abs error <= one bf16 ulp of max|v|
   (p and the output are rounded to bf16, and the f32 sums run in another
   order); the same check and times at the 1- and 16-image requests' Z=12
   and Z=192, and at d=32 and d=128 (Z=96); ptxas' register and spill lines
   of the kernel's bf16 instances;
7. depth-soft path: ``CaptionPipeline`` over a seeded random-weight
   depth-soft captioner at full width (ResNet-152 bf16 at 224x224, the
   DPT-hybrid bf16 at 384x384, ``DepthCNNEncoder`` bf16, V=9956, buckets
   1/16/64) answers requests of 1, 16 and 64 images; the ViT attention
   counter must grow by 12 per chunk (one per ViT block) and the greedy
   counter by 1, and no plain version may run; the depth maps must be
   finite and in [0, 1]; on the 16-image request the tokens are compared
   with a run whose attention and decode take the plain versions (with the
   errors of each stage between the two runs); the time split of one
   64-image chunk is printed, with K5's share of it.

   Phase 6 also times ``F.scaled_dot_product_attention`` on the same q and
   k/v sliced to n_valid, laid out [B, 12, N, 64]: a yardstick for K5's
   table row, not a path of the port.
8. NIC greedy kernel (K3: one cooperative launch, one CTA per SM, on the
   greedy kernel's phases) vs its plain version at full width (B = 1, 16
   and 64, E=300, H=128, 2 layers, V=9956, 30 steps): token agreement >=
   0.99, exact equality with one token's bias raised by 100, two calls
   bit-identical, at each B; times, the bound, and in the log line the
   launch's plan (``nic_seq.LAST_PLAN``) and ptxas' registers/spills;
9. NIC path: ``CaptionPipeline`` over a seeded random-weight ``nic``
   captioner at full width (ResNet-152 bf16 at 224x224, V=9956, buckets
   1/16/64) answers requests of 1, 16 and 100 images; K3's counter grows by
   one per chunk, K2's does not, no plain version runs; one request's
   tokens are checked against the plain version on the same features;
10. beam kernel (K4: one cooperative launch, one CTA per SM, on the
   greedy kernel's phases) vs its plain version at full width (B = 1, 16
   and 64 images, W=5, V=9956, 30 steps, <end> set): best-token agreement
   and token and parent record agreement >= 0.99, scores' max abs error <=
   1e-3 at each B, and exact tokens and parents (scores within 1e-3) with
   <end> forced and with every token tied (zeroed vocab head) at B=64;
   times, the bound, and in the log line the per-step feature floor, the
   launch's plan (``beam_seq.LAST_PLAN``) and ptxas' registers/spills; the
   kernel is also timed at W=2..8 at B=64, and at W=6..8, on mdepth's f32
   features at D=2080 and at an odd width (D=2044, A=50, E=H=100,
   zero-padded for the launch; exact with <end> forced) held to its plain
   version as at W=5;
11. beam path: ``CaptionPipeline(beam_size=5)`` over the base-soft
   captioner at full width answers requests of 1, 16 and 64 images; K4's
   counter grows by one per chunk, K2's does not, no plain version runs;
   the 16-image request is compared with a run through the plain version.
12. sampling path: ``CaptionPipeline(sample=True, temperature=1.0,
   top_p=0.9, seed=0)`` over the base-soft captioner at full width answers
   requests of 1, 16 and 64 images; K1's counter grows by ``max_length``
   per chunk, K2's and K4's do not, no plain version runs; on the
   16-image request's features the tokens through K1 are compared with a
   run through the plain step on the same noise (agreement >= 0.99,
   alphas' max abs error), and the top_k=1 draws with K2's greedy tokens
   without <end> (>= 0.99); the time split of one chunk at each bucket
   (encoder, set-up, K1 x 30, head + filter + draw x 30, the program).
13. score path: the base-soft captioner's weights (set 1) and two other
   seeds' decoders (sets 2, 3) are written with ``params_to_jax`` and
   ``save_component`` as three checkpoint sets in the JAX trainer's files
   (``ConfigEval.base_soft_parameter_files``, in a temporary directory
   under ``build/``); ``evaluate`` scores them through
   ``load_eval_components`` over an in-memory set of 256 seeded 224x224
   uint8 images with five placeholder-vocabulary references each (batch
   64), then set 1 again with ``beam_size=5``. Each loaded captioner must
   equal the written weights bit for bit; K2's counter must grow by 4 per
   set and K4's by 4 on the beam run, with no plain version; set 1's
   hypotheses must equal ``CaptionPipeline``'s captions of the same arrays
   and differ from set 2's; the seven metrics must hold 3 finite values
   each and the pickle must be written. Per set it prints the load,
   caption and host scoring times and the scored images/s.
14. base-hard path: ``CaptionPipeline(seed=0)`` over a seeded base-hard
   captioner at full width (ResNet-152 bf16, 224x224, V=9956, buckets
   1/16/64; the attention vector and the LSTM's context rows rescaled to a
   trained model's scales, so that the region noise moves tokens) answers
   requests of 1, 16 and 64 images; no kernel launches (hard attention
   runs on PyTorch ops; the JAX package has no TPU kernel for it); the
   same seed repeats the 16-image request's tokens and seed 1 changes
   them; on that request's features and noise the card's decoder agrees
   with the same decoder on the CPU on >= 0.99 of tokens; sampled alphas
   are exactly one-hot; one 16-image request with ``beam_size=5`` and one
   with ``sample=True``; the time split of one 64-image chunk (encoder,
   set-up, the hard loop; the loop on the host clock too).
15. mdepth-soft path: the mdepth-soft captioner at full width (ResNet-152,
   phase 7's DPT, ``DepthMLPEncoder`` on 16x16 depth patches, concat to
   D=2080 f32) answers requests of 1, 16 and 64 images: K5 12 and K2 1
   launches a chunk, no plain version; the 16-image request agrees with a
   run through the plain attention and decode on >= 0.99 of tokens; one
   16-image request with ``beam_size=5`` (K4 1 a chunk) and one with
   ``sample=True`` (K1 30 a chunk); the time split of one 64-image chunk
   (RGB encoder, DPT, MLP encoder, set-up, K2).
16. depth-hard and mdepth-hard at full width: one 16-image request each,
   greedy and with ``beam_size=5``: K5 12 launches, no decode kernel.
    Then one base-hard set (phase 14's captioner, scored twice: identical
   hypotheses) and one mdepth-soft set (phase 15's: K2 4 and K5 48
   launches), written with ``params_to_jax`` and ``save_component`` in the
   JAX trainer's files and scored by ``evaluate`` on phase 13's 256
   images: reloaded weights bit-equal, the load, caption and scoring
   seconds printed.

17. serve: phase 5's base-soft weights written as checkpoint set 1 in the
   JAX trainer's files (``params_to_jax`` + ``save_component``, with a
   vocabulary, in a working directory under ``build/``) and read back by
   ``CaptionPipeline.from_experiment`` (buckets 1/2/4/8/16); ``serve(...)``
   on 127.0.0.1:0 in a thread answers the JAX bench's traffic: 480x640 PNG
   bodies made from ``SEED`` and encoded here with zlib (every scanline
   filter), 50 sequential POSTs, then 16 concurrent clients x 10 POSTs.
   Every reply must be 200; a sequential one must equal the pipeline's
   direct caption of the same decoded array alone (computed before the
   server starts: only the worker thread may use the card while it is
   up). The worker's device calls are recorded (arrays and tokens) and,
   once the server has stopped, each is run again: the encoder at the
   bucket the call was padded to, K2 over the bucket (the served tokens,
   bit for bit), K2 over each row alone at those features (the same
   tokens: no row depends on another) and K2's plain version over the
   bucket (token agreement over all calls at least ``MIN_AGREEMENT``). A
   concurrent reply must be its row's caption in the call that served it;
   for each one that differs from its image's caption alone, the largest
   difference between its features at bucket 1 and at the served bucket
   and the two captions' logit margin at the first token where they part
   are printed. /metrics must show a batch above 1, /healthz every
   image; a POST declaring more than ``MAX_REQUEST_BYTES`` gets 413 and a
   closed connection; after set 1's decoder file is rewritten, /reload
   must give exactly a fresh pipeline's captions over the new files. K2
   launches once a device call, no plain version runs. Prints the
   latency percentiles, captions/s, effective batch, the batch histogram
   and the host decode's share of a request; where Pillow is importable
   the decoder is also held to Pillow's bytes.
18. serve-sample: two servers over that captioner with ``sample=True,
   top_p=0.9`` and one seed answer 16 sequential requests with the same
   captions; K1 launches 30 a device call.
19. caption-depth224-beam3: ``caption.main`` over a directory of 16
   480x640 PNG files at ``--kind depth-soft --beam 3 --dpt-size 224
   --gelu tanh --dpt-head lowres`` in a working directory holding a
   depth-soft set: its output must equal ``CaptionPipeline.
   from_experiment``'s captions of the same paths; K5 12 and K4 1
   launches; K5 at the DPT-at-224 shape (Z = 16 * 12, N = 197, d = 64)
   against its plain version, its time in ``ms_by_shape``. No JPEG: the
   card's machine has no libjpeg headers, so the native library is built
   without its JPEG part there.

Each path (phases 5, 7, 9, 11-19: ``PATHS``) runs with every launch counter
set to 0 just before it and read just after. The line before the last is a JSON
object with the five ported kernels (K1 step, K2 greedy, K3 NIC greedy, K4
beam, K5 ViT attention): launches per path, error, time beside the plain
version's, the least time the card could take for the same work
(``bound_ms``: the larger of the bytes moved over 3.35 TB/s and the
operations over 67 TFLOP/s f32, or 989 TFLOP/s bf16 for K5, from this
run's inputs) and the time of one PyTorch call computing the same function
where there is one (``library_ms``: SDPA for K5; no single PyTorch call
computes a whole decode loop or step, so K1-K4 have none); every kernel
also carries ``ms_by_shape``. The last line is
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
SEQ_BATCHES = (1, 16, 64)   # K1-K4 at the main path's chunk sizes
STEP_ATOL = 1e-4
MIN_AGREEMENT = 0.99
SCORE_ATOL = 1e-3   # beam scores: 30 f32 log-softmax terms summed
STEP_SRC = "depth_image_captioning_pub_torch/csrc/decode_step.cu"
SEQ_SRC = "depth_image_captioning_pub_torch/csrc/decode_seq.cu"
STEP_TPU = "depth_image_captioning_pub_tpu/ops/pallas/decode_step.py:175"
SEQ_TPU = "depth_image_captioning_pub_tpu/ops/pallas/decode_seq.py:287"
VIT_SRC = "depth_image_captioning_pub_torch/csrc/vit_attention.cu"
VIT_TPU = "depth_image_captioning_pub_tpu/ops/pallas/vit_attention.py:77"
VIT_Z, VIT_N, VIT_D = 64 * 12, 577, 64
# K5 also at the 1- and 16-image requests' Z and at the other head dims
VIT_MORE = ((12, 64), (192, 64), (96, 32), (96, 128))     # Z, d at N=577
NIC_SRC = "depth_image_captioning_pub_torch/csrc/nic_seq.cu"
NIC_TPU = "depth_image_captioning_pub_tpu/ops/pallas/nic_seq.py:178"
BEAM_SRC = "depth_image_captioning_pub_torch/csrc/beam_seq.cu"
BEAM_TPU = "depth_image_captioning_pub_tpu/ops/pallas/beam_seq.py:475"
NIC_E, NIC_LAYERS = 300, 2
BEAM = 5
D_CONCAT = 2080          # mdepth-*: 2048 RGB + 32 depth channels, f32
# an odd width, zero-padded for K1, K2 and K4: D, and A, E, H in the
# AttentionDecoder's argument order (dim_attention, dim_embedding,
# dim_encoder, dim_decoder)
ODD_D, ODD_A, ODD_E, ODD_H = 2044, 50, 100, 100
ODD_AEDH = (ODD_A, ODD_E, ODD_D, ODD_H)
ODD_LABEL = f"odd D={ODD_D} A={ODD_A} E={ODD_E} H={ODD_H}"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS = 67e12              # H100 SXM f32, CUDA cores (TF32 off)
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense
PATHS = ("base-soft", "depth-soft", "nic", "base-soft-beam5",
         "base-soft-sample", "score", "base-hard", "base-hard-beam5",
         "base-hard-sample", "mdepth-soft", "mdepth-soft-beam5",
         "mdepth-soft-sample", "depth-hard", "depth-hard-beam5",
         "mdepth-hard", "mdepth-hard-beam5", "score-base-hard",
         "score-mdepth-soft", "serve", "serve-sample",
         "caption-depth224-beam3")
TOP_P = 0.9          # the sampling path's nucleus
SCORE_IMAGES, SCORE_SETS, SCORE_BATCH = 256, 3, 64
SEED = 0             # the serving phases' request images


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


def queued_ms(fn, iters, spin_cycles=20_000_000, tries=4):
    """Mean device time of fn() over iters calls queued behind a spin
    kernel, so that the card runs them back to back whatever the host's
    launch rate: a short kernel's own time, where ``cuda_ms`` gives the
    rate at which the host can call it. The spin starts at spin_cycles
    (~10 ms); where the host took longer than that to queue the calls, it
    grows to three times the host's time and the calls are queued again,
    up to tries times in all."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for _ in range(tries):
        torch.cuda._sleep(spin_cycles)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spin_ms = spin_cycles / 2.0e6        # the spin at 2 GHz, the most
        if host_ms <= 0.8 * spin_ms:
            return start.elapsed_time(stop) / iters
        spin_cycles = int(3 * host_ms * 2.0e6)
    raise RuntimeError(f"the host took {host_ms:.2f} ms to queue {iters} "
                       f"calls: longer than the spin of {spin_ms:.2f} ms, "
                       f"{tries} times")


def bound(nbytes, flops, peak):
    """(ms, "bytes" or "operations"): the least time for the work, the
    larger of the bytes over the memory rate and the operations over the
    peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def step_flops(k, d, a, e, h):
    """Multiply-adds x 2 of one attention-LSTM step for one row."""
    return 2 * (h * a + k * a + k * d + h * d + (e + d + h) * 4 * h)


def kernel_modules():
    from depth_image_captioning_pub_torch.ops.kernels import (
        beam_seq, decode_seq, decode_step, nic_seq, vit_attention)
    return {"decode_step": decode_step, "decode_seq": decode_seq,
            "nic_seq": nic_seq, "beam_seq": beam_seq,
            "vit_attention": vit_attention}


def reset_counts():
    for mod in kernel_modules().values():
        mod.LAUNCHES = 0


def read_counts():
    return {name: mod.LAUNCHES for name, mod in kernel_modules().items()}


class PlainCalls:
    """Within the block, every plain version of the kernels counts its
    calls in ``calls`` (the wrappers look them up by module name)."""

    NAMES = {"decode_step": "fused_decode_core_plain",
             "decode_seq": "fused_greedy_decode_plain",
             "nic_seq": "fused_nic_greedy_decode_plain",
             "beam_seq": "fused_beam_decode_plain",
             "vit_attention": "fused_attention_plain"}

    def __enter__(self):
        self.calls = []
        self.saved = []
        for key, name in self.NAMES.items():
            mod = kernel_modules()[key]
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self._counting(fn))
        return self

    def _counting(self, fn):
        def wrapped(*args, **kwargs):
            self.calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def run_requests(pipe, requests, smi, tag):
    """Time each request (host clock, tokens on the host); counters reset
    just before and read just after."""
    import torch
    outputs, lines = [], []
    torch.cuda.synchronize()
    reset_counts()
    with PlainCalls() as plain:
        for req in requests:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = pipe.caption_tokens(req)
            dt = time.perf_counter() - t0
            outputs.append(toks)
            lines.append(f"{len(req)} images: {dt * 1e3:.1f} ms, "
                         f"{len(req) / dt:.1f} caps/s")
    launches = read_counts()
    if plain.calls:
        raise RuntimeError(f"plain versions ran on the {tag} path: "
                           f"{sorted(set(plain.calls))}")
    for req, toks in zip(requests, outputs):
        if (toks.shape != (len(req), MAX_LEN) or toks.dtype != np.int32
                or toks.min() < 0 or toks.max() >= VOCAB):
            raise RuntimeError(f"bad tokens {toks.dtype} {toks.shape}")
    for line in lines:
        log(tag, f"{line} [{smi}]")
    return outputs, launches


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
    """K1 at B = 1, 16 and 64 (the sampling path's chunk sizes) against
    its plain version, bf16 and f32 features: error, bit-identical
    repeats, times, the bound and the launch's plan."""
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
    feats64 = torch.from_numpy(np.abs(rng.standard_normal((B, K, D)))
                               .astype(np.float32)).to(dev)
    proj64 = torch.from_numpy(rng.standard_normal((B, K, A)).astype(
        np.float32) * 0.5).to(dev)
    emb64, h64, c64 = (torch.from_numpy(rng.standard_normal((B, n)).astype(
        np.float32) * 0.5).to(dev) for n in (E, H, H))
    for args, line in ptxas_report("step_kernel").items():
        log("decode_step", f"ptxas, "
            f"{'bf16' if 'bfloat16' in args else 'f32'} features: {line}")
    by_shape, worst = {}, 0.0
    for bsz in SEQ_BATCHES:
        rows = [t[:bsz].contiguous() for t in (proj64, emb64, h64, c64)]
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            feats = feats64[:bsz].to(dtype).contiguous()
            args = (feats, *rows, w)
            got = decode_step.fused_decode_core(*args)
            torch.cuda.synchronize()
            plan = decode_step.LAST_PLAN      # the plan of that launch
            again = decode_step.fused_decode_core(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise RuntimeError(f"two decode_step calls differ at "
                                   f"B={bsz}")
            want = decode_step.fused_decode_core_plain(*args)
            if not all(torch.isfinite(g).all() for g in got):
                raise RuntimeError("decode_step kernel produced non-finite "
                                   "values")
            err = max((g - x).abs().max().item() for g, x in zip(got, want))
            if err > STEP_ATOL:
                raise RuntimeError(f"decode_step max abs err {err} > "
                                   f"{STEP_ATOL} at B={bsz}, {dtype}")
            errs[dtype] = err
            worst = max(worst, err)
        # times on the path's bf16 features: the kernel's own (queued
        # launches) and the wrapper's call rate
        ms = queued_ms(lambda: decode_step.fused_decode_core(*args), 50)
        call_ms = cuda_ms(lambda: decode_step.fused_decode_core(*args), 50)
        plain_ms = cuda_ms(
            lambda: decode_step.fused_decode_core_plain(*args), 50)
        bound_ms, bound_by = bound(nbytes(*args[:5], *w, *got),
                                   bsz * step_flops(K, D, A, E, H),
                                   F32_FLOPS)
        by_shape[f"B={bsz}"] = {
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": max(errs.values())}
        log("decode_step", f"B={bsz} K={K} D={D} A=E=H={H}: max abs err "
            f"bf16 {errs[torch.bfloat16]:.3e}, f32 "
            f"{errs[torch.float32]:.3e} (tol {STEP_ATOL}); two calls "
            f"bit-identical; kernel {ms:.4f} ms (launches queued; "
            f"{call_ms:.4f} ms a call through the wrapper), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
            f"(bf16); one cooperative "
            f"launch of {plan.ctas} CTAs x {decode_step.THREADS} threads, "
            f"{plan.smem_bytes} B shared memory each ({plan.h_cols} "
            f"h-product columns, {plan.units} hidden unit(s), h tile "
            f"{plan.h_rows} rows, attention chunk {plan.a_chunk}) [{smi}]")
    # mdepth's f32 features at D=2080, and an odd width (zero-padded for
    # the launch), at B=64
    for label, (d, a, e, h), dtype in (
            (f"B={B} D={D_CONCAT} f32", (D_CONCAT, A, E, H), torch.float32),
            (f"B={B} {ODD_LABEL}", (ODD_D, ODD_A, ODD_E, ODD_H),
             torch.bfloat16)):
        wx = decode_step.pack_weights(
            u(h, a), u(a), u(a), u(1), u(h, d), u(d), u(e + d, 4 * h),
            u(h, 4 * h), u(4 * h), u(4 * h), dim_embedding=e)
        feats = torch.from_numpy(np.abs(rng.standard_normal((B, K, d)))
                                 .astype(np.float32)).to(dev, dtype)
        rows = [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 0.5).to(dev)
            for shape in ((B, K, a), (B, e), (B, h), (B, h))]
        args = (feats, *rows, wx)
        got = decode_step.fused_decode_core(*args)
        torch.cuda.synchronize()
        again = decode_step.fused_decode_core(*args)
        want = decode_step.fused_decode_core_plain(*args)
        if not all(torch.equal(g, x) for g, x in zip(got, again)):
            raise RuntimeError(f"two decode_step calls differ at {label}")
        err = max((g - x).abs().max().item() for g, x in zip(got, want))
        if not err <= STEP_ATOL:
            raise RuntimeError(f"decode_step max abs err {err} > "
                               f"{STEP_ATOL} at {label}")
        worst = max(worst, err)
        # at the odd width each call also pads its inputs (~20 small
        # launches): fewer calls, so that they fit the launch queue behind
        # a longer spin
        ms = queued_ms(lambda: decode_step.fused_decode_core(*args), 10,
                       spin_cycles=100_000_000)
        call_ms = cuda_ms(lambda: decode_step.fused_decode_core(*args), 50)
        plain_ms = cuda_ms(
            lambda: decode_step.fused_decode_core_plain(*args), 50)
        bound_ms, bound_by = bound(nbytes(*args[:5], *wx, *got),
                                   B * step_flops(K, d, a, e, h), F32_FLOPS)
        by_shape[label] = {
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}
        log("decode_step", f"{label} {dtype}: max abs err {err:.3e} (tol "
            f"{STEP_ATOL}); two calls bit-identical; kernel {ms:.4f} ms "
            f"(launches queued; {call_ms:.4f} ms a call through the "
            f"wrapper), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}) [{smi}]")
    main = by_shape[f"B={B}"]
    log("decode_step", f"source {STEP_SRC}, replaces {STEP_TPU}")
    return {"name": "decode_step", "route": "cuda", "source": STEP_SRC,
            "replaces": STEP_TPU, "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "ms_by_shape": by_shape}


def phase_seq(smi):
    """K2 at B = 1, 16 and 64 (the main path's chunk sizes) against its
    plain version: token agreement, exact with <end> forced, times, the
    bound, the per-step feature floor and the launch's plan; then at B=64
    on mdepth's f32 features at D=2080 and at an odd width (zero-padded
    for the launch)."""
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
    feats64 = torch.from_numpy(np.abs(rng.standard_normal((B, K, D)))
                               .astype(np.float32)).to(dev, torch.bfloat16)
    for args, line in ptxas_report("greedy_tiled_kernel").items():
        log("decode_seq", f"ptxas, "
            f"{'bf16' if 'bfloat16' in args else 'f32'} features: {line}")
    by_shape, end_err = {}, 0.0

    def greedy_case(dec, feats, label):
        bsz, k, d = feats.shape
        h, a = dec.att_w_dec.shape
        e = dec.dim_embedding
        with torch.inference_mode():
            proj = project_features(dec.att_params(), feats,
                                    compute_dtype=torch.float32)
            state = dec.init_state(feats)
            w = dec.seq_weights()

            def run(fn, weights):
                return fn(feats, proj, state.h, state.c, weights,
                          max_length=MAX_LEN, start_id=start_id,
                          end_id=end_id)

            got = run(decode_seq.fused_greedy_decode, w)
            torch.cuda.synchronize()
            plan = decode_seq.LAST_PLAN      # the plan of that launch
            want = run(decode_seq.fused_greedy_decode_plain, w)
            agree = (got == want).float().mean().item()
            distinct = len({tuple(r) for r in got.tolist()})
            if agree < MIN_AGREEMENT:
                raise RuntimeError(f"greedy token agreement {agree} < "
                                   f"{MIN_AGREEMENT} at {label}")
            ms = cuda_ms(lambda: run(decode_seq.fused_greedy_decode, w), 10)
            plain_ms = cuda_ms(
                lambda: run(decode_seq.fused_greedy_decode_plain, w), 10)
            b_out = w.b_out.clone()
            b_out[0, end_id] += 100.0
            w_end = w._replace(b_out=b_out)
            got_end = run(decode_seq.fused_greedy_decode, w_end)
            torch.cuda.synchronize()
            want_end = run(decode_seq.fused_greedy_decode_plain, w_end)
            err = (got_end - want_end).abs().max().item()
            if err != 0 or not bool((got_end == end_id).all()):
                raise RuntimeError(f"greedy kernel with <end> forced differs "
                                   f"from the plain version at {label}")
        # the steps this run's rows took: up to and including their <end>
        ended = (got == end_id).cpu().numpy()
        steps = int(np.where(ended.any(1), ended.argmax(1) + 1,
                             MAX_LEN).sum())
        bound_ms, bound_by = bound(
            nbytes(feats, proj, state.h, state.c, *w.step, w.w_out, w.b_out,
                   got) + steps * e * 4,
            steps * (step_flops(k, d, a, e, h) + 2 * h * VOCAB), F32_FLOPS)
        # the kernel reads the features again every step (they exceed the
        # L2 at B=64): that stream alone, per step and over the steps run
        loop_steps = int(np.where(ended.any(1), ended.argmax(1) + 1,
                                  MAX_LEN).max())
        floor_step = nbytes(feats) / HBM_BYTES_PER_S * 1e3
        by_shape[label] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "token_agreement": agree}
        log("decode_seq", f"{label} K={k} D={d} A={a} E={e} H={h} "
            f"{feats.dtype} V={VOCAB} L={MAX_LEN} end_id={end_id}: "
            f"token agreement {agree:.4f} (min {MIN_AGREEMENT}), {distinct} "
            f"distinct rows, {steps} row-steps; <end>-forced run exact; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), feature floor "
            f"{floor_step * 1e3:.2f} us/step x {loop_steps} steps = "
            f"{floor_step * loop_steps:.4f} ms; one cooperative launch of "
            f"{plan.ctas} CTAs x {decode_seq.THREADS} threads, "
            f"{plan.smem_bytes} B "
            f"shared memory each ({plan.h_cols} h-product columns, "
            f"{plan.units} hidden unit(s), h tile {plan.h_rows} rows) "
            f"[{smi}]")
        return err

    for bsz in SEQ_BATCHES:
        end_err = max(end_err, greedy_case(dec, feats64[:bsz].contiguous(),
                                           f"B={bsz}"))
    # mdepth-soft's features: f32 at D=2080, twice bf16's bytes at D=2048
    dec_c = AttentionDecoder(VOCAB, A, E, D_CONCAT, H, device=dev)
    dec_c.reset_parameters(torch.Generator().manual_seed(3))
    feats_c = torch.from_numpy(np.abs(rng.standard_normal((B, K, D_CONCAT)))
                               .astype(np.float32)).to(dev)
    end_err = max(end_err, greedy_case(dec_c, feats_c,
                                       f"B={B} D={D_CONCAT} f32"))
    del feats_c
    dec_o = AttentionDecoder(VOCAB, *ODD_AEDH, device=dev)
    dec_o.reset_parameters(torch.Generator().manual_seed(4))
    feats_o = torch.from_numpy(np.abs(rng.standard_normal((B, K, ODD_D)))
                               .astype(np.float32)).to(dev, torch.bfloat16)
    end_err = max(end_err, greedy_case(dec_o, feats_o,
                                       f"B={B} {ODD_LABEL}"))
    main = by_shape[f"B={B}"]
    return {"name": "decode_seq", "route": "cuda", "source": SEQ_SRC,
            "replaces": SEQ_TPU, "max_abs_err": end_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "token_agreement": main["token_agreement"],
            "ms_by_shape": by_shape}


def phase_main_path(smi):
    import torch
    from depth_image_captioning_pub_torch.cli import (
        SPECIAL, placeholder_vocab)
    from depth_image_captioning_pub_torch.engine.evaluate import (
        make_caption_fn)
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.ops.attention import (
        project_features)
    from depth_image_captioning_pub_torch.ops.image_ops import (
        imagenet_normalize, to_unit_float)
    from depth_image_captioning_pub_torch.ops.kernels import decode_seq
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

    outputs, launches = run_requests(pipe, requests, smi, "main")
    chunks = sum(-(-len(r) // pipe.batch_size) for r in requests)
    want = dict.fromkeys(launches, 0)
    want["decode_seq"] = chunks
    if launches != want:
        raise RuntimeError(f"base-soft launches {launches}, expected {want} "
                           f"for {chunks} chunks")

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
    log("main", f"launches {launches} for {chunks} chunks; plain calls 0")

    # time split of one chunk at each bucket, each stage timed alone
    start_id, end_id = w2i[SPECIAL.start], w2i[SPECIAL.end]
    program = make_caption_fn(cap, start_id, MAX_LEN, end_id=end_id)
    with torch.inference_mode():
        for bsz in (1, 16, 64):
            ev = Events()
            x = torch.from_numpy(images[:bsz]).to(dev)
            f = ev.ms("encoder", lambda: cap.encoder(
                imagenet_normalize(to_unit_float(x))))

            def setup():
                proj = project_features(dec.att_params(), f,
                                        compute_dtype=torch.float32)
                return proj, dec.init_state(f), dec.seq_weights()

            proj, state, w = ev.ms("decoder set-up", setup)
            ev.ms("greedy decode (K2)", lambda: decode_seq.fused_greedy_decode(
                f, proj, state.h, state.c, w, max_length=MAX_LEN,
                start_id=start_id, end_id=end_id))
            ev.ms("caption program", lambda: program(x))
            log("main", f"{bsz}-image chunk split (device ms, each stage "
                "timed alone): " + ", ".join(
                    f"{k} {v:.2f}" for k, v in ev.times.items())
                + f" [{smi}]")
    return launches, cap


def bf16_ulp(x):
    """One bf16 ulp at max|x| (8 significant bits)."""
    import math
    m = float(x.abs().max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def ptxas_report(kernel, typed=False):
    """{template arguments: "registers, spills"} of the build's instances of
    ``kernel``, from ptxas' -v lines in the build log; ``typed`` puts the
    feature type (bf16 or f32) before the integer arguments."""
    import re
    from depth_image_captioning_pub_torch.ops.kernels import _build
    report, name = {}, None
    for line in _build.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
        elif name and ("registers" in line or "spill" in line):
            args = ",".join(re.findall(r"Li(\d+)E", name)) or name
            if typed:
                args = ("bf16 " if "bfloat16" in name else "f32 ") + args
            report.setdefault(args, []).append(line.split(":")[-1].strip())
    return {args: "; ".join(lines) for args, lines in report.items()}


def attention_case(q, k, v, n_valid, iters=10):
    """K5 vs its plain version on q/k/v: (max abs err, mean abs err, tol,
    kernel ms, plain ms); raises on non-finite output or err > tol."""
    import torch
    from depth_image_captioning_pub_torch.ops.kernels import vit_attention
    scale = q.shape[-1] ** -0.5

    def run(fn):
        return fn(q, k, v, scale=scale, n_valid=n_valid)

    got = run(vit_attention.fused_attention)
    torch.cuda.synchronize()
    want = run(vit_attention.fused_attention_plain)
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("vit_attention kernel produced non-finite values")
    diff = (got.float() - want.float()).abs()
    tol = bf16_ulp(v)
    err, mean = diff.max().item(), diff.mean().item()
    if err > tol:
        raise RuntimeError(f"vit_attention {tuple(q.shape)} n_valid="
                           f"{n_valid}: max abs err {err} > {tol}")
    ms = cuda_ms(lambda: run(vit_attention.fused_attention), iters)
    plain_ms = cuda_ms(lambda: run(vit_attention.fused_attention_plain),
                       iters)
    return err, mean, tol, ms, plain_ms


def phase_vit(smi):
    import torch
    import torch.nn.functional as F
    from depth_image_captioning_pub_torch.ops.kernels import vit_attention
    dev = torch.device("cuda")
    for args, line in ptxas_report("attention_bf16_kernel").items():
        log("vit_attention", f"ptxas bf16 route, d={args}: {line}")
    rng = np.random.default_rng(6)

    def qkv(z, n, d):
        return [torch.from_numpy(rng.standard_normal((z, n, d)).astype(
            np.float32)).to(dev, torch.bfloat16) for _ in range(3)]

    q, k, v = qkv(VIT_Z, VIT_N + 7, VIT_D)
    scale = VIT_D ** -0.5
    worst = 0.0
    timed = {}
    for n, n_valid in ((VIT_N, VIT_N), (VIT_N + 7, VIT_N)):
        args = [t[:, :n].contiguous() for t in (q, k, v)]
        err, mean, tol, ms, plain_ms = attention_case(*args, n_valid)
        timed[n] = (ms, plain_ms)
        worst = max(worst, err)
        log("vit_attention", f"Z={VIT_Z} N={n} n_valid={n_valid} d={VIT_D} "
            f"bf16: max abs err {err:.3e}, mean {mean:.3e} (tol {tol:.3e}, "
            f"one bf16 ulp of max|v|); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms [{smi}]")
    ms, plain_ms = timed[VIT_N]
    by_shape = {}
    for z, d in VIT_MORE:
        err, mean, tol, k_ms, p_ms = attention_case(*qkv(z, VIT_N, d), VIT_N)
        worst = max(worst, err)
        by_shape[f"Z={z} N={VIT_N} d={d}"] = {
            "ms": k_ms, "plain_ms": p_ms, "max_abs_err": err}
        log("vit_attention", f"Z={z} N={VIT_N} d={d} bf16: max abs err "
            f"{err:.3e}, mean {mean:.3e} (tol {tol:.3e}); kernel {k_ms:.4f} "
            f"ms, plain {p_ms:.3f} ms [{smi}]")

    # yardstick: one PyTorch call for the same function, keys < n_valid
    n, n_valid = VIT_N + 7, VIT_N
    bsz, heads = VIT_Z // 12, 12

    q4, k4, v4 = (t[:, :rows].reshape(bsz, heads, rows, VIT_D).contiguous()
                  for t, rows in ((q, n), (k, n_valid), (v, n_valid)))

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, scale=scale)

    args = [t[:, :n].contiguous() for t in (q, k, v)]
    want = vit_attention.fused_attention_plain(*args, scale=scale,
                                               n_valid=n_valid)
    sdpa_err = (sdpa().reshape(VIT_Z, n, VIT_D).float()
                - want.float()).abs().max().item()
    sdpa_ms = cuda_ms(sdpa, 10)
    z_rows = VIT_Z * VIT_N
    bound_ms, bound_by = bound(4 * z_rows * VIT_D * 2,
                               4 * z_rows * VIT_N * VIT_D, BF16_FLOPS)
    log("vit_attention", f"F.scaled_dot_product_attention on q [B={bsz}, 12, "
        f"{n}, {VIT_D}] and k/v sliced to n_valid={n_valid}: {sdpa_ms:.4f} "
        f"ms, max abs err {sdpa_err:.3e} against the plain version; K5 at "
        f"N={VIT_N} {ms:.4f} ms, {ms / sdpa_ms:.2f}x SDPA, bound "
        f"{bound_ms:.4f} ms ({bound_by}) [{smi}]")
    return {"name": "vit_attention", "route": "cuda", "source": VIT_SRC,
            "replaces": VIT_TPU, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": sdpa_ms, "sdpa_ms": sdpa_ms,
            "sdpa_max_abs_err": sdpa_err, "ms_by_shape": by_shape}


class Events:
    """Device time of named stages, each timed on its own after a
    warm-up: ``ms(name, fn)`` returns fn's result and records its mean
    time over ``iters`` runs."""

    def __init__(self, iters=3):
        self.iters, self.times = iters, {}

    def ms(self, name, fn):
        import torch
        out = fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(self.iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        self.times[name] = start.elapsed_time(stop) / self.iters
        return out


def phase_depth_path(smi):
    import torch
    from depth_image_captioning_pub_torch.cli import (
        SPECIAL, placeholder_vocab)
    from depth_image_captioning_pub_torch.models import decoder as dec_mod
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.models.dpt import DPTDepthEstimator
    from depth_image_captioning_pub_torch.ops.attention import (
        project_features)
    from depth_image_captioning_pub_torch.ops.image_ops import (
        dpt_normalize, imagenet_normalize, resize_bilinear, to_unit_float)
    from depth_image_captioning_pub_torch.ops.kernels import (
        decode_seq, vit_attention)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    dev = torch.device("cuda")
    w2i, i2w = placeholder_vocab(VOCAB)
    start_id, end_id = w2i[SPECIAL.start], w2i[SPECIAL.end]
    t0 = time.perf_counter()
    cap = build_captioner("depth-soft", VOCAB, device=dev)
    cap.init(torch.Generator().manual_seed(0))
    est = DPTDepthEstimator(device=dev)
    est.init(torch.Generator().manual_seed(1))
    depth_fn = est.depth_fn()
    pipe = CaptionPipeline(cap, w2i, i2w, depth_fn=depth_fn,
                           max_length=MAX_LEN, batch_buckets=(1, 16, 64))
    n_params = sum(p.numel() for p in cap.parameters())
    n_dpt = sum(p.numel() for p in est.model.parameters())
    log("depth", f"depth-soft: ResNet-152 bf16 + DepthCNNEncoder bf16 + "
        f"decoder {n_params / 1e6:.1f}M params, DPT-hybrid bf16 at 384x384 "
        f"{n_dpt / 1e6:.1f}M params, V={VOCAB}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    images = np.random.default_rng(1).integers(
        0, 256, (81, 224, 224, 3), dtype=np.uint8)
    requests = [images[:1], images[1:17], images[17:81]]
    for size in (1, 16, 64):          # warm-up: one call per bucket
        pipe.caption_tokens(images[:size])

    plains = {mod: mod.__dict__[name] for mod, name in (
        (vit_attention, "fused_attention_plain"),
        (decode_seq, "fused_greedy_decode_plain"))}
    outputs, launches = run_requests(pipe, requests, smi, "depth")
    chunks = sum(-(-len(r) // pipe.batch_size) for r in requests)
    want = dict.fromkeys(launches, 0)
    want.update(decode_seq=chunks,
                vit_attention=len(est.model.blocks) * chunks)
    if launches != want:
        raise RuntimeError(f"depth-soft launches {launches}, expected "
                           f"{want} for {chunks} chunks")
    log("depth", f"launches {launches} for {chunks} chunks; plain calls 0")

    # the 16-image request again, stage by stage, with the kernels and
    # then with the plain versions of the attention and the decode
    def stages(x):
        x = to_unit_float(x)
        feats = cap.encoder(imagenet_normalize(x))
        depth = depth_fn(x)
        dfeats = cap.depth_module(depth)
        toks = cap.decoder.greedy_sample(feats, start_id, dfeats,
                                         max_length=MAX_LEN, end_id=end_id)
        return depth, dfeats, cap.decoder.fuse(feats, dfeats), toks

    def attention_plain(q, k, v, *, scale, n_valid):
        return plains[vit_attention](q, k, v, scale=scale, n_valid=n_valid)

    x16 = torch.from_numpy(requests[1]).to(dev)
    with torch.inference_mode():
        got = stages(x16)
        kernel_attention = vit_attention.fused_attention
        vit_attention.fused_attention = attention_plain
        dec_mod.fused_greedy_decode = plains[decode_seq]
        try:
            ref = stages(x16)
        finally:
            vit_attention.fused_attention = kernel_attention
            dec_mod.fused_greedy_decode = decode_seq.fused_greedy_decode
    depth = got[0]
    if not bool(torch.isfinite(depth).all()):
        raise RuntimeError("depth maps are not finite")
    lo, hi = depth.min().item(), depth.max().item()
    if lo < 0.0 or hi > 1.0:
        raise RuntimeError(f"depth maps outside [0, 1]: [{lo}, {hi}]")
    repeat = float((got[3].cpu().numpy() == outputs[1]).mean())
    errs = {name: (a.float() - b.float()).abs().max().item()
            for name, a, b in zip(("depth map", "depth features",
                                   "fused features"), got[:3], ref[:3])}
    agree = float((ref[3].cpu().numpy() == outputs[1]).mean())
    log("depth", f"depth maps {tuple(depth.shape)} {depth.dtype} in "
        f"[{lo:.4f}, {hi:.4f}], std {depth.float().std().item():.4f}")
    log("depth", "kernels vs plain attention+decode on the 16-image "
        "request: max abs err " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items())
        + f"; token agreement {agree:.4f} (min {MIN_AGREEMENT}); the "
        f"stage-by-stage kernel run repeats the pipeline's tokens on "
        f"{repeat:.4f}")
    for c in pipe(list(requests[1][:3])):
        log("depth", f"caption: {c!r}")
    if agree < MIN_AGREEMENT:
        raise RuntimeError(f"depth-soft kernels vs plain agreement {agree}")

    # time split of one 64-image chunk
    ev = Events()
    with torch.inference_mode():
        x = to_unit_float(torch.from_numpy(requests[2]).to(dev))
        feats = ev.ms("rgb encoder", lambda: cap.encoder(
            imagenet_normalize(x)))
        depth = ev.ms("dpt", lambda: depth_fn(x))
        x_dpt = dpt_normalize(resize_bilinear(x, (est.image_size,) * 2))
        ev.ms("dpt: resnet stages", lambda: est.model.resnet(
            x_dpt.to(est.model.dtype)))
        # the ViT blocks and their attention alone, on tokens of the DPT's
        # shape: [64, 577, 768], Z = 64 * 12 heads of width 64
        blocks = [getattr(est.model, name) for name in est.model.blocks]
        dim, heads = blocks[0].qkv.in_features, blocks[0].heads
        n_tok = 1 + (est.image_size // est.model.patch) ** 2
        tokens = torch.zeros(x.shape[0], n_tok, dim, device=dev,
                             dtype=torch.bfloat16).normal_()

        def vit():
            t = tokens
            for blk in blocks:
                t = blk(t)
            return t

        ev.ms("dpt: vit blocks", vit)
        qkv = torch.zeros(3, x.shape[0] * heads, n_tok, dim // heads,
                          device=dev, dtype=torch.bfloat16).normal_()
        ev.ms("dpt: vit attention (K5)", lambda: [
            vit_attention.fused_attention(
                *qkv, scale=(dim // heads) ** -0.5, n_valid=n_tok)
            for _ in blocks])
        dfeats = ev.ms("depth encoder", lambda: cap.depth_module(depth))
        dec = cap.decoder

        def setup():
            f = dec.fuse(feats, dfeats)
            proj = project_features(dec.att_params(), f,
                                    compute_dtype=torch.float32)
            return f, proj, dec.init_state(f), dec.seq_weights()

        f, proj, state, w = ev.ms("decoder set-up", setup)
        ev.ms("greedy decode (K2)", lambda: decode_seq.fused_greedy_decode(
            f.contiguous(), proj, state.h, state.c, w, max_length=MAX_LEN,
            start_id=start_id, end_id=end_id))
    total = sum(v for k, v in ev.times.items() if ":" not in k)
    k5 = ev.times["dpt: vit attention (K5)"]
    log("depth", "64-image chunk split (device ms, each stage timed alone): "
        + ", ".join(f"{k} {v:.2f}" for k, v in ev.times.items())
        + f"; sum of stages {total:.2f}; K5 {k5:.2f} ms = "
        f"{100 * k5 / total:.1f}% of the stages, "
        f"{100 * k5 / ev.times['dpt']:.1f}% of the DPT [{smi}]")
    return launches, est


def phase_nic_kernel(smi):
    """K3 at B = 1, 16 and 64 (the main path's chunk sizes) against its
    plain version: token agreement, exact with one token forced,
    bit-identical repeats, times, the bound and the launch's plan."""
    import torch
    from depth_image_captioning_pub_torch.models.nic import NICDecoder
    from depth_image_captioning_pub_torch.ops.kernels import nic_seq
    dev = torch.device("cuda")
    dec = NICDecoder(VOCAB, dim_embedding=NIC_E, dim_hidden=H,
                     num_layers=NIC_LAYERS, device=dev)
    dec.reset_parameters(torch.Generator().manual_seed(8))
    x64 = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, NIC_E)).astype(np.float32)).to(dev)
    for line in ptxas_report("nic_greedy_kernel").values():
        log("nic_seq", f"ptxas: {line}")
    layer_macs = sum((NIC_E if li == 0 else H) * 4 * H + H * 4 * H
                     for li in range(NIC_LAYERS))
    by_shape, tok_err = {}, 0.0
    for bsz in SEQ_BATCHES:
        x0 = x64[:bsz].contiguous()
        with torch.inference_mode():
            w = dec.seq_weights()

            def run(fn, weights):
                return fn(x0, weights, max_length=MAX_LEN)

            got = run(nic_seq.fused_nic_greedy_decode, w)
            torch.cuda.synchronize()
            plan = nic_seq.LAST_PLAN      # the plan of that launch
            again = run(nic_seq.fused_nic_greedy_decode, w)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise RuntimeError(f"two NIC kernel calls differ at B={bsz}")
            want = run(nic_seq.fused_nic_greedy_decode_plain, w)
            agree = (got == want).float().mean().item()
            distinct = len({tuple(r) for r in got.tolist()})
            if agree < MIN_AGREEMENT:
                raise RuntimeError(f"NIC token agreement {agree} < "
                                   f"{MIN_AGREEMENT} at B={bsz}")
            ms = cuda_ms(lambda: run(nic_seq.fused_nic_greedy_decode, w), 10)
            plain_ms = cuda_ms(
                lambda: run(nic_seq.fused_nic_greedy_decode_plain, w), 10)
            b_out = w.b_out.clone()
            b_out[0, 7] += 100.0
            w_tok = w._replace(b_out=b_out)
            got_tok = run(nic_seq.fused_nic_greedy_decode, w_tok)
            torch.cuda.synchronize()
            want_tok = run(nic_seq.fused_nic_greedy_decode_plain, w_tok)
            err = (got_tok - want_tok).abs().max().item()
            tok_err = max(tok_err, err)
            if err != 0 or not bool((got_tok == 7).all()):
                raise RuntimeError(f"NIC kernel with one token forced "
                                   f"differs from the plain version at "
                                   f"B={bsz}")
        rows = bsz * MAX_LEN
        bound_ms, bound_by = bound(
            nbytes(x0, *w.layer_mats, w.w_out, w.b_out, got)
            + rows * NIC_E * 4, rows * 2 * (layer_macs + H * VOCAB),
            F32_FLOPS)
        by_shape[f"B={bsz}"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "token_agreement": agree}
        log("nic_seq", f"B={bsz} E={NIC_E} H={H} layers={NIC_LAYERS} "
            f"V={VOCAB} L={MAX_LEN}: token agreement {agree:.4f} (min "
            f"{MIN_AGREEMENT}), {distinct} distinct rows; one-token-forced "
            f"run exact; two calls bit-identical; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); one "
            f"cooperative launch of {plan.ctas} CTAs x {nic_seq.THREADS} "
            f"threads, {plan.smem_bytes} B shared memory each "
            f"({plan.h_cols} head columns, {plan.units} hidden unit(s) per "
            f"layer, h tile {plan.h_rows} rows) [{smi}]")
    main = by_shape[f"B={B}"]
    log("nic_seq", f"source {NIC_SRC}, replaces {NIC_TPU}")
    return {"name": "nic_seq", "route": "cuda", "source": NIC_SRC,
            "replaces": NIC_TPU, "max_abs_err": tok_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "token_agreement": main["token_agreement"],
            "ms_by_shape": by_shape}


def phase_nic_path(smi):
    import torch
    from depth_image_captioning_pub_torch.cli import placeholder_vocab
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.ops.image_ops import (
        imagenet_normalize, to_unit_float)
    from depth_image_captioning_pub_torch.ops.kernels import nic_seq
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    dev = torch.device("cuda")
    w2i, i2w = placeholder_vocab(VOCAB)
    t0 = time.perf_counter()
    cap = build_captioner("nic", VOCAB, device=dev)
    cap.init(torch.Generator().manual_seed(9))
    pipe = CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                           batch_buckets=(1, 16, 64))
    log("nic", f"nic: ResNet-152 bf16 + Linear 2048->{NIC_E} + "
        f"{NIC_LAYERS}-layer LSTM, V={VOCAB}, "
        f"{sum(p.numel() for p in cap.parameters()) / 1e6:.1f}M params, "
        f"built in {time.perf_counter() - t0:.1f} s")
    images = np.random.default_rng(9).integers(
        0, 256, (117, 224, 224, 3), dtype=np.uint8)
    requests = [images[:1], images[1:17], images[17:117]]
    for size in (1, 16, 64):          # warm-up: one call per bucket
        pipe.caption_tokens(images[:size])
    outputs, launches = run_requests(pipe, requests, smi, "nic")
    chunks = sum(-(-len(r) // pipe.batch_size) for r in requests)
    want = dict.fromkeys(launches, 0)
    want["nic_seq"] = chunks
    if launches != want:
        raise RuntimeError(f"nic launches {launches}, expected {want} for "
                           f"{chunks} chunks")
    with torch.inference_mode():
        x = torch.from_numpy(requests[1]).to(dev)
        feats = cap.encoder_apply()(imagenet_normalize(to_unit_float(x)))
        if not bool(torch.isfinite(feats).all()):
            raise RuntimeError("NIC image embeddings are not finite")
        ref = nic_seq.fused_nic_greedy_decode_plain(
            feats.float(), cap.decoder.seq_weights(),
            max_length=MAX_LEN).cpu().numpy()
    agree = float((ref == outputs[1]).mean())
    if agree < MIN_AGREEMENT:
        raise RuntimeError(f"nic path vs plain decode agreement {agree}")
    log("nic", f"16-image request vs plain decode on the same embeddings: "
        f"token agreement {agree:.4f}; embeddings {tuple(feats.shape)} "
        f"{feats.dtype}, |x| max {feats.abs().max().item():.3e}")
    for c in pipe(list(requests[1][:2])):
        log("nic", f"caption: {c!r}")
    log("nic", f"launches {launches} for {chunks} chunks; plain calls 0")
    return launches


def beam_steps(out, end_id):
    """Steps each image's search ran: up to the one after which all its
    beams had finished (the kernel's exit), replayed from the records."""
    tok = out.tokens.cpu().numpy()
    par = out.parents.cpu().numpy().astype(np.int64)
    bsz, _, length = tok.shape
    fin = np.zeros(tok.shape[:2], bool)
    steps = np.full(bsz, length)
    done = np.zeros(bsz, bool)
    for t in range(length):
        fin = np.take_along_axis(fin, par[:, :, t], 1) | (tok[:, :, t]
                                                          == end_id)
        newly = fin.all(1) & ~done
        steps[newly] = t + 1
        done |= newly
    return steps


def phase_beam_kernel(smi):
    """K4 at B = 1, 16 and 64 images (W=5) against its plain version:
    best-token and record agreement, scores, exact with <end> forced and
    with every token tied (at B=64), times, the bound, the per-step feature
    floor and the launch's plan; and K4 at W=2..5 at B=64."""
    import torch
    from depth_image_captioning_pub_torch.cli import (
        SPECIAL, placeholder_vocab)
    from depth_image_captioning_pub_torch.models.decoder import (
        AttentionDecoder)
    from depth_image_captioning_pub_torch.ops.attention import (
        project_features)
    from depth_image_captioning_pub_torch.ops.kernels import beam_seq
    dev = torch.device("cuda")
    w2i, _ = placeholder_vocab(VOCAB)
    start_id, end_id = w2i[SPECIAL.start], w2i[SPECIAL.end]
    dec = AttentionDecoder(VOCAB, A, E, D, H, device=dev)
    dec.reset_parameters(torch.Generator().manual_seed(10))
    rng = np.random.default_rng(10)
    feats64 = torch.from_numpy(np.abs(rng.standard_normal((B, K, D)))
                               .astype(np.float32)).to(dev, torch.bfloat16)
    for args, line in ptxas_report("beam_kernel", typed=True).items():
        kind, beam = args.split()
        log("beam_seq", f"ptxas, {kind} features, W={beam}: {line}")
    by_shape, exact = {}, {}
    for bsz in SEQ_BATCHES:
        feats = feats64[:bsz].contiguous()
        with torch.inference_mode():
            proj = project_features(dec.att_params(), feats,
                                    compute_dtype=torch.float32)
            state = dec.init_state(feats)
            w = dec.seq_weights()

            def run(fn, weights, beam=BEAM):
                return fn(feats, proj, state.h, state.c, weights,
                          beam_size=beam, max_length=MAX_LEN,
                          start_id=start_id, end_id=end_id)

            got = run(beam_seq.fused_beam_decode, w)
            torch.cuda.synchronize()
            plan = beam_seq.LAST_PLAN      # the plan of that launch
            want = run(beam_seq.fused_beam_decode_plain, w)
            best_got = beam_seq.select_best(got, end_id)[0]
            best_want = beam_seq.select_best(want, end_id)[0]
            agree = (best_got == best_want).float().mean().item()
            rec_agree = min(
                (got.tokens == want.tokens).float().mean().item(),
                (got.parents == want.parents).float().mean().item())
            err = (got.scores - want.scores).abs().max().item()
            if min(agree, rec_agree) < MIN_AGREEMENT:
                raise RuntimeError(f"beam best-token agreement {agree}, "
                                   f"record agreement {rec_agree} < "
                                   f"{MIN_AGREEMENT} at B={bsz}")
            if not err <= SCORE_ATOL:
                raise RuntimeError(f"beam scores max abs err {err} > "
                                   f"{SCORE_ATOL} at B={bsz}")
            ms = cuda_ms(lambda: run(beam_seq.fused_beam_decode, w), 10)
            plain_ms = cuda_ms(
                lambda: run(beam_seq.fused_beam_decode_plain, w), 3)
            if bsz == B:
                # every beam width the kernel has an instance for
                ms_by_beam = {
                    bw: cuda_ms(lambda bw=bw: run(
                        beam_seq.fused_beam_decode, w, bw), 10)
                    for bw in range(2, BEAM + 1)}
                for case in ("<end> forced", "all ties"):
                    if case == "<end> forced":
                        b_out = w.b_out.clone()
                        b_out[0, end_id] += 100.0
                        w_case = w._replace(b_out=b_out)
                    else:
                        w_case = w._replace(
                            w_out=torch.zeros_like(w.w_out),
                            b_out=torch.zeros_like(w.b_out))
                    g = run(beam_seq.fused_beam_decode, w_case)
                    torch.cuda.synchronize()
                    x = run(beam_seq.fused_beam_decode_plain, w_case)
                    if not (torch.equal(g.tokens, x.tokens)
                            and torch.equal(g.parents, x.parents)):
                        raise RuntimeError(f"beam kernel differs from the "
                                           f"plain version with {case}")
                    exact[case] = (g.scores - x.scores).abs().max().item()
                    if not exact[case] <= SCORE_ATOL:
                        raise RuntimeError(
                            f"beam scores with {case}: max abs err "
                            f"{exact[case]} > {SCORE_ATOL}")
        steps = beam_steps(got, end_id)
        beam_rows = int(steps.sum()) * BEAM
        bound_ms, bound_by = bound(
            nbytes(feats, proj, state.h, state.c, *w.step, w.w_out, w.b_out,
                   *got) + beam_rows * E * 4,
            beam_rows * (step_flops(K, D, A, E, H) + 2 * H * VOCAB),
            F32_FLOPS)
        # the kernel reads the features again every step (once for the W
        # beams of an image): that stream alone, per step and over the
        # steps run
        floor_step = nbytes(feats) / HBM_BYTES_PER_S * 1e3
        by_shape[f"B={bsz}"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "token_agreement": agree,
            "record_agreement": rec_agree, "max_abs_err": err}
        log("beam_seq", f"B={bsz} W={BEAM} V={VOCAB} L={MAX_LEN} end_id="
            f"{end_id}: best-token agreement {agree:.4f}, record (token and "
            f"parent) agreement {rec_agree:.4f} (min {MIN_AGREEMENT}), "
            f"scores max abs err {err:.3e} (max {SCORE_ATOL}); steps per "
            f"image {steps.min()}-{steps.max()}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"feature floor {floor_step * 1e3:.2f} us/step x {steps.max()} "
            f"steps = {floor_step * steps.max():.4f} ms; one cooperative "
            f"launch of {plan.ctas} CTAs x {beam_seq.THREADS} threads, "
            f"{plan.smem_bytes} B shared memory each ({plan.h_cols} "
            f"h-product columns, {plan.units} hidden unit(s), h tile "
            f"{plan.h_rows} rows, {plan.rows} beam rows) [{smi}]")

    def beam_case(dec, feats, beam, label, forced=False):
        """K4 against its plain version on one decoder and feature set:
        exact records with <end> forced, else agreement; times and the
        bound."""
        bsz, k, d = feats.shape
        h, a = dec.att_w_dec.shape
        e = dec.dim_embedding
        with torch.inference_mode():
            proj = project_features(dec.att_params(), feats,
                                    compute_dtype=torch.float32)
            state = dec.init_state(feats)
            w = dec.seq_weights()
            if forced:
                b_out = w.b_out.clone()
                b_out[0, end_id] += 100.0
                w = w._replace(b_out=b_out)

            def run(fn):
                return fn(feats, proj, state.h, state.c, w, beam_size=beam,
                          max_length=MAX_LEN, start_id=start_id,
                          end_id=end_id)

            got = run(beam_seq.fused_beam_decode)
            torch.cuda.synchronize()
            plan = beam_seq.LAST_PLAN
            want = run(beam_seq.fused_beam_decode_plain)
            err = (got.scores - want.scores).abs().max().item()
            if forced:
                agree = rec_agree = float(
                    torch.equal(got.tokens, want.tokens)
                    and torch.equal(got.parents, want.parents))
                if agree != 1.0:
                    raise RuntimeError(f"beam kernel with <end> forced "
                                       f"differs from the plain version at "
                                       f"{label}")
            else:
                agree = (beam_seq.select_best(got, end_id)[0]
                         == beam_seq.select_best(want, end_id)[0]
                         ).float().mean().item()
                rec_agree = min(
                    (got.tokens == want.tokens).float().mean().item(),
                    (got.parents == want.parents).float().mean().item())
            if min(agree, rec_agree) < MIN_AGREEMENT or not err <= SCORE_ATOL:
                raise RuntimeError(f"beam kernel at {label}: best-token "
                                   f"agreement {agree}, record agreement "
                                   f"{rec_agree}, scores err {err}")
            ms = cuda_ms(lambda: run(beam_seq.fused_beam_decode), 10)
            plain_ms = cuda_ms(lambda: run(beam_seq.fused_beam_decode_plain),
                               3)
        beam_rows = int(beam_steps(got, end_id).sum()) * beam
        bound_ms, bound_by = bound(
            nbytes(feats, proj, state.h, state.c, *w.step, w.w_out, w.b_out,
                   *got) + beam_rows * e * 4,
            beam_rows * (step_flops(k, d, a, e, h) + 2 * h * VOCAB),
            F32_FLOPS)
        by_shape[label] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "token_agreement": agree,
            "record_agreement": rec_agree, "max_abs_err": err}
        log("beam_seq", f"{label} W={beam} K={k} D={d} A={a} E={e} H={h} "
            f"{feats.dtype}{' <end> forced' if forced else ''}: best-token "
            f"agreement {agree:.4f}, record agreement {rec_agree:.4f}, "
            f"scores max abs err {err:.3e}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"{plan.ctas} CTAs, {plan.smem_bytes} B shared memory, h tile "
            f"{plan.h_rows} rows, {plan.rows} beam rows [{smi}]")
        return ms

    # the wider instances at the main shape, mdepth's f32 features at
    # D=2080 and an odd width (zero-padded for the launch), at B=64
    for bw in beam_seq.BEAM_SIZES[BEAM - 1:]:
        ms_by_beam[bw] = beam_case(dec, feats64, bw, f"B={B} W={bw}")
    dec_c = AttentionDecoder(VOCAB, A, E, D_CONCAT, H, device=dev)
    dec_c.reset_parameters(torch.Generator().manual_seed(11))
    feats_c = torch.from_numpy(np.abs(rng.standard_normal((B, K, D_CONCAT)))
                               .astype(np.float32)).to(dev)
    beam_case(dec_c, feats_c, BEAM, f"B={B} D={D_CONCAT} f32")
    del feats_c
    dec_o = AttentionDecoder(VOCAB, *ODD_AEDH, device=dev)
    dec_o.reset_parameters(torch.Generator().manual_seed(12))
    feats_o = torch.from_numpy(np.abs(rng.standard_normal((B, K, ODD_D)))
                               .astype(np.float32)).to(dev, torch.bfloat16)
    beam_case(dec_o, feats_o, BEAM, f"B={B} {ODD_LABEL}")
    beam_case(dec_o, feats_o, BEAM, f"B={B} {ODD_LABEL} <end> forced",
              forced=True)
    main = by_shape[f"B={B}"]
    log("beam_seq", f"B={B}: exact tokens and parents with "
        + ", ".join(f"{k} (scores err {v:.1e})" for k, v in exact.items())
        + "; kernel by beam width " + ", ".join(
            f"W={bw} {t:.3f} ms" for bw, t in ms_by_beam.items())
        + f" [{smi}]; source {BEAM_SRC}, replaces {BEAM_TPU}")
    return {"name": "beam_seq", "route": "cuda", "source": BEAM_SRC,
            "replaces": BEAM_TPU, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "token_agreement": main["token_agreement"],
            "record_agreement": main["record_agreement"],
            "ms_by_beam": ms_by_beam, "ms_by_shape": by_shape}


def phase_beam_path(smi, cap):
    import torch
    from depth_image_captioning_pub_torch.cli import placeholder_vocab
    from depth_image_captioning_pub_torch.models import decoder as dec_mod
    from depth_image_captioning_pub_torch.ops.kernels import beam_seq
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    w2i, i2w = placeholder_vocab(VOCAB)
    pipe = CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                           batch_buckets=(1, 16, 64), beam_size=BEAM)
    images = np.random.default_rng(11).integers(
        0, 256, (81, 224, 224, 3), dtype=np.uint8)
    requests = [images[:1], images[1:17], images[17:81]]
    for size in (1, 16, 64):          # warm-up: one call per bucket
        pipe.caption_tokens(images[:size])
    outputs, launches = run_requests(pipe, requests, smi, "beam")
    chunks = sum(-(-len(r) // pipe.batch_size) for r in requests)
    want = dict.fromkeys(launches, 0)
    want["beam_seq"] = chunks
    if launches != want:
        raise RuntimeError(f"beam launches {launches}, expected {want} for "
                           f"{chunks} chunks")
    # the 16-image request again, with the search's plain version
    dec_mod.fused_beam_decode = beam_seq.fused_beam_decode_plain
    try:
        ref = pipe.caption_tokens(requests[1])
    finally:
        dec_mod.fused_beam_decode = beam_seq.fused_beam_decode
    agree = float((ref == outputs[1]).mean())
    if agree < MIN_AGREEMENT:
        raise RuntimeError(f"beam path vs plain search agreement {agree}")
    log("beam", f"16-image request vs the plain search: token agreement "
        f"{agree:.4f}")
    for c in pipe(list(requests[1][:2])):
        log("beam", f"caption: {c!r}")
    log("beam", f"launches {launches} for {chunks} chunks; plain calls 0")
    return launches


def phase_sample_path(smi, cap):
    """The base-soft captioner with nucleus sampling: requests of 1, 16
    and 64 images through the pipeline, K1's launches, the kernel loop
    against the plain step on the same noise, top_k=1 against K2, and one
    chunk's time split at each bucket."""
    import torch
    from depth_image_captioning_pub_torch.cli import (
        SPECIAL, placeholder_vocab)
    from depth_image_captioning_pub_torch.engine.evaluate import (
        make_caption_fn)
    from depth_image_captioning_pub_torch.models import decoder as dec_mod
    from depth_image_captioning_pub_torch.ops.attention import (
        project_features)
    from depth_image_captioning_pub_torch.ops.decode import (
        filtered_logits, gumbel_argmax, gumbel_noise)
    from depth_image_captioning_pub_torch.ops.image_ops import (
        imagenet_normalize, to_unit_float)
    from depth_image_captioning_pub_torch.ops.kernels import decode_step
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    dev = torch.device("cuda")
    w2i, i2w = placeholder_vocab(VOCAB)
    start_id = w2i[SPECIAL.start]
    sampling = {"temperature": 1.0, "top_k": 0, "top_p": TOP_P}
    pipe = CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                           batch_buckets=(1, 16, 64), sample=True, seed=0,
                           temperature=1.0, top_p=TOP_P)
    images = np.random.default_rng(12).integers(
        0, 256, (81, 224, 224, 3), dtype=np.uint8)
    requests = [images[:1], images[1:17], images[17:81]]
    for size in (1, 16, 64):          # warm-up: one call per bucket
        pipe.caption_tokens(images[:size])
    outputs, launches = run_requests(pipe, requests, smi, "sample")
    chunks = sum(-(-len(r) // pipe.batch_size) for r in requests)
    want = dict.fromkeys(launches, 0)
    want["decode_step"] = MAX_LEN * chunks
    if launches != want:
        raise RuntimeError(f"sampling launches {launches}, expected {want} "
                           f"for {chunks} chunks")
    distinct = len({tuple(r) for r in outputs[2].tolist()})

    # the 16-image request's features: K1's loop against the plain step's
    # on the same noise; top_k=1 against K2's greedy tokens
    dec = cap.decoder
    with torch.inference_mode():
        x = torch.from_numpy(requests[1]).to(dev)
        feats = cap.encoder(imagenet_normalize(to_unit_float(x)))
        gen = torch.Generator(device=dev).manual_seed(12)
        noise = [gumbel_noise((len(x), VOCAB), gen) for _ in range(MAX_LEN)]
        kw = dict(sampling, max_length=MAX_LEN, noise=lambda t: noise[t])
        got, alphas = dec.stochastic_sample(feats, start_id, None, **kw)
        dec_mod.fused_decode_core = decode_step.fused_decode_core_plain
        try:
            ref, ref_alphas = dec.stochastic_sample(feats, start_id, None,
                                                    **kw)
        finally:
            dec_mod.fused_decode_core = decode_step.fused_decode_core
        top1, _ = dec.stochastic_sample(feats, start_id, gen,
                                        max_length=MAX_LEN, top_k=1)
        greedy = dec.greedy_sample(feats, start_id, max_length=MAX_LEN)
    agree = (got == ref).float().mean().item()
    # alphas agree while the rows' tokens do: compare up to a row's first
    # differing token
    same = (got == ref).int().cumprod(dim=1).bool()
    alpha_err = ((alphas - ref_alphas).abs().amax(-1) * same).max().item()
    agree1 = (top1 == greedy).float().mean().item()
    if not (bool(torch.isfinite(alphas).all())
            and (alphas.sum(-1) - 1).abs().max().item() < 1e-4):
        raise RuntimeError("sampled alphas are not softmax rows")
    log("sample", f"16-image request's features: K1 loop vs plain step on "
        f"the same noise: token agreement {agree:.4f} (min "
        f"{MIN_AGREEMENT}), alphas max abs err {alpha_err:.3e} over the "
        f"steps before a row's first differing token; top_k=1 vs K2 greedy "
        f"without <end>: {agree1:.4f}; {distinct} distinct captions of 64")
    if min(agree, agree1) < MIN_AGREEMENT:
        raise RuntimeError(f"sampling agreement {agree} / top_k=1 vs "
                           f"greedy {agree1} < {MIN_AGREEMENT}")
    for c in pipe(list(requests[1][:2])):
        log("sample", f"caption: {c!r}")
    log("sample", f"launches {launches} for {chunks} chunks; plain calls 0")

    # time split of one chunk at each bucket, each stage timed alone
    program = make_caption_fn(cap, start_id, MAX_LEN, sampling=sampling,
                              generator=gen)
    with torch.inference_mode():
        for bsz in (1, 16, 64):
            ev = Events()
            x = torch.from_numpy(images[:bsz]).to(dev)
            f = ev.ms("encoder", lambda: cap.encoder(
                imagenet_normalize(to_unit_float(x))))

            def setup():
                proj = project_features(dec.att_params(), f,
                                        compute_dtype=torch.float32)
                return proj, dec.init_state(f), dec.seq_weights()

            proj, state, w = ev.ms("decoder set-up", setup)
            emb = w.embed[torch.full((bsz,), start_id, device=dev)]
            ev.ms(f"K1 x{MAX_LEN}", lambda: [decode_step.fused_decode_core(
                f, proj, emb, state.h, state.c, w.step)
                for _ in range(MAX_LEN)])

            def head():
                tok = gumbel_argmax(filtered_logits(
                    state.h @ w.w_out + w.b_out, **sampling),
                    gumbel_noise((bsz, VOCAB), gen))
                return w.embed[tok.long()]

            ev.ms(f"head + filter + draw + embedding x{MAX_LEN}",
                  lambda: [head() for _ in range(MAX_LEN)])
            ev.ms("caption program", lambda: program(x))
            log("sample", f"{bsz}-image chunk split (device ms, each stage "
                "timed alone): " + ", ".join(
                    f"{k} {v:.2f}" for k, v in ev.times.items())
                + f" [{smi}]")
    return launches


class ScoreImages:
    """An in-memory evaluation set: seeded uint8 images and five
    references each, drawn from the placeholder vocabulary's words (the
    card's machine has no Pillow to read JPEGs)."""

    def __init__(self, n, words, seed):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
        self.refs = [[" ".join(rng.choice(words, rng.integers(5, 15)))
                      for _ in range(5)] for _ in range(n)]

    def __len__(self):
        return len(self.images)

    def load_image(self, i):
        return self.images[i]

    def captions(self, i):
        return self.refs[i]


class SetTimes:
    """Wraps the stages that ``engine/evaluate.evaluate`` calls per set to
    time them (host clock; captioning ends with the tokens on the host)
    and to check each loaded captioner against the written weights."""

    def __init__(self, ev, cap, expected):
        self.ev, self.cap, self.expected = ev, cap, expected
        self.rows, self.hypos, self.saved = [], [], {}

    def __enter__(self):
        import torch
        ev = self.ev
        for name in ("params_from_jax", "generate_captions", "score",
                     "load_textfiles"):
            self.saved[name] = getattr(ev, name)

        def loaded(cap, trainable, frozen, stats):
            t0 = time.perf_counter()
            self.saved["params_from_jax"](cap, trainable, frozen, stats)
            torch.cuda.synchronize()
            self.rows[-1]["copy"] = time.perf_counter() - t0
            want = self.expected[len(self.rows)]
            for name, t in cap.state_dict().items():
                if not torch.equal(t, want[name]):
                    raise RuntimeError(f"set {len(self.rows)}: {name} "
                                       f"differs from the written weights")

        def timed(key, fn):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.rows[-1][key] = time.perf_counter() - t0
                return out
            return run

        def texts(refs, hypos):
            self.hypos.append(list(hypos))
            return self.saved["load_textfiles"](refs, hypos)

        ev.params_from_jax = loaded
        ev.generate_captions = timed("caption", self.saved[
            "generate_captions"])
        ev.score = timed("score", self.saved["score"])
        ev.load_textfiles = texts
        return self

    def loader(self, fn):
        """The checkpoint loader, timed: each call starts a set's row."""
        def load(set_idx):
            self.rows.append({})
            t0 = time.perf_counter()
            out = fn(set_idx)
            self.rows[-1]["read"] = time.perf_counter() - t0
            return out
        return load

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ev, name, fn)


def phase_score_path(smi, cap):
    """Scored evaluation of three base-soft checkpoint sets written in the
    JAX trainer's files, then set 1 with beam search."""
    import pickle
    import tempfile
    from pathlib import Path

    import torch
    from depth_image_captioning_pub_torch import cli
    from depth_image_captioning_pub_torch.config import ConfigEval
    from depth_image_captioning_pub_torch.engine import evaluate as ev
    from depth_image_captioning_pub_torch.models.decoder import (
        AttentionDecoder)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    from depth_image_captioning_pub_torch.utils.checkpoint import (
        save_component)
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        params_to_jax)
    w2i, i2w = cli.placeholder_vocab(VOCAB)
    data = ScoreImages(SCORE_IMAGES, [w for w in w2i if w.startswith("w")],
                       seed=13)
    # set 1 is phase 5's captioner: its captions through the pipeline
    pipe = CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                           batch_buckets=(SCORE_BATCH,))
    want1 = pipe(data.images)

    trainable, frozen, _ = params_to_jax(cap)
    decoders = {1: trainable["decoder"]}
    for i in range(2, SCORE_SETS + 1):
        dec = AttentionDecoder(VOCAB, device="cpu")
        dec.reset_parameters(torch.Generator().manual_seed(100 + i))
        decoders[i] = {k: v.numpy() for k, v in dec.state_dict().items()}
    state = {k: v.clone() for k, v in cap.state_dict().items()}
    expected = {}
    for i, dec in decoders.items():
        expected[i] = dict(state)
        expected[i].update({f"decoder.{k}": torch.from_numpy(v).to(
            state[f"decoder.{k}"].device) for k, v in dec.items()})
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="score_sets_") as tmp:
        cfg = ConfigEval()
        cfg.batch_size, cfg.max_length = SCORE_BATCH, MAX_LEN
        cfg.save_directory_soft = tmp
        save_dir, files = cli.eval_tables(cfg, "soft", False, False)
        t0 = time.perf_counter()
        nbytes_written = 0
        for i, dec in decoders.items():
            for name, tree in zip(files[i], (frozen["encoder"], dec)):
                path = save_component(f"{save_dir}/{name}", tree)
                nbytes_written += Path(path).stat().st_size
        log("score", f"wrote {SCORE_SETS} checkpoint sets "
            f"({nbytes_written / 1e6:.1f} MB) in "
            f"{time.perf_counter() - t0:.2f} s")

        def loader(i):
            return cli.load_eval_components(save_dir, files[i], cap)

        pkl = f"{tmp}/coco_scores.pkl"
        torch.cuda.synchronize()
        reset_counts()
        with PlainCalls() as plain, SetTimes(ev, cap, expected) as sets:
            t0 = time.perf_counter()
            scores = ev.evaluate("base-soft", "coco", cap,
                                 sets.loader(loader), data, w2i, i2w, cfg,
                                 num_sets=SCORE_SETS, scores_pickle=pkl,
                                 quiet=True)
            total = time.perf_counter() - t0
        launches = read_counts()
        with open(pkl, "rb") as f:
            pickled = pickle.load(f)
        reset_counts()
        with PlainCalls() as beam_plain, SetTimes(ev, cap, expected) as beam:
            t0 = time.perf_counter()
            beam_scores = ev.evaluate("base-soft", "coco", cap,
                                      beam.loader(loader), data, w2i, i2w,
                                      cfg, num_sets=1, beam_size=BEAM,
                                      quiet=True)
            beam_total = time.perf_counter() - t0
        beam_launches = read_counts()

    chunks = -(-SCORE_IMAGES // SCORE_BATCH)
    want = dict.fromkeys(launches, 0)
    want["decode_seq"] = chunks * SCORE_SETS
    if launches != want:
        raise RuntimeError(f"score launches {launches}, expected {want}")
    want = dict.fromkeys(beam_launches, 0)
    want["beam_seq"] = chunks
    if beam_launches != want:
        raise RuntimeError(f"score beam launches {beam_launches}, expected "
                           f"{want}")
    if plain.calls or beam_plain.calls:
        raise RuntimeError(f"plain versions ran on the score path: "
                           f"{sorted(set(plain.calls + beam_plain.calls))}")
    if sets.hypos[0] != want1:
        bad = sum(a != b for a, b in zip(sets.hypos[0], want1))
        raise RuntimeError(f"set 1's hypotheses differ from the pipeline's "
                           f"captions on {bad} of {len(want1)} images")
    if sets.hypos[0] == sets.hypos[1]:
        raise RuntimeError("sets 1 and 2 gave the same hypotheses")
    for result, n in ((scores, SCORE_SETS), (beam_scores, 1)):
        if list(result) != list(ev.METRIC_KEYS) or not all(
                len(v) == n and np.all(np.isfinite(v))
                for v in result.values()):
            raise RuntimeError(f"bad scores {result}")
    if pickled != scores:
        raise RuntimeError("the scores pickle differs from the scores")
    for i, row in enumerate(sets.rows + beam.rows, 1):
        tag = f"set {i}" if i <= SCORE_SETS else "set 1, beam 5"
        t = row["read"] + row["copy"] + row["caption"] + row["score"]
        log("score", f"{tag}: load {row['read'] + row['copy']:.3f} s (read "
            f"{row['read']:.3f}, copy to the card {row['copy']:.3f}), "
            f"caption {row['caption']:.3f} s, host scoring "
            f"{row['score']:.3f} s; {SCORE_IMAGES / t:.1f} scored images/s "
            f"[{smi}]")
    log("score", f"{SCORE_SETS} sets of {SCORE_IMAGES} images in "
        f"{total:.2f} s: {SCORE_SETS * SCORE_IMAGES / total:.1f} scored "
        f"images/s end to end; beam 5, one set: {beam_total:.2f} s, "
        f"{SCORE_IMAGES / beam_total:.1f} images/s [{smi}]")
    log("score", "means over the sets: " + ", ".join(
        f"{k} {np.mean(v):.4g}" for k, v in scores.items())
        + f"; beam 5: CIDEr {beam_scores['CIDEr'][0]:.4g}")
    log("score", f"launches {launches} and, beam, {beam_launches} for "
        f"{chunks} chunks a set; loaded weights bit-equal to the written "
        f"ones; set 1 = the pipeline's {len(want1)} captions; plain calls 0")
    return {k: launches[k] + beam_launches[k] for k in launches}


def trained_scales(dec, feats):
    """Rescale a random hard decoder to a trained model's scales on
    ``feats``: the attention vector so that the scores spread by about 1
    over the regions, and the LSTM's context rows so that the context
    weighs as much as the embedding in the gates. A random ResNet's
    features are far from unit size, and at random scales either no
    Gumbel draw moves a region or no region moves a token. Returns the two
    factors."""
    import torch
    from depth_image_captioning_pub_torch.ops.attention import (
        attention_logits, project_features)
    e = dec.dim_embedding
    with torch.inference_mode():
        proj = project_features(dec.att_params(), feats,
                                compute_dtype=torch.float32)
        h, _ = dec.init_state(feats)
        spread = attention_logits(dec.att_params(), proj, h).std(1).mean()
        att = 1.0 / spread.item()
        dec.att_w_full.mul_(att)
        dec.att_b_full.mul_(att)
        ctx = (feats.float().std() / dec.embed.std()).item()
        dec.lstm_w_ih[e:].div_(ctx)
    return att, 1.0 / ctx


def phase_hard_path(smi):
    """base-hard: requests of 1, 16 and 64 images through the pipeline (no
    kernel: hard attention runs on PyTorch ops), the seed's repeatability,
    the card against the CPU on the same noise, one-hot alphas, a beam-5
    and a sampled request, and one chunk's time split."""
    import copy

    import torch
    from depth_image_captioning_pub_torch.cli import (
        SPECIAL, placeholder_vocab)
    from depth_image_captioning_pub_torch.engine.evaluate import (
        make_caption_fn)
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.ops.decode import gumbel_noise
    from depth_image_captioning_pub_torch.ops.image_ops import (
        imagenet_normalize, to_unit_float)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    dev = torch.device("cuda")
    w2i, i2w = placeholder_vocab(VOCAB)
    start_id, end_id = w2i[SPECIAL.start], w2i[SPECIAL.end]
    t0 = time.perf_counter()
    cap = build_captioner("base-hard", VOCAB, device=dev)
    cap.init(torch.Generator().manual_seed(14))
    dec = cap.decoder
    images = np.random.default_rng(14).integers(
        0, 256, (81, 224, 224, 3), dtype=np.uint8)
    requests = [images[:1], images[1:17], images[17:81]]
    x16 = torch.from_numpy(requests[1]).to(dev)
    with torch.inference_mode():
        feats16 = cap.encoder(imagenet_normalize(to_unit_float(x16)))
    att, ctx = trained_scales(dec, feats16)
    log("hard", f"base-hard: ResNet-152 bf16 + hard-attention decoder, "
        f"V={VOCAB}, built in {time.perf_counter() - t0:.1f} s; attention "
        f"vector scaled by {att:.3e} (scores of unit spread), the LSTM's "
        f"context rows by {ctx:.3e} (context as large as the embedding); "
        f"|feat| max {feats16.abs().max().item():.3e}")

    def pipeline(**kw):
        pipe = CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                               batch_buckets=(1, 16, 64), **kw)
        for size in (1, 16, 64):          # warm-up: one call per bucket
            pipe.caption_tokens(images[:size])
        return pipe

    pipe = pipeline(seed=0)
    outputs, launches = run_requests(pipe, requests, smi, "hard")
    if any(launches.values()):
        raise RuntimeError(f"base-hard launched kernels: {launches}")
    again = [pipe.caption_tokens(r) for r in requests[1:]]
    seed1 = CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                            batch_buckets=(1, 16, 64), seed=1)
    other = np.concatenate([seed1.caption_tokens(r) for r in requests[1:]])
    first = np.concatenate(outputs[1:])
    if not np.array_equal(np.concatenate(again), first):
        raise RuntimeError("base-hard: the same seed gave other tokens")
    if np.array_equal(other, first):
        raise RuntimeError("base-hard: another seed gave the same tokens")

    # the card against the CPU on the 16-image request's features and noise
    gen = torch.Generator(device=dev).manual_seed(14)
    noise = [gumbel_noise((16, K), gen) for _ in range(MAX_LEN)]
    kw = dict(max_length=MAX_LEN, end_id=end_id)
    with torch.inference_mode():
        got = dec.greedy_sample(feats16, start_id, **kw,
                                att_noise=lambda t, shape: noise[t])
        ref = copy.deepcopy(dec).cpu().greedy_sample(
            feats16.cpu(), start_id, **kw,
            att_noise=lambda t, shape: noise[t].cpu())
        _, alphas = dec.stochastic_sample(feats16, start_id, gen,
                                          max_length=MAX_LEN, top_p=TOP_P)
    agree = (got.cpu() == ref).float().mean().item()
    one_hot = bool(((alphas == 0) | (alphas == 1)).all()
                   and (alphas.sum(-1) == 1).all())
    if agree < MIN_AGREEMENT or not one_hot:
        raise RuntimeError(f"base-hard card vs CPU agreement {agree}, "
                           f"one-hot alphas {one_hot}")
    log("hard", f"16- and 64-image requests: the same seed repeats their "
        f"tokens, seed 1 changes {float((other != first).mean()):.4f} of "
        f"them; 16-image request's features and noise: card vs "
        f"CPU decoder on the same features and noise: token agreement "
        f"{agree:.4f} (min {MIN_AGREEMENT}); sampled alphas exactly "
        f"one-hot")
    by_path = {"base-hard": launches}
    for name, options in (("base-hard-beam5", dict(beam_size=BEAM, seed=0)),
                          ("base-hard-sample", dict(sample=True, top_p=TOP_P,
                                                    seed=0))):
        _, got = run_requests(pipeline(**options), [requests[1]], smi, name)
        if any(got.values()):
            raise RuntimeError(f"{name} launched kernels: {got}")
        by_path[name] = got
    for c in pipe(list(requests[1][:2])):
        log("hard", f"caption: {c!r}")

    # time split of one 64-image chunk: device time of each stage alone,
    # and the host's time for the loop, which sets its pace
    program = make_caption_fn(cap, start_id, MAX_LEN, end_id=end_id,
                              generator=gen)
    ev = Events()
    with torch.inference_mode():
        x = torch.from_numpy(requests[2]).to(dev)
        f = ev.ms("encoder", lambda: cap.encoder(
            imagenet_normalize(to_unit_float(x))))
        ev.ms("decoder set-up", lambda: dec._prepare(f, None))
        loop = f"hard greedy loop x{MAX_LEN} (set-up included)"
        ev.ms(loop, lambda: dec.greedy_sample(f, start_id, generator=gen,
                                               **kw))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec.greedy_sample(f, start_id, generator=gen, **kw)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev.ms("caption program", lambda: program(x))
    log("hard", "64-image chunk split (device ms, each stage timed alone): "
        + ", ".join(f"{k} {v:.2f}" for k, v in ev.times.items())
        + f"; the loop on the host clock {host_ms:.2f} ms [{smi}]")
    return by_path, cap


def phase_mdepth_path(smi, est):
    """mdepth-soft: requests of 1, 16 and 64 images through the pipeline
    (K5 in the DPT, K2 at D=2080 on f32 features), the 16-image request
    against the plain versions, a beam-5 (K4) and a sampled (K1) request,
    and one chunk's time split."""
    import torch
    from depth_image_captioning_pub_torch.cli import (
        SPECIAL, placeholder_vocab)
    from depth_image_captioning_pub_torch.models import decoder as dec_mod
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.ops.image_ops import (
        imagenet_normalize, to_unit_float)
    from depth_image_captioning_pub_torch.ops.kernels import (
        decode_seq, vit_attention)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    dev = torch.device("cuda")
    w2i, i2w = placeholder_vocab(VOCAB)
    start_id, end_id = w2i[SPECIAL.start], w2i[SPECIAL.end]
    blocks = len(est.model.blocks)
    t0 = time.perf_counter()
    cap = build_captioner("mdepth-soft", VOCAB, device=dev)
    cap.init(torch.Generator().manual_seed(15))
    depth_fn = est.depth_fn()
    mlp = cap.depth_encoder_apply()
    log("mdepth", f"mdepth-soft: ResNet-152 bf16 + DPT-hybrid bf16 at "
        f"384x384 + DepthMLPEncoder f32 (256-128-64-32) + decoder at "
        f"D={cap.decoder.dim_enc_eff}, V={VOCAB}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    images = np.random.default_rng(15).integers(
        0, 256, (81, 224, 224, 3), dtype=np.uint8)
    requests = [images[:1], images[1:17], images[17:81]]

    def pipeline(**kw):
        pipe = CaptionPipeline(cap, w2i, i2w, depth_fn=depth_fn,
                               max_length=MAX_LEN, batch_buckets=(1, 16, 64),
                               **kw)
        for size in (1, 16, 64):          # warm-up: one call per bucket
            pipe.caption_tokens(images[:size])
        return pipe

    def expect(launches, chunks, **per_chunk):
        want = dict.fromkeys(launches, 0)
        want.update({k: v * chunks for k, v in per_chunk.items()})
        if launches != want:
            raise RuntimeError(f"mdepth-soft launches {launches}, expected "
                               f"{want}")

    pipe = pipeline()
    outputs, launches = run_requests(pipe, requests, smi, "mdepth")
    chunks = sum(-(-len(r) // pipe.batch_size) for r in requests)
    expect(launches, chunks, decode_seq=1, vit_attention=blocks)

    # the 16-image request again, with the attention and the decode plain
    plains = {vit_attention: vit_attention.fused_attention_plain,
              decode_seq: decode_seq.fused_greedy_decode_plain}

    def stages(x):
        x = to_unit_float(x)
        feats = cap.encoder(imagenet_normalize(x))
        dfeats = mlp(depth_fn(x))
        fused = cap.decoder.fuse(feats, dfeats)
        toks = cap.decoder.greedy_sample(feats, start_id, dfeats,
                                         max_length=MAX_LEN, end_id=end_id)
        return fused, toks

    def attention_plain(q, k, v, *, scale, n_valid):
        return plains[vit_attention](q, k, v, scale=scale, n_valid=n_valid)

    x16 = torch.from_numpy(requests[1]).to(dev)
    with torch.inference_mode():
        fused, _ = stages(x16)
        kernel_attention = vit_attention.fused_attention
        vit_attention.fused_attention = attention_plain
        dec_mod.fused_greedy_decode = plains[decode_seq]
        try:
            ref_fused, ref = stages(x16)
        finally:
            vit_attention.fused_attention = kernel_attention
            dec_mod.fused_greedy_decode = decode_seq.fused_greedy_decode
    if fused.dtype != torch.float32 or fused.shape != (16, K, D_CONCAT):
        raise RuntimeError(f"mdepth features {fused.dtype} "
                           f"{tuple(fused.shape)}")
    agree = float((ref.cpu().numpy() == outputs[1]).mean())
    err = (fused - ref_fused).abs().max().item()
    log("mdepth", f"16-image request vs plain attention+decode: token "
        f"agreement {agree:.4f} (min {MIN_AGREEMENT}), fused features "
        f"{tuple(fused.shape)} {fused.dtype} max abs err {err:.3e}")
    if agree < MIN_AGREEMENT:
        raise RuntimeError(f"mdepth-soft kernels vs plain agreement {agree}")
    by_path = {"mdepth-soft": launches}
    for name, kw, per_chunk in (
            ("mdepth-soft-beam5", dict(beam_size=BEAM), {"beam_seq": 1}),
            ("mdepth-soft-sample", dict(sample=True, top_p=TOP_P, seed=0),
             {"decode_step": MAX_LEN})):
        _, got = run_requests(pipeline(**kw), [requests[1]], smi, name)
        expect(got, 1, vit_attention=blocks, **per_chunk)
        by_path[name] = got
    for c in pipe(list(requests[1][:2])):
        log("mdepth", f"caption: {c!r}")

    # time split of one 64-image chunk
    ev = Events()
    dec = cap.decoder
    with torch.inference_mode():
        x = to_unit_float(torch.from_numpy(requests[2]).to(dev))
        feats = ev.ms("rgb encoder", lambda: cap.encoder(
            imagenet_normalize(x)))
        depth = ev.ms("dpt", lambda: depth_fn(x))
        dfeats = ev.ms("mlp encoder (patches + MLP)", lambda: mlp(depth))

        def setup():
            f, proj, h, c = dec._prepare(feats, dfeats)
            return f.contiguous(), proj, h, c, dec.seq_weights()

        f, proj, h, c, w = ev.ms("decoder set-up (concat, projection, "
                                 "h0/c0, packing)", setup)
        ev.ms("greedy decode (K2)", lambda: decode_seq.fused_greedy_decode(
            f, proj, h, c, w, max_length=MAX_LEN, start_id=start_id,
            end_id=end_id))
    total = sum(ev.times.values())
    log("mdepth", "64-image chunk split (device ms, each stage timed "
        "alone): " + ", ".join(f"{k} {v:.2f}" for k, v in ev.times.items())
        + f"; sum {total:.2f} [{smi}]")
    return by_path, cap


def phase_other_kinds(smi, est):
    """depth-hard and mdepth-hard at full width: one 16-image request
    each, greedy and beam 5; K5 runs in the DPT, no decode kernel."""
    import torch
    from depth_image_captioning_pub_torch.cli import placeholder_vocab
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    dev = torch.device("cuda")
    w2i, i2w = placeholder_vocab(VOCAB)
    blocks = len(est.model.blocks)
    images = np.random.default_rng(16).integers(
        0, 256, (16, 224, 224, 3), dtype=np.uint8)
    by_path = {}
    for seed, kind in enumerate(("depth-hard", "mdepth-hard"), 16):
        cap = build_captioner(kind, VOCAB, device=dev)
        cap.init(torch.Generator().manual_seed(seed))
        for beam in (1, BEAM):
            name = kind + (f"-beam{beam}" if beam > 1 else "")
            pipe = CaptionPipeline(cap, w2i, i2w, depth_fn=est.depth_fn(),
                                   max_length=MAX_LEN, batch_buckets=(16,),
                                   beam_size=beam, seed=0)
            pipe.caption_tokens(images)               # warm-up
            _, launches = run_requests(pipe, [images], smi, name)
            want = dict.fromkeys(launches, 0)
            want["vit_attention"] = blocks
            if launches != want:
                raise RuntimeError(f"{name} launches {launches}, expected "
                                   f"{want}")
            by_path[name] = launches
        log(kind, f"caption: {pipe(images[0])!r}")
        del cap, pipe
        torch.cuda.empty_cache()
    return by_path


def phase_score_new_kinds(smi, hard_cap, mdepth_cap, est):
    """One base-hard set (scored twice: the same hypotheses) and one
    mdepth-soft set, each written with ``params_to_jax`` and
    ``save_component`` in the JAX trainer's files, scored by ``evaluate``
    through ``load_eval_components`` on phase 13's 256 images."""
    import tempfile
    from pathlib import Path

    import torch
    from depth_image_captioning_pub_torch import cli
    from depth_image_captioning_pub_torch.config import ConfigEval
    from depth_image_captioning_pub_torch.engine import evaluate as ev
    from depth_image_captioning_pub_torch.utils.checkpoint import (
        save_component)
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        params_to_jax)
    w2i, i2w = cli.placeholder_vocab(VOCAB)
    data = ScoreImages(SCORE_IMAGES, [w for w in w2i if w.startswith("w")],
                       seed=13)
    chunks = -(-SCORE_IMAGES // SCORE_BATCH)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    by_path = {}
    for kind, cap, dfn, runs in (("base-hard", hard_cap, None, 2),
                                 ("mdepth-soft", mdepth_cap, est.depth_fn(),
                                  1)):
        base, atten = kind.split("-")
        mlp = base == "mdepth"
        trainable, frozen, stats = params_to_jax(cap)
        expected = {1: {k: v.clone() for k, v in cap.state_dict().items()}}
        with tempfile.TemporaryDirectory(dir=build,
                                         prefix=f"score_{kind}_") as tmp:
            cfg = ConfigEval()
            cfg.batch_size, cfg.max_length = SCORE_BATCH, MAX_LEN
            cfg.save_directory_hard = cfg.save_directory_Cdep_soft = tmp
            save_dir, files = cli.eval_tables(cfg, atten, False, mlp,
                                              "mlp" if mlp else "cnn")
            trees = [frozen["encoder"], trainable["decoder"]]
            if mlp:
                trees.append({"params": trainable["depth_encoder"],
                              "batch_stats": stats})
            for name, tree in zip(files[1], trees):
                save_component(f"{save_dir}/{name}", tree)
            hypos, total = [], {}
            for _ in range(runs):
                torch.cuda.synchronize()
                reset_counts()
                with PlainCalls() as plain, SetTimes(ev, cap,
                                                     expected) as sets:
                    scores = ev.evaluate(
                        kind, "coco", cap, sets.loader(
                            lambda i: cli.load_eval_components(
                                save_dir, files[i], cap)),
                        data, w2i, i2w, cfg, depth_fn=dfn, num_sets=1,
                        quiet=True)
                launches = read_counts()
                if plain.calls:
                    raise RuntimeError(f"plain versions ran on the {kind} "
                                       f"score path: {set(plain.calls)}")
                total = {k: total.get(k, 0) + v for k, v in launches.items()}
                hypos.append(sets.hypos[0])
                row = sets.rows[0]
                if list(scores) != list(ev.METRIC_KEYS) or not all(
                        np.all(np.isfinite(v)) for v in scores.values()):
                    raise RuntimeError(f"bad {kind} scores {scores}")
                load = row["read"] + row["copy"]
                log("score", f"{kind} set: load {load:.3f} s (read "
                    f"{row['read']:.3f}, copy to the card {row['copy']:.3f}), "
                    f"caption {row['caption']:.3f} s, host scoring "
                    f"{row['score']:.3f} s; CIDEr "
                    f"{scores['CIDEr'][0]:.4g} [{smi}]")
        want = dict.fromkeys(total, 0)
        if mlp:
            want.update(decode_seq=chunks,
                        vit_attention=chunks * len(est.model.blocks))
        if total != want:
            raise RuntimeError(f"{kind} score launches {total}, expected "
                               f"{want}")
        if runs > 1 and hypos[0] != hypos[1]:
            raise RuntimeError(f"{kind}: scoring the set twice gave other "
                               f"hypotheses")
        by_path[f"score-{kind}"] = total
        log("score", f"{kind}: launches {total} for {chunks} chunks a set; "
            f"loaded weights bit-equal to the written ones"
            + ("; the two runs' hypotheses identical" if runs > 1 else ""))
    return by_path


SERVE_BUCKETS = (1, 2, 4, 8, 16)   # the JAX bench's serving buckets
SERVE_SEQUENTIAL, SERVE_CLIENTS, SERVE_PER_CLIENT = 50, 16, 10
SERVE_DISTINCT = 64                # distinct request bodies, reused
SERVE_HW = (480, 640)              # the request images (a camera's size)
SAMPLE_REQUESTS = 16
DPT224_IMAGES = 16                 # one chunk: K5 at Z = 16 * 12, N = 197
DPT_BLOCKS = 12                    # the DPT-hybrid's ViT blocks


def png_bytes(arr):
    """Encode [H, W, 3] uint8 as a PNG with zlib, row y filtered with
    filter type y % 5 (every scanline filter is exercised)."""
    import struct
    import zlib
    h, w, _ = arr.shape
    x = arr.reshape(h, w * 3).astype(np.int16)
    up = np.vstack([np.zeros((1, w * 3), np.int16), x[:-1]])
    left = np.hstack([np.zeros((h, 3), np.int16), x[:, :-3]])
    upleft = np.hstack([np.zeros((h, 3), np.int16), up[:, :-3]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    kind = np.arange(h) % 5
    rows = ((x - preds[kind, np.arange(h)]) % 256).astype(np.uint8)
    raw = np.hstack([kind.astype(np.uint8)[:, None], rows]).tobytes()

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def photo_like(rng, n, hw):
    """n seeded [H, W, 3] uint8 images: a smooth field (a bilinear
    upsample of 12x16 noise) plus pixel noise, so a PNG compresses as a
    photograph's would, not as pure noise."""
    import torch
    import torch.nn.functional as F
    small = torch.from_numpy(rng.random((n, 3, 12, 16), np.float32) * 255)
    big = F.interpolate(small, size=hw, mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    noise = rng.normal(0.0, 6.0, big.shape)
    return np.clip(big + noise, 0, 255).astype(np.uint8)


def http_post(port, body, path="/caption", timeout=120):
    """(status, JSON reply, seconds) of one POST on its own connection."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=body)
        r = conn.getresponse()
        data = r.read()
        dt = time.perf_counter() - t0
    finally:
        conn.close()
    return r.status, json.loads(data), dt


def http_get(port, path):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def refused_and_closed(port, declared):
    """POST /caption declaring ``declared`` body bytes and sending none:
    the status line, and whether the server closed the connection (an
    open one times out)."""
    import socket
    with socket.create_connection(("127.0.0.1", port), timeout=20) as s:
        s.sendall((f"POST /caption HTTP/1.1\r\nHost: x\r\nConnection: "
                   f"keep-alive\r\nContent-Length: {declared}\r\n\r\n")
                  .encode())
        data = b""
        try:
            while True:
                part = s.recv(65536)
                if not part:
                    return data.split(b"\r\n")[0].decode(), True
                data += part
        except socket.timeout:
            return data.split(b"\r\n")[0].decode(), False


def decode_split(bodies):
    """Host ms a body of the PNG decode's parts (zlib inflate, the rest of
    ``decode_png``: chunks, CRCs, the C unfilter, the RGB conversion; then
    ``resize_u8``), and of the whole decode when 16 threads share the
    bodies (the server's handler threads and the interpreter lock)."""
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    from depth_image_captioning_pub_torch.data import image_io
    t = {"inflate": 0.0, "png rest": 0.0, "resize": 0.0}
    for b in bodies:
        idat = b"".join(body for tag, body in image_io._png_chunks(b)
                        if tag == b"IDAT")
        t0 = time.perf_counter()
        zlib.decompress(idat)
        t1 = time.perf_counter()
        rgb = image_io.decode_png(b)
        t2 = time.perf_counter()
        image_io.resize_u8(rgb, (224, 224))
        t3 = time.perf_counter()
        t["inflate"] += t1 - t0
        t["png rest"] += (t2 - t1) - (t1 - t0)
        t["resize"] += t3 - t2
    out = {k: v * 1e3 / len(bodies) for k, v in t.items()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_CLIENTS) as ex:
        list(ex.map(lambda b: image_io.decode_image_bytes(b, (224, 224)),
                    bodies))
    out[f"{SERVE_CLIENTS} threads (wall)"] = ((time.perf_counter() - t0)
                                             * 1e3 / len(bodies))
    return out


def percentiles(ms):
    q = np.percentile(np.asarray(ms), [50, 90, 99])
    return f"p50 {q[0]:.2f} / p90 {q[1]:.2f} / p99 {q[2]:.2f} ms"


class Server:
    """``serve(...)`` on 127.0.0.1:0 in a thread; stopped on exit."""

    def __init__(self, pipe):
        self.pipe = pipe

    def __enter__(self):
        import threading
        from depth_image_captioning_pub_torch.serve import serve
        self.httpd = serve(self.pipe, host="127.0.0.1", port=0,
                           batch_window_ms=2.0)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        return self.httpd.server_address[1]

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.httpd.service.stop()
        self.thread.join(timeout=60)


def write_experiment(root, kind, cap, w2i):
    """``cap``'s weights as checkpoint set 1 of ``kind`` in the JAX
    trainer's files under ``root`` (the reference's working-directory
    layout, the vocabulary included); returns (ConfigEval, save_dir,
    files)."""
    import os
    import pickle
    from depth_image_captioning_pub_torch import cli
    from depth_image_captioning_pub_torch.config import ConfigEval
    from depth_image_captioning_pub_torch.utils.checkpoint import (
        save_component)
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        params_to_jax)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        cfg = ConfigEval()
    finally:
        os.chdir(cwd)
    os.makedirs(os.path.dirname(cfg.word_to_id_file), exist_ok=True)
    with open(cfg.word_to_id_file, "wb") as f:
        pickle.dump(w2i, f)
    base, atten = kind.split("-")
    save_dir, files = cli.eval_tables(cfg, atten, False, base == "depth")
    trainable, frozen, stats = params_to_jax(cap)
    trees = [frozen["encoder"], trainable["decoder"]]
    if base == "depth":
        trees.append({"params": trainable["depth_encoder"],
                      "batch_stats": stats})
    for name, tree in zip(files[1], trees):
        save_component(f"{save_dir}/{name}", tree)
    return cfg, save_dir, files


def served_rows(pipe, calls, decoded, alone, w2i, i2w):
    """The server's device calls run again after it stopped (on the
    weights it served with): the encoder's features at the bucket each
    call was padded to; K2 over the bucket (``repeats``: calls whose
    tokens are the served ones bit for bit); K2 over each row alone at
    those features (``dependent_rows``: rows whose tokens differ, which
    would mean a row depends on the others in the batch); K2's plain
    version over each bucket (``plain_agreement``, over all calls). For
    each served row whose caption differs from its image's caption alone
    (``parted``): the largest difference between its features at the
    served bucket and at bucket 1, the first token where the two captions
    part, and there the logit margin between the two tokens in plain f32
    steps on each set of features."""
    import torch
    from depth_image_captioning_pub_torch.cli import SPECIAL
    from depth_image_captioning_pub_torch.data.tokenizer import (
        ids_to_caption)
    from depth_image_captioning_pub_torch.ops.image_ops import (
        imagenet_normalize, to_unit_float)
    from depth_image_captioning_pub_torch.ops.kernels import decode_seq
    from depth_image_captioning_pub_torch.ops.kernels.decode_step import (
        attention_lstm_step, plain_step_params)
    from depth_image_captioning_pub_torch.ops.precision import full_f32
    start_id, end_id = w2i[SPECIAL.start], w2i[SPECIAL.end]
    dec, enc = pipe.cap.decoder, pipe.cap.encoder_apply()

    def features(arrays):
        bucket = next(b for b in pipe.batch_buckets if b >= len(arrays))
        pad = np.concatenate([arrays, arrays[np.zeros(
            bucket - len(arrays), np.int64)]])
        with torch.inference_mode():
            return enc(imagenet_normalize(to_unit_float(
                torch.from_numpy(pad).to(pipe.device))))

    def greedy(f):
        return dec.greedy_sample(f.contiguous(), start_id,
                                 max_length=MAX_LEN,
                                 end_id=end_id).cpu().numpy()

    @torch.inference_mode()
    @full_f32()
    def logits_at(f, row, step):
        """The logits of ``step`` with the tokens of ``row`` before it."""
        feats, proj, h, c = dec._prepare(f, None)
        w = dec.seq_weights()
        p = plain_step_params(w.step)
        emb = w.embed[start_id][None]
        for t in range(step + 1):
            h, c, _ = attention_lstm_step(feats, proj, emb, h, c, p)
            emb = w.embed[int(row[t])][None]
        return (h @ w.w_out + w.b_out)[0]

    @torch.inference_mode()
    @full_f32()
    def plain(f):
        feats, proj, h, c = dec._prepare(f, None)
        return decode_seq.fused_greedy_decode_plain(
            feats, proj, h, c, dec.seq_weights(), max_length=MAX_LEN,
            start_id=start_id, end_id=end_id).cpu().numpy()

    out = {"repeats": 0, "dependent_rows": 0, "parted": [],
           "buckets": sorted({next(b for b in pipe.batch_buckets
                                   if b >= len(a)) for a, _ in calls})}
    agree, total, seen = 0, 0, set()
    for arrays, toks in calls:
        f = features(arrays)
        v = len(arrays)
        out["repeats"] += np.array_equal(greedy(f)[:v], toks)
        want = plain(f)[:v]
        agree += int((want == toks).sum())
        total += want.size
        for r in range(v):
            out["dependent_rows"] += not np.array_equal(
                greedy(f[r:r + 1])[0], toks[r])
            j = next(k for k in range(len(decoded))
                     if np.array_equal(decoded[k], arrays[r]))
            if (ids_to_caption(toks[r], i2w) == alone[j]
                    or (j, f.shape[0]) in seen):
                continue
            seen.add((j, f.shape[0]))
            f1 = features(arrays[r:r + 1])
            solo = greedy(f1)[0]
            step = int(np.argmax(solo != toks[r]))
            a, b = int(toks[r][step]), int(solo[step])
            lg_s = logits_at(f[r:r + 1], toks[r], step)
            lg_1 = logits_at(f1, solo, step)
            top = torch.topk(lg_s, 2).values
            out["parted"].append({
                "image": j, "bucket": f.shape[0], "step": step,
                "feature_diff": (f[r].float() - f1[0].float()).abs()
                .max().item(),
                "feature_max": f1.float().abs().max().item(),
                "margin_served": (lg_s[a] - lg_s[b]).item(),
                "margin_alone": (lg_1[b] - lg_1[a]).item(),
                "top2_gap": (top[0] - top[1]).item(),
                "logit_std": lg_s.std().item()})
    out["plain_agreement"] = agree / max(total, 1)
    return out


def phase_serve(smi, base_cap):
    """The HTTP caption server over phase 5's base-soft weights, read back
    from checkpoint files by ``CaptionPipeline.from_experiment``: the JAX
    bench's traffic (sequential, then concurrent clients) of 480x640 PNG
    bodies, replies against the pipeline's direct captions, /metrics,
    /healthz, a refused oversized POST, /reload; then ``--sample``."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    import torch
    from depth_image_captioning_pub_torch import serve as serve_mod
    from depth_image_captioning_pub_torch.cli import placeholder_vocab
    from depth_image_captioning_pub_torch.data.image_io import (
        decode_image_bytes)
    from depth_image_captioning_pub_torch.data.tokenizer import (
        ids_to_caption)
    from depth_image_captioning_pub_torch.models.decoder import (
        AttentionDecoder)
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        params_to_jax)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    from depth_image_captioning_pub_torch.utils.checkpoint import (
        save_component)
    w2i, i2w = placeholder_vocab(VOCAB)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    pixels = photo_like(rng, SERVE_DISTINCT, SERVE_HW)
    bodies = [png_bytes(a) for a in pixels]
    log("serve", f"{SERVE_DISTINCT} request bodies: {SERVE_HW[0]}x"
        f"{SERVE_HW[1]} PNGs from seed {SEED}, "
        f"{np.mean([len(b) for b in bodies]) / 1e3:.0f} kB each, encoded "
        f"in {time.perf_counter() - t0:.1f} s")
    from depth_image_captioning_pub_torch.data import native_loader
    if not native_loader.available():     # built here at first use
        raise RuntimeError("the native image library did not build")
    log("serve", f"native image library {native_loader.library_path()}: "
        f"built; JPEG part {'yes' if native_loader.has_jpeg() else 'no'}")
    t0 = time.perf_counter()
    decoded = np.stack([decode_image_bytes(b, (224, 224)) for b in bodies])
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(bodies)
    try:
        import io

        from PIL import Image
        pil = [np.asarray(Image.open(io.BytesIO(b)).convert("RGB").resize(
            (224, 224), Image.BILINEAR)) for b in bodies[:8]]
        same = all(np.array_equal(a, b) for a, b in zip(pil, decoded[:8]))
        if not same:
            raise RuntimeError("decode_image_bytes differs from Pillow's "
                               "decode and resize on the card's machine")
        pil_note = "equal to Pillow's decode + resize on 8 bodies"
    except ImportError:
        pil_note = "Pillow not importable: not cross-checked"
    log("serve", f"host decode (PNG inflate + unfilter + Pillow-exact "
        f"resize to 224x224): {decode_ms:.2f} ms a body; {pil_note}")
    log("serve", "host decode split, ms a body: " + ", ".join(
        f"{k} {v:.2f}" for k, v in decode_split(bodies).items()))

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    launches_by_path = {}
    with tempfile.TemporaryDirectory(dir=build, prefix="serve_") as root:
        cfg, save_dir, files = write_experiment(root, "base-soft", base_cap,
                                                w2i)
        cfg.max_length = MAX_LEN
        t0 = time.perf_counter()
        pipe = CaptionPipeline.from_experiment(
            "base-soft", cfg=cfg, device="cuda", batch_buckets=SERVE_BUCKETS)
        log("serve", f"from_experiment (ResNet-152 bf16 + decoder, "
            f"V={VOCAB}, buckets {SERVE_BUCKETS}) in "
            f"{time.perf_counter() - t0:.1f} s")
        for bsz in SERVE_BUCKETS:                  # warm-up
            pipe.caption_tokens(decoded[:bsz])
        # the direct captions, before the server starts: each image alone
        # (the sequential requests' batches)
        alone = [pipe(decoded[i]) for i in range(len(decoded))]
        # the worker's device calls, recorded (arrays and tokens) to be
        # repeated once the server has stopped
        calls, direct_tokens = [], pipe.caption_tokens

        def recorded(arrays):
            toks = direct_tokens(arrays)
            calls.append((arrays.copy(), toks.copy()))
            return toks

        pipe.caption_tokens = recorded
        torch.cuda.synchronize()
        reset_counts()
        with PlainCalls() as plain, Server(pipe) as port:
            seq = [http_post(port, bodies[i % SERVE_DISTINCT])
                   for i in range(SERVE_SEQUENTIAL)]
            _, m_seq = http_get(port, "/metrics")

            def client(c):
                return [http_post(port, bodies[(c * SERVE_PER_CLIENT + i)
                                               % SERVE_DISTINCT])
                        for i in range(SERVE_PER_CLIENT)]

            t0 = time.perf_counter()
            with ThreadPoolExecutor(SERVE_CLIENTS) as ex:
                conc = list(ex.map(client, range(SERVE_CLIENTS)))
            conc_s = time.perf_counter() - t0
            _, m_all = http_get(port, "/metrics")
            _, health = http_get(port, "/healthz")
            status, closed = refused_and_closed(
                port, serve_mod.MAX_REQUEST_BYTES + 1)

            pipe.caption_tokens = direct_tokens
            # /reload after set 1's decoder file is rewritten
            dec = AttentionDecoder(VOCAB, device="cpu")
            dec.reset_parameters(torch.Generator().manual_seed(200))
            save_component(f"{save_dir}/{files[1][1]}",
                           {k: v.numpy() for k, v in
                            dec.state_dict().items()})
            reload_status, reload_reply, reload_s = http_post(port, b"",
                                                              "/reload")
            after = [http_post(port, bodies[i]) for i in range(8)]
        launches = read_counts()
        svc_hist = m_all["batch_size_hist"]
        served, batches = m_all["images_served"], m_all["batches_run"]
        # a fresh pipeline over the rewritten files, after the server
        fresh = CaptionPipeline.from_experiment(
            "base-soft", cfg=cfg, device="cuda", batch_buckets=(1,))
        want_after = [fresh(decoded[i]) for i in range(8)]
        del fresh
        # each device call of the traffic again on set 1's weights
        trainable, frozen, _ = params_to_jax(base_cap)
        pipe.reload_weights(trainable, frozen["encoder"])
        rerun = served_rows(pipe, calls, decoded, alone, w2i, i2w)

    # checks
    replies = seq + [r for c in conc for r in c] + after
    bad = [r for r in replies if r[0] != 200]
    if bad or reload_status != 200:
        raise RuntimeError(f"serve: {len(bad)} replies not 200 (first "
                           f"{bad[:1]}), /reload {reload_status} "
                           f"{reload_reply}")
    seq_caps = [r[1]["caption"] for r in seq]
    if seq_caps != [alone[i % SERVE_DISTINCT]
                    for i in range(SERVE_SEQUENTIAL)]:
        raise RuntimeError("serve: a sequential reply differs from the "
                           "pipeline's direct caption of its image")
    if rerun["repeats"] != len(calls):
        raise RuntimeError(f"serve: {len(calls) - rerun['repeats']} of "
                           f"{len(calls)} device calls gave other tokens "
                           f"when repeated")
    if rerun["dependent_rows"]:
        raise RuntimeError(f"serve: {rerun['dependent_rows']} rows gave "
                           f"other tokens decoded alone at their call's "
                           f"features than in the call's bucket")
    if rerun["plain_agreement"] < MIN_AGREEMENT:
        raise RuntimeError(f"serve: K2's token agreement with its plain "
                           f"version at the served buckets "
                           f"{rerun['plain_agreement']:.4f} < "
                           f"{MIN_AGREEMENT}")
    # a concurrent reply is a row's caption in a device call that held its
    # image; the rows are the requests, one each
    served_caps = {}
    for arrays, toks in calls:
        for a, row in zip(arrays, toks):
            j = next(k for k in range(SERVE_DISTINCT)
                     if np.array_equal(decoded[k], a))
            served_caps.setdefault(j, []).append(ids_to_caption(row, i2w))
    wrong, near_ties = 0, 0
    for c, rows in enumerate(conc):
        for i, r in enumerate(rows):
            j = (c * SERVE_PER_CLIENT + i) % SERVE_DISTINCT
            wrong += r[1]["caption"] not in served_caps.get(j, [])
            near_ties += r[1]["caption"] != alone[j]
    rows_run = sum(len(a) for a, _ in calls)
    if wrong or rows_run != SERVE_SEQUENTIAL + SERVE_CLIENTS * \
            SERVE_PER_CLIENT:
        raise RuntimeError(f"serve: {wrong} concurrent replies are not the "
                           f"pipeline's captions of their batches; "
                           f"{rows_run} rows in {len(calls)} device calls")
    if [r[1]["caption"] for r in after] != want_after:
        raise RuntimeError("serve: captions after /reload differ from a "
                           "fresh pipeline's over the rewritten files")
    if want_after == alone[:8]:
        raise RuntimeError("serve: the rewritten decoder left the captions "
                           "unchanged")
    total = SERVE_SEQUENTIAL + SERVE_CLIENTS * SERVE_PER_CLIENT + 8
    if health["images_served"] != total - 8 or served != total - 8:
        raise RuntimeError(f"serve: /healthz counts {health} and /metrics "
                           f"{served}, expected {total - 8}")
    if not any(int(k) > 1 for k in svc_hist):
        raise RuntimeError(f"serve: no batch above 1 under concurrency: "
                           f"{svc_hist}")
    if not (status.startswith("HTTP/1.1 413") and closed):
        raise RuntimeError(f"serve: oversized POST got {status!r}, "
                           f"connection closed {closed}")
    if plain.calls:
        raise RuntimeError(f"plain versions ran on the serve path: "
                           f"{sorted(set(plain.calls))}")
    want = dict.fromkeys(launches, 0)
    want["decode_seq"] = batches + len(after)
    if launches != want:
        raise RuntimeError(f"serve launches {launches}, expected {want}")
    launches_by_path["serve"] = launches

    seq_ms = [r[2] * 1e3 for r in seq]
    conc_ms = [r[2] * 1e3 for c in conc for r in c]
    n_conc = SERVE_CLIENTS * SERVE_PER_CLIENT
    conc_batches = batches - m_seq["batches_run"]
    log("serve", f"{SERVE_SEQUENTIAL} sequential requests: "
        f"{percentiles(seq_ms)}"
        f", {SERVE_SEQUENTIAL / (sum(seq_ms) / 1e3):.1f} captions/s; the "
        f"host decode {decode_ms:.2f} ms = "
        f"{100 * decode_ms / np.median(seq_ms):.1f}% of the median request "
        f"[{smi}]")
    log("serve", f"{SERVE_CLIENTS} concurrent clients x {SERVE_PER_CLIENT}: "
        f"{percentiles(conc_ms)}, {n_conc / conc_s:.1f} captions/s, "
        f"effective batch {n_conc / conc_batches:.2f} ({conc_batches} "
        f"device calls) [{smi}]")
    log("serve", f"server: batch histogram {svc_hist}; request latency "
        f"{m_all['request_latency']}; device calls {m_all['device_batch']}")
    log("serve", f"all {len(replies)} replies 200; the sequential ones "
        f"equal the pipeline's direct captions alone, the concurrent ones "
        f"the pipeline's captions of the batches the worker formed (its "
        f"{len(calls)} device calls repeated after the server: "
        f"bit-identical tokens; each of their {rows_run} rows decoded alone "
        f"at its call's features by K2: the same tokens; K2's plain version "
        f"over the served buckets {rerun['buckets']}: token agreement "
        f"{rerun['plain_agreement']:.4f}); /healthz "
        f"{health['images_served']} images; oversized POST: {status!r}, "
        f"connection closed; /reload in {reload_s * 1e3:.0f} ms: 8 "
        f"captions equal a fresh pipeline's over the rewritten files")
    log("serve", f"{near_ties} of {n_conc} concurrent replies differ from "
        f"their image's caption alone; {len(rerun['parted'])} distinct "
        f"(image, bucket) rows: " + ("; ".join(
            f"image {d['image']} at bucket {d['bucket']}: features differ "
            f"by at most {d['feature_diff']:.4g} from bucket 1's "
            f"(largest feature {d['feature_max']:.4g}), the captions part "
            f"at token {d['step']}, where the served token leads by "
            f"{d['margin_served']:.4g} in the served features' logits "
            f"(top-2 gap {d['top2_gap']:.4g}) and trails by "
            f"{d['margin_alone']:.4g} in bucket 1's (plain f32 steps; the "
            f"logits' standard deviation there {d['logit_std']:.4g})"
            for d in rerun["parted"]) or "none"))
    log("serve", f"launches {launches} for {batches} device calls; plain "
        f"calls 0")
    launches_by_path["serve-sample"] = phase_serve_sample(
        smi, pipe, bodies[:SAMPLE_REQUESTS], w2i, i2w)
    del pipe
    torch.cuda.empty_cache()
    return launches_by_path


def phase_serve_sample(smi, pipe, bodies, w2i, i2w):
    """Two servers over the same captioner with ``sample=True, top_p=0.9``
    and one seed answer the same captions to the same sequential
    requests; K1 launches 30 a device call."""
    import torch
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    runs, calls = [], 0
    torch.cuda.synchronize()
    reset_counts()
    with PlainCalls() as plain:
        for _ in range(2):
            spipe = CaptionPipeline(pipe.cap, w2i, i2w, max_length=MAX_LEN,
                                    batch_buckets=SERVE_BUCKETS, sample=True,
                                    top_p=TOP_P, seed=SEED)
            with Server(spipe) as port:
                replies = [http_post(port, b) for b in bodies]
                _, m = http_get(port, "/metrics")
            calls += m["batches_run"]
            if any(r[0] != 200 for r in replies):
                raise RuntimeError("serve-sample: a reply is not 200")
            runs.append(replies)
    launches = read_counts()
    caps = [[r[1]["caption"] for r in run] for run in runs]
    if caps[0] != caps[1]:
        raise RuntimeError("serve-sample: two servers with one seed "
                           "answered other captions")
    want = dict.fromkeys(launches, 0)
    want["decode_step"] = MAX_LEN * calls
    if launches != want or plain.calls:
        raise RuntimeError(f"serve-sample launches {launches}, expected "
                           f"{want}; plain calls {plain.calls}")
    ms = [r[2] * 1e3 for run in runs for r in run]
    log("serve-sample", f"{len(bodies)} sequential requests x 2 servers "
        f"(top_p {TOP_P}, seed {SEED}): the same captions, "
        f"{len(set(caps[0]))} distinct; {percentiles(ms)} [{smi}]")
    log("serve-sample", f"launches {launches} for {calls} device calls; "
        f"plain calls 0")
    return launches


def phase_caption_depth224(smi, vit):
    """``caption.main`` over a directory of 480x640 PNG files at
    ``--kind depth-soft --beam 3 --dpt-size 224 --gelu tanh --dpt-head
    lowres``: its output equals the pipeline's direct captions of the same
    paths; K5 at Z = 16 * 12, N = 197 against its plain version."""
    import os
    import tempfile
    from pathlib import Path

    import torch
    from depth_image_captioning_pub_torch import caption as caption_cli
    from depth_image_captioning_pub_torch.cli import placeholder_vocab
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    dev = torch.device("cuda")
    z, n, d = DPT224_IMAGES * 12, 197, 64
    rng = np.random.default_rng(SEED + 1)
    qkv = [torch.from_numpy(rng.standard_normal((z, n, d)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(3)]
    err, mean, tol, k_ms, p_ms = attention_case(*qkv, n)
    bound_ms, bound_by = bound(4 * z * n * d * 2, 4 * z * n * n * d,
                               BF16_FLOPS)
    vit["max_abs_err"] = max(vit["max_abs_err"], err)
    vit["ms_by_shape"][f"Z={z} N={n} d={d}"] = {
        "ms": k_ms, "plain_ms": p_ms, "max_abs_err": err,
        "bound_ms": bound_ms, "bound_by": bound_by}
    log("vit_attention", f"Z={z} N={n} d={d} bf16 (the DPT at 224x224): max "
        f"abs err {err:.3e}, mean {mean:.3e} (tol {tol:.3e}); kernel "
        f"{k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}) [{smi}]")

    w2i, _ = placeholder_vocab(VOCAB)
    cap = build_captioner("depth-soft", VOCAB, device=dev)
    cap.init(torch.Generator().manual_seed(21))
    pixels = photo_like(rng, DPT224_IMAGES, SERVE_HW)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    argv = ["--kind", "depth-soft", "--beam", "3", "--dpt-size", "224",
            "--gelu", "tanh", "--dpt-head", "lowres", "--json"]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(dir=build, prefix="caption_") as root:
        cfg, _, _ = write_experiment(root, "depth-soft", cap, w2i)
        del cap
        pngs = Path(root) / "images"
        pngs.mkdir()
        for i, a in enumerate(pixels):
            (pngs / f"img{i:02d}.png").write_bytes(png_bytes(a))
        out = Path(root) / "captions.json"
        os.chdir(root)
        try:
            torch.cuda.synchronize()
            reset_counts()
            with PlainCalls() as plain:
                t0 = time.perf_counter()
                rc = caption_cli.main([str(pngs), "--output", str(out)]
                                      + argv)
                torch.cuda.synchronize()
                cli_s = time.perf_counter() - t0
            launches = read_counts()
            rows = json.loads(out.read_text())
            cfg.dpt_image_size, cfg.dpt_gelu, cfg.dpt_head = (224, "tanh",
                                                             "lowres")
            pipe = CaptionPipeline.from_experiment(
                "depth-soft", cfg=cfg, device="cuda", beam_size=3,
                batch_size=16)
            paths = [r["path"] for r in rows]
            direct = pipe(paths)
        finally:
            os.chdir(cwd)
    if rc != 0 or len(rows) != DPT224_IMAGES:
        raise RuntimeError(f"caption.main exit {rc}, {len(rows)} rows")
    if [r["caption"] for r in rows] != direct:
        raise RuntimeError("caption.main's captions differ from the "
                           "pipeline's direct captions of the same paths")
    if plain.calls:
        raise RuntimeError(f"plain versions ran on the caption path: "
                           f"{sorted(set(plain.calls))}")
    want = dict.fromkeys(launches, 0)
    want.update(beam_seq=1, vit_attention=DPT_BLOCKS)
    if launches != want:
        raise RuntimeError(f"caption-depth224-beam3 launches {launches}, "
                           f"expected {want}")
    log("caption", f"caption.main {' '.join(argv)} over {DPT224_IMAGES} "
        f"480x640 PNGs: exit 0 in {cli_s:.1f} s (the experiment's load and "
        f"the random DPT's build included), captions equal to "
        f"CaptionPipeline's on the same paths; {len(set(direct))} distinct "
        f"[{smi}]")
    log("caption", f"caption: {direct[0]!r}; no JPEG files: the card's "
        f"machine has no jpeglib.h")
    log("caption", f"launches {launches}; plain calls 0")
    del pipe
    torch.cuda.empty_cache()
    return {"caption-depth224-beam3": launches}


def main():
    smi = phase_env()
    import torch
    phase_build()
    step = phase_step(smi)
    seq = phase_seq(smi)
    base, base_cap = phase_main_path(smi)
    vit = phase_vit(smi)
    depth, est = phase_depth_path(smi)
    nic_k = phase_nic_kernel(smi)
    nic = phase_nic_path(smi)
    beam_k = phase_beam_kernel(smi)
    beam = phase_beam_path(smi, base_cap)
    sample = phase_sample_path(smi, base_cap)
    score = phase_score_path(smi, base_cap)
    by_path = dict(zip(PATHS, (base, depth, nic, beam, sample, score)))
    hard, hard_cap = phase_hard_path(smi)
    mdepth, mdepth_cap = phase_mdepth_path(smi, est)
    by_path.update(hard)
    by_path.update(mdepth)
    by_path.update(phase_other_kinds(smi, est))
    by_path.update(phase_score_new_kinds(smi, hard_cap, mdepth_cap, est))
    by_path.update(phase_serve(smi, base_cap))
    by_path.update(phase_caption_depth224(smi, vit))
    if tuple(by_path) != PATHS:
        raise RuntimeError(f"paths run {tuple(by_path)}, expected {PATHS}")
    kernels = [step, seq, nic_k, beam_k, vit]
    for entry in kernels:
        counts = {path: c[entry["name"]] for path, c in by_path.items()}
        entry["launches"] = sum(counts.values())
        entry["launches_by_path"] = counts
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
