"""Whole beam search of the attention decoder: CUDA kernel wrapper, plain
version, and the selection of the best beam.

Counterpart of the JAX ``ops/pallas/beam_seq.py``, with the search of
``ops/decode.beam_search``: beam 0 alone is live at step 0; each step runs
the attention-LSTM step of ``decode_step`` for the B·W beams, the vocab
head and a log-softmax; finished beams may only continue with <end> at zero
cost; the flat top-W over W·V (``lax.top_k``'s order) picks the new beams,
whose state is gathered from their parents. The search stops once every
beam is finished; the records of the skipped steps are <end> with identity
parents, which is what running them would give.

``fused_beam_decode`` launches ``csrc/beam_seq.cu`` (one CTA per image with
all W of its beams, the whole search in one launch, W = 2..5) for CUDA
tensors and ``fused_beam_decode_plain`` for CPU tensors. Both return the
per-step records (``BeamSeqOutputs``); ``reconstruct_history`` and
``select_best`` turn them into the best caption, in plain PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from depth_image_captioning_pub_torch.ops import decode
from depth_image_captioning_pub_torch.ops.kernels import _build
from depth_image_captioning_pub_torch.ops.kernels.decode_seq import (
    DecodeSeqWeights)
from depth_image_captioning_pub_torch.ops.kernels.decode_step import (
    FEATURE_DTYPES, check_float32, check_same_device, check_shape,
    check_step_weights, cuda_pointers, plain_step_params)
from depth_image_captioning_pub_torch.ops.lstm import lstm_cell

LAUNCHES = 0   # kernel launches of dcap_beam_decode in this process

BEAM_SIZES = (2, 3, 4, 5)        # the widths csrc/beam_seq.cu is built for
THREADS = 512                    # kBeamThreads of csrc/beam_seq.cu
SMEM_LIMIT = 232448              # bytes of shared memory a block may use


class BeamSeqOutputs(NamedTuple):
    tokens: torch.Tensor    # [B, W, L] int32: token chosen for beam w at t
    parents: torch.Tensor   # [B, W, L] int32: parent beam of beam w at t
    scores: torch.Tensor    # [B, W] f32: final cumulative log-probs


def smem_bytes(k: int, d: int, a: int, e: int, h: int, beam: int) -> int:
    """The kernel's dynamic shared memory (``beam_smem_floats``)."""
    floats = (beam * (2 * h + e + a + k + 2 * d + 4 * h)
              + THREADS // 32 * beam + beam * 4 * THREADS)
    return 4 * floats


def fused_beam_decode_plain(features, features_proj, h0, c0,
                            w: DecodeSeqWeights, *, beam_size: int,
                            max_length: int = 30, start_id: int = 0,
                            end_id: int = 0) -> BeamSeqOutputs:
    """Plain PyTorch version of the beam kernel, the same records. The
    attention reads each image's features once for its W beams."""
    p = plain_step_params(w.step)
    bsz, k, _ = features.shape
    beam, dev = beam_size, features.device
    feats = features.to(torch.float32)
    h = h0.repeat_interleave(beam, dim=0)
    c = c0.repeat_interleave(beam, dim=0)
    emb = w.embed[start_id].expand(bsz * beam, -1)
    scores = decode.initial_scores(bsz, beam, dev)
    finished = torch.zeros((bsz, beam), dtype=torch.bool, device=dev)
    tokens = torch.full((bsz, beam, max_length), end_id, dtype=torch.int32,
                        device=dev)
    parents = torch.arange(beam, dtype=torch.int32, device=dev)[
        None, :, None].repeat(bsz, 1, max_length)
    rows = torch.arange(bsz, device=dev)[:, None] * beam
    for t in range(max_length):
        if bool(finished.all()):
            break
        # the attention-LSTM step, beam-aware: [B, W, ...]
        h3 = h.reshape(bsz, beam, -1)
        dec = h3 @ p.att.w_dec + p.att.b_dec
        act = torch.relu(features_proj[:, None] + dec[:, :, None, :])
        alpha = torch.softmax(act @ p.att.w_full + p.att.b_full, dim=-1)
        ctx = torch.bmm(alpha, feats).reshape(bsz * beam, -1)
        gate = torch.sigmoid(h @ p.w_fb + p.b_fb)
        h, c = lstm_cell(p.lstm, torch.cat([emb, gate * ctx], dim=-1), h, c)
        lp = decode.log_softmax(h @ w.w_out + w.b_out)
        lp = decode.restrict_finished(lp.reshape(bsz, beam, -1), finished,
                                      end_id)
        scores, parent, token = decode.top_w(scores[..., None] + lp, beam)
        flat = (rows + parent).reshape(-1)
        h, c = h[flat], c[flat]
        finished = torch.gather(finished, 1, parent) | (token == end_id)
        emb = w.embed[token.reshape(-1).long()]
        tokens[:, :, t] = token
        parents[:, :, t] = parent.to(torch.int32)
    return BeamSeqOutputs(tokens, parents, scores)


def fused_beam_decode(features: torch.Tensor, features_proj: torch.Tensor,
                      h0: torch.Tensor, c0: torch.Tensor,
                      w: DecodeSeqWeights, *, beam_size: int,
                      max_length: int = 30, start_id: int = 0,
                      end_id: int = 0) -> BeamSeqOutputs:
    """The whole beam search in one call; returns the per-step records.

    features [B,K,D] float32 or bfloat16, features_proj [B,K,A] and h0/c0
    [B,H] float32, all per image (the search tiles the beams itself). CPU
    tensors run the plain version; CUDA tensors launch the kernel or raise.
    """
    global LAUNCHES
    if features.dim() != 3 or features.shape[0] < 1:
        raise ValueError(f"features must be [B>=1, K, D], got "
                         f"{tuple(features.shape)}")
    bsz, k, d = features.shape
    a, hdim = features_proj.shape[-1], h0.shape[-1]
    vocab, e = w.embed.shape
    if features.dtype not in FEATURE_DTYPES:
        raise TypeError(f"features must be float32 or bfloat16, got "
                        f"{features.dtype}")
    check_shape("features_proj", features_proj, (bsz, k, a))
    check_shape("h0", h0, (bsz, hdim))
    check_shape("c0", c0, (bsz, hdim))
    check_shape("w_out", w.w_out, (hdim, vocab))
    check_shape("b_out", w.b_out, (1, vocab))
    check_step_weights(w.step, k, d, a, e, hdim)
    named = ([("features_proj", features_proj), ("h0", h0), ("c0", c0)]
             + list(zip(w.step._fields, w.step))
             + [("w_out", w.w_out), ("b_out", w.b_out), ("embed", w.embed)])
    check_float32(named)
    check_same_device(named, features.device)
    if max_length < 1:
        raise ValueError(f"max_length must be >= 1, got {max_length}")
    if beam_size < 1 or beam_size > vocab:
        raise ValueError(f"beam_size must be in [1, {vocab}], got "
                         f"{beam_size}")
    if not 0 <= start_id < vocab or not 0 <= end_id < vocab:
        raise ValueError(f"start_id {start_id} / end_id {end_id} outside "
                         f"the vocabulary of {vocab}")
    if features.device.type == "cpu":
        return fused_beam_decode_plain(
            features, features_proj, h0, c0, w, beam_size=beam_size,
            max_length=max_length, start_id=start_id, end_id=end_id)
    if features.device.type != "cuda":
        raise ValueError(f"no kernel for device {features.device}")

    if beam_size not in BEAM_SIZES:
        raise ValueError(f"the beam kernel is built for beam sizes "
                         f"{BEAM_SIZES}, got {beam_size}")
    need = smem_bytes(k, d, a, e, hdim, beam_size)
    if need > SMEM_LIMIT:
        raise ValueError(f"beam_size={beam_size} at K={k}, D={d}, A={a}, "
                         f"E={e}, H={hdim} needs {need} bytes of shared "
                         f"memory per block, more than {SMEM_LIMIT}")
    ptrs = cuda_pointers([("features", features)] + named)
    lib = _build.load()
    dev = features.device
    logits = torch.empty((bsz, beam_size, vocab), dtype=torch.float32,
                         device=dev)
    tokens = torch.empty((bsz, beam_size, max_length), dtype=torch.int32,
                         device=dev)
    parents = torch.empty_like(tokens)
    scores = torch.empty((bsz, beam_size), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcap_beam_decode(
            ptrs[0], int(features.dtype == torch.bfloat16), *ptrs[1:],
            logits.data_ptr(), tokens.data_ptr(), parents.data_ptr(),
            scores.data_ptr(), bsz, k, d, a, e, hdim, vocab, beam_size,
            max_length, start_id, end_id, stream)
    _build.check_launch(err, "dcap_beam_decode")
    LAUNCHES += 1
    return BeamSeqOutputs(tokens, parents, scores)


def reconstruct_history(out: BeamSeqOutputs) -> torch.Tensor:
    """Per-step (token, parent) records -> each final beam's tokens [B, W,
    L]: a reverse walk through its parent chain."""
    tokens, parents, _ = out
    bsz, beam, length = tokens.shape
    idx = torch.arange(beam, device=tokens.device).expand(bsz, beam)
    history = torch.empty_like(tokens)
    for t in range(length - 1, -1, -1):
        history[:, :, t] = torch.gather(tokens[:, :, t], 1, idx)
        idx = torch.gather(parents[:, :, t], 1, idx).long()
    return history


def select_best(out: BeamSeqOutputs, end_id: int,
                length_penalty: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens [B, L] of the best beam, its score [B]), as the tail of
    ``ops/decode.beam_search``."""
    return decode.select_best(out.scores, reconstruct_history(out), end_id,
                              length_penalty)
