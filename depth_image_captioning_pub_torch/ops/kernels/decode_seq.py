"""Whole-sequence greedy decode: CUDA kernel wrapper and plain version.

Counterpart of the JAX ``ops/pallas/decode_seq.py``. Every step runs the
attention-LSTM step of ``decode_step``, then the vocab head
``h' @ w_out + b_out``, an argmax (lowest index on equal values) and the
embedding of the chosen token; the output is the token matrix [B, L].

``fused_greedy_decode`` launches ``csrc/decode_seq.cu`` (the whole loop in
one launch, one CTA per image row) for CUDA tensors and
``fused_greedy_decode_plain`` (a Python time loop) for CPU tensors.
``end_id >= 0`` gives finished rows <end>-padding and stops once every row
is done, the output of the JAX early-exit paths; ``end_id < 0`` runs all
``max_length`` steps. Any batch size B >= 1 is taken as it is: there is no
padding to a multiple of 8 as on the TPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from depth_image_captioning_pub_torch.ops.kernels import _build
from depth_image_captioning_pub_torch.ops.kernels.decode_step import (
    FEATURE_DTYPES, DecodeStepWeights, attention_lstm_step, check_float32,
    check_same_device, check_shape, check_step_weights, cuda_pointers,
    plain_step_params)

LAUNCHES = 0   # kernel launches of dcap_greedy_decode in this process


class DecodeSeqWeights(NamedTuple):
    step: DecodeStepWeights
    w_out: torch.Tensor   # [H, V]
    b_out: torch.Tensor   # [1, V]
    embed: torch.Tensor   # [V, E]


def fused_greedy_decode_plain(features, features_proj, h0, c0,
                              w: DecodeSeqWeights, *, max_length: int = 30,
                              start_id: int = 0, end_id: int = -1
                              ) -> torch.Tensor:
    """Plain PyTorch version of the greedy kernel: tokens [B, L] int32."""
    p = plain_step_params(w.step)
    bsz = features.shape[0]
    tokens = torch.full((bsz, max_length), max(end_id, 0), dtype=torch.int32,
                        device=features.device)
    done = torch.zeros((bsz,), dtype=torch.bool, device=features.device)
    emb = w.embed[start_id].expand(bsz, -1)
    h, c = h0, c0
    for t in range(max_length):
        h, c, _ = attention_lstm_step(features, features_proj, emb, h, c, p)
        logits = h @ w.w_out + w.b_out
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        if end_id >= 0:
            token = torch.where(done, torch.full_like(token, end_id), token)
            done = done | (token == end_id)
        tokens[:, t] = token
        if end_id >= 0 and bool(done.all()):
            break
        emb = w.embed[token.long()]
    return tokens


def fused_greedy_decode(features: torch.Tensor, features_proj: torch.Tensor,
                        h0: torch.Tensor, c0: torch.Tensor,
                        w: DecodeSeqWeights, *, max_length: int = 30,
                        start_id: int = 0, end_id: int = -1) -> torch.Tensor:
    """Whole-sequence greedy decode; returns tokens [B, max_length] int32.

    features [B,K,D] float32 or bfloat16, features_proj [B,K,A] and
    h0/c0 [B,H] float32. CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise.
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
    if not 0 <= start_id < vocab or end_id >= vocab:
        raise ValueError(f"start_id {start_id} / end_id {end_id} outside "
                         f"the vocabulary of {vocab}")
    if features.device.type == "cpu":
        return fused_greedy_decode_plain(
            features, features_proj, h0, c0, w, max_length=max_length,
            start_id=start_id, end_id=end_id)
    if features.device.type != "cuda":
        raise ValueError(f"no kernel for device {features.device}")

    ptrs = cuda_pointers([("features", features)] + named)
    lib = _build.load()
    tokens = torch.empty((bsz, max_length), dtype=torch.int32,
                         device=features.device)
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcap_greedy_decode(
            ptrs[0], int(features.dtype == torch.bfloat16), *ptrs[1:],
            tokens.data_ptr(), bsz, k, d, a, e, hdim, vocab, max_length,
            start_id, end_id, stream)
    _build.check_launch(err, "dcap_greedy_decode")
    LAUNCHES += 1
    return tokens
