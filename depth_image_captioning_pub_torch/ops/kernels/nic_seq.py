"""Whole-sequence NIC greedy decode: CUDA kernel wrapper and plain version.

Counterpart of the JAX ``ops/pallas/nic_seq.py``. A stacked LSTM starts
from zero state, is primed by the image embedding x0 at step 0, and each
step runs every layer (gates ``in @ w_ih + h @ w_hh + b`` with the biases
pre-summed, split (i, f, g, o)), the vocab head ``h_top @ w_out + b_out``,
an argmax (lowest index on equal values) and the embedding of the chosen
token. There is no <end> early exit: NIC's greedy decode always runs
``max_length`` steps.

``fused_nic_greedy_decode`` launches ``csrc/nic_seq.cu`` (one CTA per image
row, the whole loop in one launch) for CUDA tensors and
``fused_nic_greedy_decode_plain`` for CPU tensors. Any batch B >= 1 is
taken as it is (no padding to 8 as on the TPU), with 1 to 4 layers.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from depth_image_captioning_pub_torch.ops.kernels import _build
from depth_image_captioning_pub_torch.ops.kernels.decode_step import (
    check_float32, check_same_device, check_shape, cuda_pointers)
from depth_image_captioning_pub_torch.ops.lstm import (
    LSTMCellParams, StackedLSTMParams, stacked_lstm_step)

LAUNCHES = 0   # kernel launches of dcap_nic_greedy_decode in this process

MAX_LAYERS = 4   # kMaxLayers of csrc/nic_seq.cu


class NICSeqWeights(NamedTuple):
    """``layer_mats`` is (w_ih_0, w_hh_0, b_0, w_ih_1, w_hh_1, b_1, ...)
    with b = b_ih + b_hh as [1, 4H]; all float32."""

    layer_mats: Tuple[torch.Tensor, ...]
    w_out: torch.Tensor   # [H, V]
    b_out: torch.Tensor   # [1, V]
    embed: torch.Tensor   # [V, E]


def pack_nic_weights(lstm: StackedLSTMParams, out_w: torch.Tensor,
                     out_b: torch.Tensor, embed: torch.Tensor
                     ) -> NICSeqWeights:
    """Bundle NICDecoder params for the kernel (biases pre-summed)."""
    mats = []
    for cell in lstm.layers:
        mats.extend([cell.w_ih, cell.w_hh, (cell.b_ih + cell.b_hh)[None, :]])
    return NICSeqWeights(tuple(mats), out_w, out_b[None, :], embed)


def _stacked(w: NICSeqWeights) -> StackedLSTMParams:
    m = w.layer_mats
    return StackedLSTMParams(tuple(
        LSTMCellParams(m[i], m[i + 1], m[i + 2][0],
                       torch.zeros_like(m[i + 2][0]))
        for i in range(0, len(m), 3)))


def fused_nic_greedy_decode_plain(x0: torch.Tensor, w: NICSeqWeights, *,
                                  max_length: int = 30) -> torch.Tensor:
    """Plain PyTorch version of the NIC greedy kernel: tokens [B, L]."""
    lstm = _stacked(w)
    bsz, hdim = x0.shape[0], w.w_out.shape[0]
    hs = torch.zeros((len(lstm.layers), bsz, hdim), dtype=torch.float32,
                     device=x0.device)
    cs = torch.zeros_like(hs)
    tokens = torch.empty((bsz, max_length), dtype=torch.int32,
                         device=x0.device)
    x = x0
    for t in range(max_length):
        out, hs, cs = stacked_lstm_step(lstm, x, hs, cs)
        token = torch.argmax(out @ w.w_out + w.b_out, dim=-1)
        tokens[:, t] = token.to(torch.int32)
        x = w.embed[token]
    return tokens


def fused_nic_greedy_decode(x0: torch.Tensor, w: NICSeqWeights, *,
                            max_length: int = 30) -> torch.Tensor:
    """Whole-sequence NIC greedy decode; returns tokens [B, max_length]
    int32. ``x0`` [B, E] float32 is the projected image embedding that
    primes the LSTM. CPU tensors run the plain version; CUDA tensors launch
    the kernel or raise."""
    global LAUNCHES
    if x0.dim() != 2 or x0.shape[0] < 1:
        raise ValueError(f"x0 must be [B>=1, E], got {tuple(x0.shape)}")
    bsz, e = x0.shape
    hdim, vocab = w.w_out.shape
    layers = len(w.layer_mats) // 3
    if len(w.layer_mats) % 3 or not 1 <= layers <= MAX_LAYERS:
        raise ValueError(f"the kernel takes 1 to {MAX_LAYERS} layers of "
                         f"(w_ih, w_hh, b), got {len(w.layer_mats)} "
                         f"matrices")
    g = 4 * hdim
    for li in range(layers):
        w_ih, w_hh, b = w.layer_mats[3 * li:3 * li + 3]
        check_shape(f"w_ih_{li}", w_ih, (e if li == 0 else hdim, g))
        check_shape(f"w_hh_{li}", w_hh, (hdim, g))
        check_shape(f"b_{li}", b, (1, g))
    check_shape("b_out", w.b_out, (1, vocab))
    check_shape("embed", w.embed, (vocab, e))
    named = ([("x0", x0)]
             + [(f"layer_mats[{i}]", m) for i, m in enumerate(w.layer_mats)]
             + [("w_out", w.w_out), ("b_out", w.b_out), ("embed", w.embed)])
    check_float32(named)
    check_same_device(named, x0.device)
    if max_length < 1:
        raise ValueError(f"max_length must be >= 1, got {max_length}")
    if x0.device.type == "cpu":
        return fused_nic_greedy_decode_plain(x0, w, max_length=max_length)
    if x0.device.type != "cuda":
        raise ValueError(f"no kernel for device {x0.device}")

    ptrs = cuda_pointers(named)
    layer_ptrs = ptrs[1:1 + 3 * layers] + [None] * (3 * (MAX_LAYERS - layers))
    lib = _build.load()
    tokens = torch.empty((bsz, max_length), dtype=torch.int32,
                         device=x0.device)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcap_nic_greedy_decode(
            ptrs[0], *layer_ptrs, *ptrs[1 + 3 * layers:], tokens.data_ptr(),
            bsz, layers, e, hdim, vocab, max_length, stream)
    _build.check_launch(err, "dcap_nic_greedy_decode")
    LAUNCHES += 1
    return tokens
