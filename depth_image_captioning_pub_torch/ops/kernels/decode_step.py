"""Fused attention-LSTM decode step: CUDA kernel wrapper and plain version.

Counterpart of the JAX ``ops/pallas/decode_step.py``. One step computes

  dec    = h @ w_dec + b_dec                        [B, A]
  e      = relu(proj + dec) @ w_full + b_full       [B, K]
  alpha  = softmax(e)                               [B, K]
  ctx    = alpha @ features                         [B, D]
  gate   = sigmoid(h @ w_fb + b_fb)                 [B, D]
  gates  = emb @ w_ih_e + (gate*ctx) @ w_ih_c + h @ w_hh + b
  h',c'  = LSTM tail                                [B, H]

``fused_decode_core`` launches ``csrc/decode_step.cu`` (one CTA per image
row; the step itself is the device function in ``csrc/decode_step.cuh``)
for CUDA tensors and ``fused_decode_core_plain`` for CPU tensors. Features may be
float32 or bfloat16 (upcast exactly as they are read); everything else is
float32, and alpha comes back float32.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from depth_image_captioning_pub_torch.ops.attention import (
    AttentionParams, soft_attention)
from depth_image_captioning_pub_torch.ops.kernels import _build
from depth_image_captioning_pub_torch.ops.lstm import LSTMCellParams, lstm_cell

LAUNCHES = 0   # kernel launches of dcap_decode_step in this process

FEATURE_DTYPES = (torch.float32, torch.bfloat16)


class DecodeStepWeights(NamedTuple):
    """Step weights in kernel layout, float32."""

    w_dec: torch.Tensor    # [H, A]
    b_dec: torch.Tensor    # [1, A]
    w_full: torch.Tensor   # [A, 1]
    b_full: torch.Tensor   # [1, 1]
    w_fb: torch.Tensor     # [H, D]
    b_fb: torch.Tensor     # [1, D]
    w_ih_e: torch.Tensor   # [E, 4H]   (embedding rows of w_ih)
    w_ih_c: torch.Tensor   # [D, 4H]   (context rows of w_ih)
    w_hh: torch.Tensor     # [H, 4H]
    b_lstm: torch.Tensor   # [1, 4H]   (b_ih + b_hh)


def pack_weights(att_w_dec, att_b_dec, att_w_full, att_b_full, f_beta_w,
                 f_beta_b, lstm_w_ih, lstm_w_hh, lstm_b_ih, lstm_b_hh,
                 dim_embedding: int) -> DecodeStepWeights:
    """Split/reshape AttentionDecoder params into kernel layout (views,
    except the summed LSTM bias)."""
    return DecodeStepWeights(
        w_dec=att_w_dec, b_dec=att_b_dec[None, :],
        w_full=att_w_full.reshape(-1, 1),
        b_full=att_b_full.reshape(1, 1),
        w_fb=f_beta_w, b_fb=f_beta_b[None, :],
        w_ih_e=lstm_w_ih[:dim_embedding], w_ih_c=lstm_w_ih[dim_embedding:],
        w_hh=lstm_w_hh, b_lstm=(lstm_b_ih + lstm_b_hh)[None, :])


class PlainStepParams(NamedTuple):
    """The step weights regrouped for the ops-level composition."""

    att: AttentionParams
    lstm: LSTMCellParams
    w_fb: torch.Tensor
    b_fb: torch.Tensor


def plain_step_params(w: DecodeStepWeights) -> PlainStepParams:
    att = AttentionParams(None, None, w.w_dec, w.b_dec[0], w.w_full[:, 0],
                          w.b_full[0, 0])
    b = w.b_lstm[0]
    lstm = LSTMCellParams(torch.cat([w.w_ih_e, w.w_ih_c], dim=0), w.w_hh, b,
                          torch.zeros_like(b))
    return PlainStepParams(att, lstm, w.w_fb, w.b_fb[0])


def attention_lstm_step(features, features_proj, emb, h, c,
                        p: PlainStepParams):
    """The step composed from ops/attention and ops/lstm, in float32."""
    ctx, alpha = soft_attention(p.att, features, features_proj, h,
                                compute_dtype=torch.float32)
    gate = torch.sigmoid(h @ p.w_fb + p.b_fb)
    x = torch.cat([emb, gate * ctx], dim=-1)
    h_new, c_new = lstm_cell(p.lstm, x, h, c)
    return h_new, c_new, alpha


def fused_decode_core_plain(features, features_proj, emb, h, c,
                            w: DecodeStepWeights
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch version of the step kernel: (h', c', alpha)."""
    return attention_lstm_step(features, features_proj, emb, h, c,
                               plain_step_params(w))


def check_same_device(named: Sequence[Tuple[str, torch.Tensor]],
                      device: torch.device) -> None:
    for name, t in named:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def check_float32(named: Sequence[Tuple[str, torch.Tensor]]) -> None:
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def check_shape(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def check_step_weights(w: DecodeStepWeights, k: int, d: int, a: int,
                       e: int, h: int) -> None:
    g = 4 * h
    for name, shape in (("w_dec", (h, a)), ("b_dec", (1, a)),
                        ("w_full", (a, 1)), ("b_full", (1, 1)),
                        ("w_fb", (h, d)), ("b_fb", (1, d)),
                        ("w_ih_e", (e, g)), ("w_ih_c", (d, g)),
                        ("w_hh", (h, g)), ("b_lstm", (1, g))):
        check_shape(name, getattr(w, name), shape)
    check_float32(list(zip(w._fields, w)))


def cuda_pointers(named: Sequence[Tuple[str, torch.Tensor]]):
    """Raw pointers for the kernel; every tensor must be contiguous."""
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return [t.data_ptr() for _, t in named]


def fused_decode_core(features: torch.Tensor, features_proj: torch.Tensor,
                      emb: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                      w: DecodeStepWeights
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused attention + gated context + LSTM cell.

    features [B,K,D] (float32 or bfloat16), features_proj [B,K,A],
    emb [B,E], h/c [B,H], all float32 but the features. Returns (h', c',
    alpha [B,K]). CPU tensors run the plain version; CUDA tensors launch
    the kernel or raise.
    """
    global LAUNCHES
    if features.dim() != 3 or features.shape[0] < 1:
        raise ValueError(f"features must be [B>=1, K, D], got "
                         f"{tuple(features.shape)}")
    bsz, k, d = features.shape
    a, e, hdim = features_proj.shape[-1], emb.shape[-1], h.shape[-1]
    if features.dtype not in FEATURE_DTYPES:
        raise TypeError(f"features must be float32 or bfloat16, got "
                        f"{features.dtype}")
    check_shape("features_proj", features_proj, (bsz, k, a))
    check_shape("emb", emb, (bsz, e))
    check_shape("h", h, (bsz, hdim))
    check_shape("c", c, (bsz, hdim))
    check_float32([("features_proj", features_proj), ("emb", emb),
                   ("h", h), ("c", c)])
    check_step_weights(w, k, d, a, e, hdim)
    named = [("features_proj", features_proj), ("emb", emb), ("h", h),
             ("c", c)] + list(zip(w._fields, w))
    check_same_device(named, features.device)
    if features.device.type == "cpu":
        return fused_decode_core_plain(features, features_proj, emb, h, c, w)
    if features.device.type != "cuda":
        raise ValueError(f"no kernel for device {features.device}")

    ptrs = cuda_pointers([("features", features)] + named)
    lib = _build.load()
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    alpha = torch.empty((bsz, k), dtype=torch.float32, device=features.device)
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcap_decode_step(
            ptrs[0], int(features.dtype == torch.bfloat16), *ptrs[1:],
            h_out.data_ptr(), c_out.data_ptr(), alpha.data_ptr(),
            bsz, k, d, a, e, hdim, stream)
    _build.check_launch(err, "dcap_decode_step")
    LAUNCHES += 1
    return h_out, c_out, alpha
