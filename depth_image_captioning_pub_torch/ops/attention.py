"""Bahdanau grid attention as functions over explicit weight tensors
(counterpart of the JAX ``ops/attention.py``): soft attention, and hard
attention's Gumbel-max one-hot sample (eval and captioning; the
Gumbel-softmax relaxation of training comes with the training slice).

The encoder-side projection is computed once per image by
``project_features``; each decode step pays only the decoder projection and
the score reduction. Shapes: features [B, K, D], hidden [B, H], projected
features [B, K, A], alpha [B, K].

Storage and compute dtypes differ on purpose: features may be STORED bf16
(the encoder's output) while the arithmetic runs in ``compute_dtype`` f32
on exactly upcast values.

Hard attention takes its Gumbel noise as an argument: the JAX package
draws it from its own keys, which the tests replay through it, and the
port's decoders from a ``torch.Generator`` (``ops/decode.region_noise``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class AttentionParams(NamedTuple):
    """Weights of the scoring MLP, [in, out] layout as in the JAX package."""

    w_enc: Optional[torch.Tensor]   # [D, A]
    b_enc: Optional[torch.Tensor]   # [A]
    w_dec: torch.Tensor             # [H, A]
    b_dec: torch.Tensor             # [A]
    w_full: torch.Tensor            # [A]
    b_full: torch.Tensor            # []


def project_features(p: AttentionParams, features: torch.Tensor,
                     compute_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """W_z·z + b_z once per image: [B,K,D] -> [B,K,A] in ``compute_dtype``
    (default: the feature dtype)."""
    cd = compute_dtype or features.dtype
    return torch.matmul(features.to(cd), p.w_enc.to(cd)) + p.b_enc.to(cd)


def attention_logits(p: AttentionParams, features_proj: torch.Tensor,
                     hidden: torch.Tensor) -> torch.Tensor:
    """Alignment scores e_t: [B, K]."""
    dec = hidden @ p.w_dec + p.b_dec                          # [B, A]
    act = torch.relu(features_proj + dec[:, None, :])         # [B, K, A]
    return torch.matmul(act, p.w_full) + p.b_full


def soft_attention(p: AttentionParams, features: torch.Tensor,
                   features_proj: torch.Tensor, hidden: torch.Tensor,
                   compute_dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft attention context [B, D] and weights [B, K]; the softmax runs
    in f32, the context in ``compute_dtype`` (default: the feature dtype)."""
    cd = compute_dtype or features.dtype
    logits = attention_logits(p, features_proj, hidden)
    alpha = torch.softmax(logits.to(torch.float32), dim=1).to(cd)
    context = torch.bmm(alpha[:, None, :], features.to(cd))[:, 0, :]
    return context, alpha


def gumbel_max_attention(p: AttentionParams, features: torch.Tensor,
                         features_proj: torch.Tensor, hidden: torch.Tensor,
                         noise: torch.Tensor,
                         compute_dtype: Optional[torch.dtype] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hard attention's eval and captioning path: the region ``pos =
    argmax(logits + noise)`` over K (f32; the lowest index on ties, as
    ``jnp.argmax``), alpha = one_hot(pos) and the context the gathered
    feature row, upcast to ``compute_dtype`` (the one-hot weighted sum,
    without its products). ``noise`` is [B, K] standard Gumbel."""
    cd = compute_dtype or features.dtype
    logits = attention_logits(p, features_proj, hidden)
    pos = torch.argmax(logits.to(torch.float32) + noise, dim=1)
    alpha = torch.nn.functional.one_hot(pos, logits.shape[1]).to(cd)
    rows = torch.arange(features.shape[0], device=features.device)
    return features[rows, pos].to(cd), alpha
