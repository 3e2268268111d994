"""Masked sequence losses (counterpart of the JAX ``engine/losses.py``).

Cross-entropy is the mean over exactly the non-padding target tokens: the
packed-sequence loss of the reference, over fixed shapes. ``pad_mask``
drops the rows that the fixed-shape pipeline repeats to fill the last
batch. ``denoms`` replace the normalizers by a whole batch's counts, so a
part of the batch returns its contribution to the whole batch's loss (the
JAX package's exact gradient accumulation).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Metrics = Dict[str, torch.Tensor]


def token_mask(lengths: torch.Tensor, num_steps: int,
               pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T] validity mask: step t targets token t+1, valid iff t < len-1."""
    t = torch.arange(num_steps, device=lengths.device)[None, :]
    mask = t < (lengths[:, None] - 1)
    if pad_mask is not None:
        mask = mask & pad_mask[:, None]
    return mask


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor,
                         denom: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Mean CE over the masked positions: logits [B, T, V], targets [B, T]
    int, mask [B, T] bool; f32 logsumexp. ``denom`` overrides the token
    count that normalizes the sum."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = torch.where(mask, logz - gold, 0.0)
    if denom is None:
        denom = torch.clamp(mask.sum(), min=1)
    return nll.sum() / denom


def doubly_stochastic_penalty(alphas: torch.Tensor, mask: torch.Tensor,
                              pad_mask: Optional[torch.Tensor] = None,
                              lam: float = 0.7,
                              example_denom: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """lam * mean((1 - sum_t alpha)^2) over rows x regions, the masked
    steps' alphas zeroed before the time sum and pad rows left out.
    ``example_denom`` overrides the row count (see ``denoms``)."""
    alphas = alphas.to(torch.float32) * mask[..., None]
    per = (1.0 - alphas.sum(dim=1)) ** 2                     # [B, K]
    if example_denom is not None:
        w = (pad_mask.to(torch.float32)[:, None] if pad_mask is not None
             else torch.ones((per.shape[0], 1), device=per.device))
        return lam * (per * w).sum() / (example_denom * per.shape[1])
    if pad_mask is None:
        return lam * per.mean()
    w = pad_mask.to(torch.float32)[:, None]
    denom = torch.clamp(w.sum() * per.shape[1], min=1.0)
    return lam * (per * w).sum() / denom


def caption_loss(logits: torch.Tensor, captions: torch.Tensor,
                 lengths: torch.Tensor,
                 alphas: Optional[torch.Tensor] = None,
                 pad_mask: Optional[torch.Tensor] = None,
                 alpha_reg: float = 0.0,
                 denoms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Metrics]:
    """Attention models: CE(logits_t, captions[:, t+1]) plus, with
    ``alpha_reg`` > 0, the doubly stochastic penalty. logits [B, L-1, V]
    from teacher forcing. ``denoms=(token_total, example_total)``: the
    whole batch's normalizers. Returns (loss, {"ce", ["alpha_penalty"],
    "loss"}), every value a 0-d tensor on the logits' device."""
    targets = captions[:, 1:]
    mask = token_mask(lengths, targets.shape[1], pad_mask)
    tok_denom, ex_denom = denoms if denoms is not None else (None, None)
    ce = masked_cross_entropy(logits, targets, mask, denom=tok_denom)
    metrics = {"ce": ce}
    loss = ce
    if alpha_reg > 0.0 and alphas is not None:
        pen = doubly_stochastic_penalty(alphas, mask, pad_mask, alpha_reg,
                                        example_denom=ex_denom)
        metrics["alpha_penalty"] = pen
        loss = loss + pen
    metrics["loss"] = loss
    return loss, metrics


def nic_loss(logits: torch.Tensor, captions: torch.Tensor,
             lengths: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
             denom: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Metrics]:
    """NIC: logits [B, L, V] whose step 0 read the image; the targets are
    the whole caption, <start> included (valid iff t < length)."""
    t = torch.arange(captions.shape[1], device=captions.device)[None, :]
    mask = t < lengths[:, None]
    if pad_mask is not None:
        mask = mask & pad_mask[:, None]
    ce = masked_cross_entropy(logits, captions, mask, denom=denom)
    return ce, {"ce": ce, "loss": ce}
