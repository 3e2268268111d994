"""Plain soft-attention LSTM decoder (Show, Attend and Tell,
arXiv:1502.03044, as the reference repository's ``DecoderWithAttention``)
over a dict of weights in [in, out] layout, float32.

Per step: e = w_full . relu(W_enc z + W_dec h) (W_enc z once per image),
alpha = softmax(e) over the K regions, context = sum alpha z, gated by
sigmoid(f_beta h); the LSTM cell (gates i, f, g, o) reads [embedding |
gated context]; the head h W_out + b_out gives the logits. h0, c0 come
from a linear map of the mean annotation vector.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from reference.ops import F32

PREFIX = "decoder."


def weights(w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The decoder's entries of ``w``, without the prefix."""
    return {k[len(PREFIX):]: v for k, v in w.items() if k.startswith(PREFIX)}


def prepare(d, feats: torch.Tensor):
    """(projected features [B, K, A], h0, c0) of f32 features [B, K, D]."""
    proj = feats @ d["att_w_enc"] + d["att_b_enc"]
    h, c = (feats.mean(1) @ d["init_w"] + d["init_b"]).chunk(2, -1)
    return proj, h, c


def step(d, feats, proj, emb, h, c) -> Tuple[torch.Tensor, ...]:
    """One step: (h', c', alpha)."""
    dec = h @ d["att_w_dec"] + d["att_b_dec"]
    e = torch.relu(proj + dec[:, None]) @ d["att_w_full"][:, 0] + d[
        "att_b_full"][0]
    alpha = torch.softmax(e, dim=1)
    ctx = torch.bmm(alpha[:, None], feats)[:, 0]
    gate = torch.sigmoid(h @ d["f_beta_w"] + d["f_beta_b"])
    x = torch.cat([emb, gate * ctx], -1)
    g = x @ d["lstm_w_ih"] + h @ d["lstm_w_hh"] + (d["lstm_b_ih"]
                                                   + d["lstm_b_hh"])
    i, f, gg, o = g.chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c), c, alpha


def logits(d, h: torch.Tensor) -> torch.Tensor:
    return h @ d["out_w"] + d["out_b"]


def teacher_forced(d, feats: torch.Tensor, inputs: torch.Tensor,
                   keep: Optional[List[torch.Tensor]] = None,
                   dropout: float = 0.0):
    """Teacher forcing: ``inputs`` [B, T] token ids, step t reading
    inputs[:, t]; (logits [B, T, V], alphas [B, T, K]). ``keep``: per step
    the dropout keep-mask [B, H] on h before the head."""
    feats = feats.to(F32)
    proj, h, c = prepare(d, feats)
    emb = d["embed"][inputs.long()]
    outs, alphas = [], []
    for t in range(inputs.shape[1]):
        h, c, alpha = step(d, feats, proj, emb[:, t], h, c)
        out = h if keep is None else torch.where(keep[t], h / (1 - dropout),
                                                 0.0)
        outs.append(out)
        alphas.append(alpha)
    return logits(d, torch.stack(outs, 1)), torch.stack(alphas, 1)


def greedy(d, feats: torch.Tensor, start_id: int, end_id: int,
           max_length: int) -> torch.Tensor:
    """Greedy decode: tokens [B, max_length] int32, <end> after the first."""
    feats = feats.to(F32)
    proj, h, c = prepare(d, feats)
    b = feats.shape[0]
    prev = torch.full((b,), start_id, dtype=torch.long, device=feats.device)
    done = torch.zeros(b, dtype=torch.bool, device=feats.device)
    out = []
    for _ in range(max_length):
        h, c, _ = step(d, feats, proj, d["embed"][prev], h, c)
        tok = torch.argmax(logits(d, h), -1)
        tok = torch.where(done, end_id, tok)
        done = done | (tok == end_id)
        out.append(tok)
        prev = tok
    return torch.stack(out, 1).to(torch.int32)


def served_steps(tokens: torch.Tensor, end_id: int) -> torch.Tensor:
    """Per row, the steps up to and including its first <end> (all steps
    where there is none)."""
    ended = tokens == end_id
    first = torch.where(ended.any(1), ended.int().argmax(1) + 1,
                        torch.full_like(ended[:, 0], tokens.shape[1],
                                        dtype=torch.long))
    return first


def widest_gap(d, feats: torch.Tensor, tokens: torch.Tensor, start_id: int,
               end_id: int) -> Tuple[float, int]:
    """Teacher-forced over served ``tokens`` [B, L]: the widest gap by which
    a served token's logit lies below the best logit at its step, over
    every row's steps up to its first <end>; (gap, tokens compared)."""
    b, length = tokens.shape
    tokens = tokens.long()
    inputs = torch.cat([torch.full((b, 1), start_id, dtype=torch.long,
                                   device=tokens.device), tokens[:, :-1]], 1)
    lg, _ = teacher_forced(d, feats, inputs)
    gap = lg.max(-1).values - torch.gather(lg, -1, tokens[..., None])[..., 0]
    steps = served_steps(tokens, end_id)
    valid = torch.arange(length, device=tokens.device)[None] < steps[:, None]
    return float(torch.where(valid, gap, 0.0).max()), int(valid.sum())
