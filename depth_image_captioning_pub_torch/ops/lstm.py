"""LSTM cell with torch's parameterization (counterpart of the JAX
``ops/lstm.py``): per-gate blocks stacked in (i, f, g, o) order, weights
in the JAX package's [in, 4H] layout."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class LSTMCellParams(NamedTuple):
    w_ih: torch.Tensor  # [input_dim, 4H], gate order i, f, g, o
    w_hh: torch.Tensor  # [H, 4H]
    b_ih: torch.Tensor  # [4H]
    b_hh: torch.Tensor  # [4H]


def lstm_cell(p: LSTMCellParams, x: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTMCell step in f32: returns (h', c') in h's and c's dtypes."""
    f32 = torch.float32
    gates = (x.to(f32) @ p.w_ih.to(f32) + h.to(f32) @ p.w_hh.to(f32)
             + (p.b_ih + p.b_hh).to(f32))
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c.to(f32) + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)
