"""LSTM cell and stacked LSTM step with torch's parameterization
(counterpart of the JAX ``ops/lstm.py``): per-gate blocks stacked in
(i, f, g, o) order, weights in the JAX package's [in, 4H] layout."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from depth_image_captioning_pub_torch.ops.precision import matmul_f32
from depth_image_captioning_pub_torch.parallel.tp import (
    copy_to_region, gather_from_region)


class LSTMCellParams(NamedTuple):
    w_ih: torch.Tensor  # [input_dim, 4H], gate order i, f, g, o
    w_hh: torch.Tensor  # [H, 4H]
    b_ih: torch.Tensor  # [4H]
    b_hh: torch.Tensor  # [4H]


def lstm_cell(p: LSTMCellParams, x: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor, axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTMCell step in f32: returns (h', c') in h's and c's dtypes.
    The gate products accumulate in f32 on exactly upcast operands
    (``matmul_f32``: bf16 weights and inputs of the mixed-precision
    decoder keep bf16 values and get an f32 result); the biases are summed
    in their own dtype, then upcast, as the JAX cell does. ``axis``: the
    model axis (``parallel/tp``) over which the weights' ``4H`` gate
    columns are split; this rank's gates are gathered before the cell."""
    f32 = torch.float32
    hx = h
    if axis is not None:
        x, hx = copy_to_region(x, axis), copy_to_region(h, axis)
    gates = (matmul_f32(x, p.w_ih) + matmul_f32(hx, p.w_hh)
             + (p.b_ih + p.b_hh).to(f32))
    if axis is not None:
        gates = gather_from_region(gates, axis, -1)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c.to(f32) + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


class StackedLSTMParams(NamedTuple):
    """A multi-layer LSTM (NIC: two layers), one cell's params per layer."""

    layers: Tuple[LSTMCellParams, ...]


def stacked_lstm_step(p: StackedLSTMParams, x: torch.Tensor,
                      hs: torch.Tensor, cs: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One time step through all layers; hs, cs [num_layers, B, H].
    Returns (top layer's h', new hs, new cs)."""
    new_h, new_c = [], []
    inp = x
    for li, lp in enumerate(p.layers):
        h, c = lstm_cell(lp, inp, hs[li], cs[li])
        new_h.append(h)
        new_c.append(c)
        inp = h
    return inp, torch.stack(new_h), torch.stack(new_c)
