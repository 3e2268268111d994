"""Attention LSTM caption decoder (counterpart of the JAX
``models/decoder.py``), soft attention without depth fusion.

Parameters keep the JAX names and [in, out] layout as plain
``nn.Parameter``s (``att_w_enc``, ``lstm_w_ih``, ``out_w``, ...), so the
bridge from the JAX parameter tree is a name-for-name copy and
``pack_weights`` is a slice and reshape.

Greedy decode runs the whole-sequence kernel of
``ops/kernels/decode_seq.py`` (``csrc/decode_seq.cu`` on a CUDA device,
its plain PyTorch version on the CPU). Encoder features may stay bf16 in
device memory: the projection, the initial state and the kernel upcast
them exactly, and all decoder arithmetic is f32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from depth_image_captioning_pub_torch.models.initializers import (
    torch_bias, torch_linear_kernel, uniform_pm)
from depth_image_captioning_pub_torch.ops.attention import (
    AttentionParams, project_features)
from depth_image_captioning_pub_torch.ops.kernels.decode_seq import (
    DecodeSeqWeights, fused_greedy_decode)
from depth_image_captioning_pub_torch.ops.kernels.decode_step import (
    pack_weights)


class DecoderState(NamedTuple):
    h: torch.Tensor  # [B, H]
    c: torch.Tensor  # [B, H]


class AttentionDecoder(nn.Module):
    """Soft-attention LSTM decoder without depth fusion, float32
    parameters (hard attention and fusion wait for their slices)."""

    def __init__(self, vocab_size: int, dim_attention: int = 128,
                 dim_embedding: int = 128, dim_encoder: int = 2048,
                 dim_decoder: int = 128, device=None):
        super().__init__()
        self.vocab_size = vocab_size
        self.dim_embedding = dim_embedding
        d_enc, d_att, d_dec, d_emb = (dim_encoder, dim_attention, dim_decoder,
                                      dim_embedding)
        p, b, u = torch_linear_kernel, torch_bias, uniform_pm
        # name -> (shape, initializer), in the JAX module's order
        self._inits = {
            "embed": ((vocab_size, d_emb), u(0.1)),
            "att_w_enc": ((d_enc, d_att), p),
            "att_b_enc": ((d_att,), b(d_enc)),
            "att_w_dec": ((d_dec, d_att), p),
            "att_b_dec": ((d_att,), b(d_dec)),
            "att_w_full": ((d_att, 1), p),
            "att_b_full": ((1,), b(d_att)),
            "lstm_w_ih": ((d_emb + d_enc, 4 * d_dec), p),
            "lstm_w_hh": ((d_dec, 4 * d_dec), p),
            "lstm_b_ih": ((4 * d_dec,), b(d_dec)),
            "lstm_b_hh": ((4 * d_dec,), b(d_dec)),
            "init_w": ((d_enc, 2 * d_dec), p),
            "init_b": ((2 * d_dec,), b(d_enc)),
            "f_beta_w": ((d_dec, d_enc), p),
            "f_beta_b": ((d_enc,), b(d_dec)),
            "out_w": ((d_dec, vocab_size), u(0.1)),
            "out_b": ((vocab_size,), None),    # zeros
        }
        for name, (shape, _) in self._inits.items():
            self.register_parameter(name, nn.Parameter(torch.zeros(
                shape, dtype=torch.float32, device=device)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for name, (shape, init) in self._inits.items():
                param = getattr(self, name)
                if init is None:
                    param.zero_()
                else:
                    param.copy_(init(shape, generator))

    def att_params(self) -> AttentionParams:
        return AttentionParams(self.att_w_enc, self.att_b_enc,
                               self.att_w_dec, self.att_b_dec,
                               self.att_w_full[:, 0], self.att_b_full[0])

    def init_state(self, features: torch.Tensor) -> DecoderState:
        """h0, c0 from Linear(mean(features)) chunked in two; the mean
        accumulates in f32 whatever the feature storage dtype."""
        mean = features.mean(dim=1, dtype=torch.float32)
        h, c = (mean @ self.init_w + self.init_b).chunk(2, dim=-1)
        return DecoderState(h.contiguous(), c.contiguous())

    def seq_weights(self) -> DecodeSeqWeights:
        step = pack_weights(self.att_w_dec, self.att_b_dec,
                            self.att_w_full[:, 0], self.att_b_full[0],
                            self.f_beta_w, self.f_beta_b, self.lstm_w_ih,
                            self.lstm_w_hh, self.lstm_b_ih, self.lstm_b_hh,
                            dim_embedding=self.dim_embedding)
        return DecodeSeqWeights(step, self.out_w, self.out_b[None, :],
                                self.embed)

    def greedy_sample(self, features: torch.Tensor, start_id: int, *,
                      max_length: int = 30,
                      end_id: Optional[int] = None) -> torch.Tensor:
        """Batched greedy decode: tokens [B, max_length] int32.

        Runs the whole-sequence kernel (ops/kernels/decode_seq.py,
        csrc/decode_seq.cu; its plain version for CPU tensors) in one call.
        ``end_id`` gives finished captions <end>-padding and stops the loop
        once every row is done; the detokenizer stops at the first <end>
        either way. Attention weights are not produced: the visualization
        path waits for a later slice.
        """
        proj = project_features(self.att_params(), features,
                                compute_dtype=torch.float32)
        state = self.init_state(features)
        return fused_greedy_decode(
            features.contiguous(), proj, state.h, state.c,
            self.seq_weights(), max_length=max_length, start_id=start_id,
            end_id=-1 if end_id is None else end_id)
