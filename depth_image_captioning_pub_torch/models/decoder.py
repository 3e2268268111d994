"""Attention LSTM caption decoder (counterpart of the JAX
``models/decoder.py``), soft attention with ``"none"`` or ``"add"`` depth
fusion (concat fusion waits for the ``mdepth-*`` slice).

Parameters keep the JAX names and [in, out] layout as plain
``nn.Parameter``s (``att_w_enc``, ``lstm_w_ih``, ``out_w``, ...), so the
bridge from the JAX parameter tree is a name-for-name copy and
``pack_weights`` is a slice and reshape.

Greedy decode runs the whole-sequence kernel of
``ops/kernels/decode_seq.py`` (``csrc/decode_seq.cu`` on a CUDA device,
its plain PyTorch version on the CPU), beam search the whole-search kernel
of ``ops/kernels/beam_seq.py`` (``csrc/beam_seq.cu``), and stochastic
sampling a Python loop of one-step kernels (``ops/kernels/decode_step.py``,
``csrc/decode_step.cu``), each followed by the vocab head, the filters and
the draw of ``ops/decode.py``. Encoder features may stay bf16 in device
memory: the projection, the initial state and the kernels upcast them
exactly, and all decoder arithmetic is f32.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from depth_image_captioning_pub_torch.models.initializers import (
    torch_bias, torch_linear_kernel, uniform_pm)
from depth_image_captioning_pub_torch.ops.attention import (
    AttentionParams, project_features)
from depth_image_captioning_pub_torch.ops.decode import (
    filtered_logits, gumbel_argmax, gumbel_noise)
from depth_image_captioning_pub_torch.ops.kernels.beam_seq import (
    fused_beam_decode, select_best)
from depth_image_captioning_pub_torch.ops.kernels.decode_seq import (
    DecodeSeqWeights, fused_greedy_decode)
from depth_image_captioning_pub_torch.ops.kernels.decode_step import (
    fused_decode_core, pack_weights)
from depth_image_captioning_pub_torch.ops.precision import full_f32


class DecoderState(NamedTuple):
    h: torch.Tensor  # [B, H]
    c: torch.Tensor  # [B, H]


FUSIONS = ("none", "add")


class AttentionDecoder(nn.Module):
    """Soft-attention LSTM decoder, float32 parameters, with ``"none"`` or
    ``"add"`` fusion of depth annotation vectors (hard attention and concat
    fusion wait for their slices)."""

    def __init__(self, vocab_size: int, dim_attention: int = 128,
                 dim_embedding: int = 128, dim_encoder: int = 2048,
                 dim_decoder: int = 128, fusion: str = "none", device=None):
        super().__init__()
        if fusion not in FUSIONS:
            raise NotImplementedError(f"fusion {fusion!r} is not ported yet; "
                                      f"this package has {FUSIONS}")
        self.vocab_size = vocab_size
        self.fusion = fusion
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

    def fuse(self, features: torch.Tensor,
             depth_features: Optional[torch.Tensor]) -> torch.Tensor:
        """Join RGB and depth annotation vectors. ``"add"`` sums them in
        their storage dtype (bf16 + bf16 rounds to bf16, as in the JAX
        package), and the sum stays in that dtype for the decoder."""
        if self.fusion == "none" or depth_features is None:
            return features
        return features + depth_features

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

    @torch.no_grad()
    @full_f32()   # the f32 projection and h0/c0 products, without TF32
    def greedy_sample(self, features: torch.Tensor, start_id: int,
                      depth_features: Optional[torch.Tensor] = None, *,
                      max_length: int = 30,
                      end_id: Optional[int] = None) -> torch.Tensor:
        """Batched greedy decode: tokens [B, max_length] int32.

        Fuses ``depth_features`` into ``features`` (``fuse``), then runs
        the whole-sequence kernel (ops/kernels/decode_seq.py,
        csrc/decode_seq.cu; its plain version for CPU tensors) in one call.
        ``end_id`` gives finished captions <end>-padding and stops the loop
        once every row is done; the detokenizer stops at the first <end>
        either way. Attention weights are not produced: the visualization
        path waits for a later slice.
        """
        features = self.fuse(features, depth_features)
        proj = project_features(self.att_params(), features,
                                compute_dtype=torch.float32)
        state = self.init_state(features)
        return fused_greedy_decode(
            features.contiguous(), proj, state.h, state.c,
            self.seq_weights(), max_length=max_length, start_id=start_id,
            end_id=-1 if end_id is None else end_id)

    @torch.no_grad()
    @full_f32()   # the f32 projection, h0/c0 and head products
    def stochastic_sample(
            self, features: torch.Tensor, start_id: int,
            generator: Optional[torch.Generator],
            depth_features: Optional[torch.Tensor] = None, *,
            max_length: int = 30, temperature: float = 1.0, top_k: int = 0,
            top_p: float = 1.0,
            noise: Optional[Callable[[int], torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched temperature / top-k / nucleus sampling: (tokens [B,
        max_length] int32, alphas [B, max_length, K] f32).

        Set-up as ``greedy_sample``, then ``max_length`` steps (no early
        exit, as the JAX scan), each: the embedding of the previous token,
        one step kernel (``fused_decode_core``: h', c', alpha), the vocab
        head, ``filtered_logits`` and a Gumbel-argmax draw. The noise of
        step t is ``noise(t)`` [B, V] when given (the tests feed the JAX
        package's draws), else drawn from ``generator``.
        Deterministic per generator state; top_k=1 gives greedy argmax.
        """
        features = self.fuse(features, depth_features).contiguous()
        proj = project_features(self.att_params(), features,
                                compute_dtype=torch.float32)
        h, c = self.init_state(features)
        w = self.seq_weights()
        bsz, k = features.shape[:2]
        tokens = torch.empty((bsz, max_length), dtype=torch.int32,
                             device=features.device)
        alphas = torch.empty((bsz, max_length, k), dtype=torch.float32,
                             device=features.device)
        prev = torch.full((bsz,), start_id, dtype=torch.int64,
                          device=features.device)
        for t in range(max_length):
            h, c, alpha = fused_decode_core(features, proj, w.embed[prev],
                                            h, c, w.step)
            filt = filtered_logits(h @ w.w_out + w.b_out,
                                   temperature=temperature, top_k=top_k,
                                   top_p=top_p)
            z = (noise(t) if noise is not None
                 else gumbel_noise(filt.shape, generator))
            token = gumbel_argmax(filt, z)
            tokens[:, t] = token
            alphas[:, t] = alpha
            prev = token.long()
        return tokens, alphas

    @torch.no_grad()
    @full_f32()
    def beam_sample(self, features: torch.Tensor, start_id: int,
                    end_id: int,
                    depth_features: Optional[torch.Tensor] = None, *,
                    beam_size: int = 5, max_length: int = 30,
                    length_penalty: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched beam search: (tokens [B, max_length] int32 of the best
        beam, its score [B]).

        Fuses ``depth_features`` into ``features``, then runs the whole
        search in one call (ops/kernels/beam_seq.py, csrc/beam_seq.cu; its
        plain version for CPU tensors), which stops once every beam has
        emitted <end>. ``length_penalty`` alpha ranks the final beams by
        score / length**alpha (GNMT); 0 ranks by log-probability.
        """
        features = self.fuse(features, depth_features)
        proj = project_features(self.att_params(), features,
                                compute_dtype=torch.float32)
        state = self.init_state(features)
        out = fused_beam_decode(
            features.contiguous(), proj, state.h, state.c,
            self.seq_weights(), beam_size=beam_size, max_length=max_length,
            start_id=start_id, end_id=end_id)
        return select_best(out, end_id, length_penalty)
