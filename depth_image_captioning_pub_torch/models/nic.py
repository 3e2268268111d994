"""NIC (Show and Tell) decoder (counterpart of the JAX ``models/nic.py``):
word embedding, a stacked LSTM primed by the image embedding at step 0,
and the vocab head.

Parameters keep the JAX names and [in, out] layout (``embed``,
``lstm{li}_w_ih``/``_w_hh``/``_b_ih``/``_b_hh``, ``out_w``, ``out_b``), so
the bridge from the JAX tree is a name-for-name copy. Greedy decode runs
the whole-sequence kernel of ``ops/kernels/nic_seq.py``
(``csrc/nic_seq.cu`` on a CUDA device, its plain version on the CPU); beam
search runs the generic search of ``ops/decode.py``, and stochastic
sampling a loop of plain ops with its filters and draw. The image embedding
takes the place of a token at step 0, so step 0 usually predicts <start>,
which the detokenizer skips. Training runs ``forward``, the teacher-forced
pass, on PyTorch ops under autograd (the JAX package's ``stacked_lstm``
scan of XLA ops; no kernel), its output dropout from a ``torch.Generator``
or a ``dropout_keep`` hook. A bf16 decoder (``dtype``, mixed-precision
training) runs the teacher-forced pass as the JAX module at
``dtype=bfloat16`` does: the LSTM's inputs, h and c rounded to bf16, the
products on the f32 parameters in f32, f32 logits; its decode paths
refuse it, as the JAX kernel path does.

Under tensor parallelism (``parallel/tp.shard_tree``: ``tp`` is the model
axis) the embedding's features and the vocab head's columns are split
over the model ranks, as the JAX rules split them, and gathered where
they are used; the kernel takes whole weights, so greedy decode runs the
step loop of PyTorch ops (``loop_greedy``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn

from depth_image_captioning_pub_torch.models.decoder import (
    check_decoder_dtype, refuse_mixed)
from depth_image_captioning_pub_torch.models.initializers import (
    normal, torch_bias, torch_linear_kernel)
from depth_image_captioning_pub_torch.ops.decode import (
    beam_search, dropout_masks, filtered_logits, gumbel_argmax, gumbel_noise,
    log_softmax, tile_for_beams)
from depth_image_captioning_pub_torch.ops.kernels.nic_seq import (
    NICSeqWeights, fused_nic_greedy_decode, pack_nic_weights)
from depth_image_captioning_pub_torch.ops.precision import full_f32
from depth_image_captioning_pub_torch.ops.lstm import (
    LSTMCellParams, StackedLSTMParams, stacked_lstm_step)
from depth_image_captioning_pub_torch.parallel.tp import (
    copy_to_region, gather_from_region)


class NICDecoder(nn.Module):
    """Stacked-LSTM decoder, float32 parameters; ``dtype`` is the
    teacher-forced pass's state dtype (f32, or bf16); ``tp``: the model
    axis of a tensor-parallel decoder."""

    tp = None

    def __init__(self, vocab_size: int, dim_embedding: int = 300,
                 dim_hidden: int = 128, num_layers: int = 2, device=None,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        check_decoder_dtype(dtype)
        self.dtype = dtype
        self.vocab_size = vocab_size
        self.dropout = dropout      # training only, on the LSTM outputs
        self.dim_hidden = dim_hidden
        self.num_layers = num_layers
        p, b = torch_linear_kernel, torch_bias
        g = 4 * dim_hidden
        # name -> (shape, initializer), in the JAX module's order; the
        # embedding keeps nn.Embedding's N(0, 1) (the reference does not
        # re-initialize NIC's embedding)
        self._inits = {"embed": ((vocab_size, dim_embedding), normal(1.0))}
        for li in range(num_layers):
            d_in = dim_embedding if li == 0 else dim_hidden
            self._inits.update({
                f"lstm{li}_w_ih": ((d_in, g), p),
                f"lstm{li}_w_hh": ((dim_hidden, g), p),
                f"lstm{li}_b_ih": ((g,), b(dim_hidden)),
                f"lstm{li}_b_hh": ((g,), b(dim_hidden)),
            })
        self._inits.update({"out_w": ((dim_hidden, vocab_size), p),
                            "out_b": ((vocab_size,), b(dim_hidden))})
        for name, (shape, _) in self._inits.items():
            self.register_parameter(name, nn.Parameter(torch.zeros(
                shape, dtype=torch.float32, device=device)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for name, (shape, init) in self._inits.items():
                getattr(self, name).copy_(init(shape, generator))

    def lstm(self) -> StackedLSTMParams:
        return StackedLSTMParams(tuple(
            LSTMCellParams(*(getattr(self, f"lstm{li}_{n}")
                             for n in ("w_ih", "w_hh", "b_ih", "b_hh")))
            for li in range(self.num_layers)))

    def seq_weights(self) -> NICSeqWeights:
        if self.tp is not None:
            raise ValueError("the NIC kernel takes whole weight matrices: "
                             "a tensor-parallel decoder runs its steps as "
                             "PyTorch ops")
        return pack_nic_weights(self.lstm(), self.out_w, self.out_b,
                                self.embed)

    def _embedding(self, ids: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``ids`` (gathered over ``tp``)."""
        emb = self.embed[ids]
        return emb if self.tp is None else gather_from_region(emb, self.tp,
                                                              -1)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """The vocab head on h (over ``tp``: this rank's vocabulary
        columns, gathered)."""
        if self.tp is None:
            return h @ self.out_w + self.out_b
        return gather_from_region(copy_to_region(h, self.tp) @ self.out_w
                                  + self.out_b, self.tp, -1)

    @full_f32()   # every f32 product, forward (and the caller's backward)
    def forward(self, features: torch.Tensor, captions: torch.Tensor, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_keep: Optional[Callable] = None) -> torch.Tensor:
        """Teacher forcing: logits [B, L, V] f32 for image embeddings [B,
        E] and padded captions [B, L]. Step 0 reads the image embedding and
        predicts captions[:, 0] (<start>); step t > 0 reads captions[:,
        t-1] and predicts captions[:, t]. ``train`` drops out the top
        layer's outputs (rate ``self.dropout``) with one keep-mask
        ``dropout_keep(0, [B, L, H])``, drawn from ``generator`` when the
        hook is None. A bf16 decoder casts the inputs and the state to
        bf16; the products and the logits stay f32."""
        emb = self._embedding(captions[:, :-1].long())
        xs = torch.cat([features[:, None, :].to(emb.dtype), emb],
                       dim=1).to(self.dtype)
        bsz = xs.shape[0]
        zeros = torch.zeros((self.num_layers, bsz, self.dim_hidden),
                            dtype=self.dtype, device=xs.device)
        hs, cs = zeros, zeros
        lstm = self.lstm()
        outs = []
        for t in range(xs.shape[1]):
            out, hs, cs = stacked_lstm_step(lstm, xs[:, t], hs, cs)
            outs.append(out)
        outs = torch.stack(outs, dim=1)
        if train and self.dropout > 0.0:
            keep = (dropout_keep or dropout_masks(generator, self.dropout))(
                0, tuple(outs.shape))
            outs = torch.where(keep, outs / (1.0 - self.dropout), 0.0)
        return self._logits(outs.to(torch.float32))

    @torch.no_grad()
    def greedy_sample(self, features: torch.Tensor, *,
                      max_length: int = 30) -> torch.Tensor:
        """Batched greedy decode of image embeddings [B, E]: tokens [B,
        max_length] int32, always ``max_length`` steps (no <end> exit), in
        one call of the whole-sequence kernel (a tensor-parallel decoder:
        ``loop_greedy``)."""
        refuse_mixed(self.dtype, "the NIC decode kernel")
        if self.tp is not None:
            return self.loop_greedy(features, max_length=max_length)
        return fused_nic_greedy_decode(
            features.to(torch.float32).contiguous(), self.seq_weights(),
            max_length=max_length)

    @torch.no_grad()
    @full_f32()   # the f32 LSTM and head products, without TF32
    def stochastic_sample(
            self, features: torch.Tensor,
            generator: Optional[torch.Generator], *, max_length: int = 30,
            temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
            noise: Optional[Callable[[int], torch.Tensor]] = None
            ) -> torch.Tensor:
        """Batched temperature / top-k / nucleus sampling of image
        embeddings [B, E]: tokens [B, max_length] int32, always
        ``max_length`` steps. Step 0 feeds the image embedding, each later
        step the previous token's embedding; the draw is as
        ``AttentionDecoder.stochastic_sample``'s (``noise(t)`` or
        ``generator``)."""
        refuse_mixed(self.dtype, "stochastic sampling")

        def choose(t, logits):
            filt = filtered_logits(logits, temperature=temperature,
                                   top_k=top_k, top_p=top_p)
            z = (noise(t) if noise is not None
                 else gumbel_noise(filt.shape, generator))
            return gumbel_argmax(filt, z)
        return self._step_loop(features, choose, max_length)

    @torch.no_grad()
    @full_f32()   # the f32 LSTM and head products, without TF32
    def loop_greedy(self, features: torch.Tensor, *,
                    max_length: int = 30) -> torch.Tensor:
        """Greedy decode as a loop of PyTorch ops, no kernel (the JAX
        package's XLA scan): what a tensor-parallel decoder runs; K3's
        tokens are this loop's up to the order of its f32 sums."""
        refuse_mixed(self.dtype, "greedy decode")
        return self._step_loop(
            features,
            lambda t, logits: torch.argmax(logits, dim=-1).to(torch.int32),
            max_length)

    def _step_loop(self, features: torch.Tensor, choose,
                   max_length: int) -> torch.Tensor:
        """``max_length`` steps of the stacked LSTM (the image embedding
        at step 0, then the previous token's embedding), the head and
        ``choose(t, logits)`` -> the token."""
        bsz = features.shape[0]
        zeros = torch.zeros((self.num_layers, bsz, self.dim_hidden),
                            dtype=torch.float32, device=features.device)
        hs, cs = zeros, zeros.clone()
        lstm = self.lstm()
        x = features.to(torch.float32)
        tokens = torch.empty((bsz, max_length), dtype=torch.int32,
                             device=features.device)
        for t in range(max_length):
            out, hs, cs = stacked_lstm_step(lstm, x, hs, cs)
            token = choose(t, self._logits(out))
            tokens[:, t] = token
            x = self._embedding(token.long())
        return tokens

    @torch.no_grad()
    @full_f32()   # the f32 LSTM and head products, without TF32
    def beam_sample(self, features: torch.Tensor, end_id: int, *,
                    beam_size: int = 5, max_length: int = 30,
                    length_penalty: float = 0.0, early_exit: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched beam search (ops/decode.beam_search): (tokens [B, L],
        scores [B]). Step 0 feeds the image embedding in place of the
        token."""
        refuse_mixed(self.dtype, "beam search")
        batch = features.shape[0]
        feats = tile_for_beams({"x": features.to(torch.float32)},
                               beam_size)["x"]
        zeros = torch.zeros((batch * beam_size, self.num_layers,
                             self.dim_hidden), dtype=torch.float32,
                            device=features.device)
        lstm = self.lstm()

        def step_fn(state, prev, t):
            # the search gathers along dim 0, so state is [B*W, layers, H]
            hs = state["h"].transpose(0, 1)
            cs = state["c"].transpose(0, 1)
            x = feats if t == 0 else self._embedding(prev.long())
            out, hs, cs = stacked_lstm_step(lstm, x, hs, cs)
            logits = self._logits(out)
            return ({"h": hs.transpose(0, 1), "c": cs.transpose(0, 1)},
                    log_softmax(logits))

        return beam_search(step_fn, {"h": zeros, "c": zeros.clone()}, batch,
                           start_id=0, end_id=end_id, beam_size=beam_size,
                           max_length=max_length,
                           length_penalty=length_penalty,
                           early_exit=early_exit)
