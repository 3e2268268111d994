"""Attention LSTM caption decoder (counterpart of the JAX
``models/decoder.py``): soft or hard attention, with ``"none"``, ``"add"``
or ``"concat"`` fusion of depth annotation vectors.

Parameters keep the JAX names and [in, out] layout as plain
``nn.Parameter``s (``att_w_enc``, ``lstm_w_ih``, ``out_w``, ...), so the
bridge from the JAX parameter tree is a name-for-name copy and
``pack_weights`` is a slice and reshape.

Soft attention decodes on the kernels: greedy decode runs the
whole-sequence kernel of ``ops/kernels/decode_seq.py``
(``csrc/decode_seq.cu`` on a CUDA device, its plain PyTorch version on the
CPU), beam search the whole-search kernel of ``ops/kernels/beam_seq.py``
(``csrc/beam_seq.cu``), and stochastic sampling a Python loop of one-step
kernels (``ops/kernels/decode_step.py``, ``csrc/decode_step.cu``), each
followed by the vocab head, the filters and the draw of ``ops/decode.py``.
Hard attention has no TPU kernel (the JAX package runs it on XLA alone), so
its three paths are Python loops of PyTorch ops: each step draws Gumbel
noise over the K regions (``att_noise(t, shape)``, by default
``ops/decode.region_noise`` of a ``torch.Generator``), attends to the one
region ``ops/attention.gumbel_max_attention`` picks, and runs the gated
context, the LSTM cell and the head. Encoder features may stay bf16 in
device memory: the projection, the initial state, the kernels and the
gather upcast them exactly, and all decoder arithmetic is f32. Concat
fusion promotes bf16 RGB and f32 depth features to f32, as JAX does.

Training runs ``forward``, the teacher-forced pass of the JAX module's
``__call__``, on PyTorch ops under autograd: one Python loop over the
caption's steps (no kernel; the JAX package runs it as one ``lax.scan`` of
XLA ops), its dropout keep-masks and hard attention's Gumbel noise from a
``torch.Generator`` or from the ``dropout_keep(t, shape)`` and
``att_noise(t, shape)`` hooks, through which the tests replay the JAX
package's draws.

Under tensor parallelism (``parallel/tp.shard_tree``: ``tp`` is the model
axis) the vocab head, the LSTM's gate columns and the embedding's features
are split over the model ranks; the embedding rows, the gates and the
logits are gathered before they are used, so everything else runs
replicated. The kernels take whole weight matrices, so such a decoder
never reaches them: its greedy decode, sampling, ``greedy_alphas`` and
beam search run their steps as PyTorch ops with the collectives (soft
attention in f32, the counterpart of the JAX package's XLA paths), and
training the teacher-forced pass.

Mixed precision (``dtype=torch.bfloat16``, the JAX ``decoder_dtype``, for
training only): the parameters stay f32 and the teacher-forced pass casts
them to bf16 at each use, as the JAX module's ``_w`` does, so every op
runs in the dtype of its JAX counterpart: the features, the attention
(the softmax in f32), the gate and the LSTM's h and c in bf16; the LSTM
gates and the vocab head accumulate in f32 (``ops/precision.matmul_f32``)
and the logits are f32. The decode paths refuse such a decoder, as the
JAX package's kernel paths refuse it: evaluation builds an f32 decoder
from the trained f32 parameters.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from depth_image_captioning_pub_torch.models.initializers import (
    torch_bias, torch_linear_kernel, uniform_pm)
from depth_image_captioning_pub_torch.ops.attention import (
    AttentionParams, gumbel_max_attention, gumbel_softmax_attention,
    project_features, soft_attention)
from depth_image_captioning_pub_torch.ops.decode import (
    beam_search, dropout_masks, filtered_logits, gumbel_argmax, gumbel_noise,
    log_softmax, region_noise, tile_for_beams)
from depth_image_captioning_pub_torch.ops.kernels.beam_seq import (
    fused_beam_decode, select_best)
from depth_image_captioning_pub_torch.ops.kernels.decode_seq import (
    DecodeSeqWeights, fused_greedy_decode)
from depth_image_captioning_pub_torch.ops.kernels.decode_step import (
    fused_decode_core, pack_weights)
from depth_image_captioning_pub_torch.ops.lstm import LSTMCellParams, lstm_cell
from depth_image_captioning_pub_torch.ops.precision import (
    full_f32, matmul_f32)
from depth_image_captioning_pub_torch.parallel.tp import (
    copy_to_region, gather_from_region)
from depth_image_captioning_pub_torch.utils import tracing

AttNoise = Callable[[int, Sequence[int]], torch.Tensor]


class DecoderState(NamedTuple):
    h: torch.Tensor  # [B, H]
    c: torch.Tensor  # [B, H]


FUSIONS = ("none", "add", "concat")
ATTENTION_KINDS = ("soft", "hard")
DECODER_DTYPES = (torch.float32, torch.bfloat16)


def check_decoder_dtype(dtype: torch.dtype) -> None:
    if dtype not in DECODER_DTYPES:
        raise ValueError(f"decoder dtype {dtype} is not one of "
                         f"{DECODER_DTYPES}")


def refuse_mixed(dtype: torch.dtype, what: str) -> None:
    """The decode paths and their kernels take an f32 decoder only (the
    JAX package's kernel paths refuse another dtype)."""
    if dtype != torch.float32:
        raise ValueError(f"{what} requires a float32 decoder (got "
                         f"dtype={dtype}); the {dtype} decoder is for "
                         f"training: caption with a float32 decoder on "
                         f"the same parameters")


class AttentionDecoder(nn.Module):
    """Soft- or hard-attention LSTM decoder, float32 parameters, with
    ``"none"``, ``"add"`` or ``"concat"`` fusion of depth annotation
    vectors; concat widens the annotation vectors by ``dim_depth``.
    ``dtype`` is the teacher-forced pass's compute dtype (f32, or bf16
    for mixed-precision training). ``tp``: the model axis of a
    tensor-parallel decoder (``parallel/tp.shard_tree``)."""

    tp = None

    def __init__(self, vocab_size: int, dim_attention: int = 128,
                 dim_embedding: int = 128, dim_encoder: int = 2048,
                 dim_decoder: int = 128, fusion: str = "none", device=None,
                 attention_kind: str = "soft", dim_depth: int = 32,
                 dropout: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        check_decoder_dtype(dtype)
        self.dtype = dtype
        if fusion not in FUSIONS:
            raise ValueError(f"unknown fusion {fusion!r}; one of {FUSIONS}")
        if attention_kind not in ATTENTION_KINDS:
            raise ValueError(f"unknown attention kind {attention_kind!r}; "
                             f"one of {ATTENTION_KINDS}")
        self.vocab_size = vocab_size
        self.fusion = fusion
        self.attention_kind = attention_kind
        self.dropout = dropout          # training only, on h before the head
        self.dim_embedding = dim_embedding
        self.dim_enc_eff = dim_encoder + (dim_depth if fusion == "concat"
                                          else 0)
        d_enc, d_att, d_dec, d_emb = (self.dim_enc_eff, dim_attention,
                                      dim_decoder, dim_embedding)
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
        package), and the sum stays in that dtype for the decoder.
        ``"concat"`` joins them along the channels in their promoted dtype
        (bf16 RGB and f32 depth give f32, as ``jnp.concatenate``)."""
        if self.fusion == "none" or depth_features is None:
            return features
        if self.fusion == "add":
            return features + depth_features
        dt = torch.promote_types(features.dtype, depth_features.dtype)
        return torch.cat([features.to(dt), depth_features.to(dt)], dim=-1)

    def _w(self, p: torch.Tensor) -> torch.Tensor:
        """A parameter in the compute dtype (the JAX module's ``_w``): the
        parameter itself for an f32 decoder."""
        return p.to(self.dtype)

    def init_state(self, features: torch.Tensor) -> DecoderState:
        """h0, c0 from Linear(mean(features)) chunked in two; the mean
        accumulates in f32 whatever the feature storage dtype, then takes
        the compute dtype."""
        mean = features.mean(dim=1, dtype=torch.float32).to(self.dtype)
        h, c = (mean @ self._w(self.init_w)
                + self._w(self.init_b)).chunk(2, dim=-1)
        return DecoderState(h.contiguous(), c.contiguous())

    def seq_weights(self) -> DecodeSeqWeights:
        """The kernels' packed weights (K1, K2, K4: f32 decoders only,
        whole weights)."""
        refuse_mixed(self.dtype, "the decode kernels")
        if self.tp is not None:
            raise ValueError("the decode kernels take whole weight "
                             "matrices: a tensor-parallel decoder runs its "
                             "steps as PyTorch ops")
        step = pack_weights(self.att_w_dec, self.att_b_dec,
                            self.att_w_full[:, 0], self.att_b_full[0],
                            self.f_beta_w, self.f_beta_b, self.lstm_w_ih,
                            self.lstm_w_hh, self.lstm_b_ih, self.lstm_b_hh,
                            dim_embedding=self.dim_embedding)
        return DecodeSeqWeights(step, self.out_w, self.out_b[None, :],
                                self.embed)

    def _cell_params(self):
        """(f_beta_w, f_beta_b, LSTMCellParams) in the compute dtype, cast
        once for a whole teacher-forced pass."""
        return (self._w(self.f_beta_w), self._w(self.f_beta_b),
                LSTMCellParams(self._w(self.lstm_w_ih),
                               self._w(self.lstm_w_hh),
                               self._w(self.lstm_b_ih),
                               self._w(self.lstm_b_hh)))

    def _cell(self, context: torch.Tensor, emb: torch.Tensor,
              h: torch.Tensor, c: torch.Tensor, params=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The f_beta gate on the context and the LSTM cell on [emb | gate
        * context] -> (h', c'), on ``params`` (``_cell_params()``)."""
        f_beta_w, f_beta_b, lstm = params or self._cell_params()
        gate = torch.sigmoid(h @ f_beta_w + f_beta_b)
        return lstm_cell(lstm, torch.cat([emb, gate * context], dim=-1), h, c,
                         self.tp)

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

    def _tail(self, context: torch.Tensor, emb: torch.Tensor,
              h: torch.Tensor, c: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The step after the attention (JAX ``_step``): ``_cell`` and the
        vocab head -> (h', c', logits)."""
        h, c = self._cell(context, emb, h, c)
        return h, c, self._logits(h)

    @full_f32()   # every f32 product, forward (and the caller's backward)
    def forward(self, features: torch.Tensor, captions: torch.Tensor,
                depth_features: Optional[torch.Tensor] = None, *,
                train: bool = False, temp=1.0,
                hard_eval_sampling: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_keep: Optional[AttNoise] = None,
                att_noise: Optional[AttNoise] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher forcing over the padded captions [B, L]: (logits [B, L-1,
        V] f32, alphas [B, L-1, K] in the compute dtype); step t reads
        captions[:, t] and predicts captions[:, t+1] (the JAX module's
        ``__call__``).

        The fused features are upcast to f32 once (exact; every step's
        attention product reads that copy, which autograd saves once);
        their projection and the initial state come from it. ``train``
        turns on the training noise unless ``hard_eval_sampling`` (the JAX
        flag of the hard validation pass) is set: dropout (rate
        ``self.dropout``) on h before the head, with keep-masks
        ``dropout_keep(t, [B, H])``, and hard attention's Gumbel-softmax at
        temperature ``temp`` on ``att_noise(t, [B, K])``; without the
        training noise hard attention takes the Gumbel-max region on the
        same noise source. Hooks left None draw from ``generator``. The
        vocab head runs once over all steps.

        A bf16 decoder runs the same ops as the JAX module's ``__call__``
        at ``dtype=bfloat16``: the fused features cast to bf16; their
        projection, the initial state (the mean accumulated in f32, then
        rounded), the embedding, the attention (softmax in f32), the
        f_beta gate and the LSTM's h and c in bf16 on the parameters cast
        at each use (``_w``); the LSTM gates and the vocab head accumulate
        in f32 (``matmul_f32``) and the logits are f32 (the head's bias
        stays f32); alphas come back bf16. For an f32 decoder every cast
        is the tensor itself.
        """
        feats = self.fuse(features, depth_features).to(self.dtype)
        att = AttentionParams(*(self._w(t) for t in self.att_params()))
        proj = project_features(att, feats)
        h, c = self.init_state(feats)
        emb = self._w(self.embed)[captions[:, :-1].long()]   # [B, L-1, E]
        if self.tp is not None:
            emb = gather_from_region(emb, self.tp, -1)
        cell = self._cell_params()
        stochastic = train and not hard_eval_sampling
        hard = self.attention_kind == "hard"
        if hard and att_noise is None:
            att_noise = region_noise(generator)
        drop = stochastic and self.dropout > 0.0
        if drop and dropout_keep is None:
            dropout_keep = dropout_masks(generator, self.dropout)
        bsz, k = feats.shape[:2]
        outs, alphas = [], []
        for t in range(emb.shape[1]):
            if not hard:
                ctx, alpha = soft_attention(att, feats, proj, h)
            elif stochastic:
                ctx, alpha = gumbel_softmax_attention(
                    att, feats, proj, h, temp, att_noise(t, (bsz, k)))
            else:
                ctx, alpha = gumbel_max_attention(
                    att, feats, proj, h, att_noise(t, (bsz, k)))
            h, c = self._cell(ctx, emb[:, t], h, c, cell)
            out = h
            if drop:
                keep = dropout_keep(t, tuple(h.shape))
                out = torch.where(keep, out / (1.0 - self.dropout), 0.0)
            outs.append(out)
            alphas.append(alpha)
        outs = torch.stack(outs, 1)
        if self.tp is not None:
            outs = copy_to_region(outs, self.tp)
        logits = matmul_f32(outs, self._w(self.out_w)) + self.out_b
        if self.tp is not None:
            logits = gather_from_region(logits, self.tp, -1)
        return logits, torch.stack(alphas, 1)

    def _prepare(self, features, depth_features):
        """(fused features, f32 projection, h0, c0)."""
        features = self.fuse(features, depth_features)
        proj = project_features(self.att_params(), features,
                                compute_dtype=torch.float32)
        h, c = self.init_state(features)
        return features, proj, h, c

    @torch.no_grad()
    @full_f32()   # the f32 projection and h0/c0 products, without TF32
    def greedy_sample(self, features: torch.Tensor, start_id: int,
                      depth_features: Optional[torch.Tensor] = None, *,
                      max_length: int = 30,
                      end_id: Optional[int] = None,
                      generator: Optional[torch.Generator] = None,
                      att_noise: Optional[AttNoise] = None) -> torch.Tensor:
        """Batched greedy decode: tokens [B, max_length] int32.

        Fuses ``depth_features`` into ``features`` (``fuse``). Soft
        attention runs the whole-sequence kernel (ops/kernels/decode_seq.py,
        csrc/decode_seq.cu; its plain version for CPU tensors) in one call.
        ``end_id`` gives finished captions <end>-padding and stops the loop
        once every row is done; the detokenizer stops at the first <end>
        either way. Attention weights are not produced here:
        ``greedy_alphas`` decodes with them.

        Hard attention runs ``_hard_greedy``: all ``max_length`` steps of
        PyTorch ops, the region noise of step t from ``att_noise(t, [B,
        K])`` or ``generator``. A tensor-parallel soft decoder runs
        ``loop_greedy``. With ``utils/tracing`` on, each adds the rows times
        the steps it ran to the counter ``decode.steps_run``.
        """
        refuse_mixed(self.dtype, "greedy decode")
        if self.attention_kind == "hard":
            return self._hard_greedy(
                features, start_id, depth_features, max_length=max_length,
                end_id=end_id, att_noise=att_noise or region_noise(generator))
        if self.tp is not None:
            return self.loop_greedy(features, start_id, depth_features,
                                    max_length=max_length, end_id=end_id)
        features, proj, h, c = self._prepare(features, depth_features)
        return fused_greedy_decode(
            features.contiguous(), proj, h, c, self.seq_weights(),
            max_length=max_length, start_id=start_id,
            end_id=-1 if end_id is None else end_id)

    @torch.no_grad()
    @full_f32()
    def loop_greedy(self, features: torch.Tensor, start_id: int,
                    depth_features: Optional[torch.Tensor] = None, *,
                    max_length: int = 30,
                    end_id: Optional[int] = None) -> torch.Tensor:
        """Soft greedy decode as a loop of PyTorch ops, no kernel: soft
        attention in f32, the gated context, the LSTM cell, the head and
        the argmax a step (the JAX package's XLA scan). What a
        tensor-parallel decoder runs, whose split weights the kernels
        cannot take; K2's tokens are this loop's up to the order of its f32
        sums."""
        refuse_mixed(self.dtype, "greedy decode")
        if self.attention_kind != "soft":
            raise ValueError("loop_greedy decodes with soft attention")
        att = self.att_params()
        return self._step_greedy(
            features, start_id, depth_features, max_length=max_length,
            end_id=end_id, attend=lambda t, f, proj, h: soft_attention(
                att, f, proj, h, torch.float32)[0])

    def _hard_greedy(self, features, start_id, depth_features, *,
                     max_length: int, end_id: Optional[int],
                     att_noise: AttNoise) -> torch.Tensor:
        """Hard-attention greedy decode, the counterpart of JAX
        ``_greedy_sample_early_exit``: each step attends to the region
        ``gumbel_max_attention`` draws, runs the gated context, the LSTM
        cell and the head, and takes the argmax; with ``end_id`` a finished
        row emits <end> from then on. JAX stops its ``while_loop`` once
        every row is done; this loop runs all ``max_length`` steps with the
        done-mask instead and never waits on the card. The tokens are the
        same: JAX's noise of step t depends on t alone (``fold_in(rng,
        t)``), and a finished row's tokens are <end> either way."""
        att = self.att_params()

        def attend(t, features, proj, h):
            return gumbel_max_attention(att, features, proj, h, att_noise(
                t, tuple(features.shape[:2])), torch.float32)[0]
        return self._step_greedy(features, start_id, depth_features,
                                 max_length=max_length, end_id=end_id,
                                 attend=attend)

    def _step_greedy(self, features, start_id, depth_features, *,
                     max_length: int, end_id: Optional[int],
                     attend) -> torch.Tensor:
        """Greedy decode as a loop of PyTorch ops: each step the context
        ``attend(t, features, proj, h)``, the gated context, the LSTM cell,
        the head and the argmax (the lowest index on ties); with ``end_id``
        a finished row emits <end> from then on."""
        features, proj, h, c = self._prepare(features, depth_features)
        bsz = features.shape[0]
        dev = features.device
        tokens = torch.empty((bsz, max_length), dtype=torch.int32,
                             device=dev)
        prev = torch.full((bsz,), start_id, dtype=torch.int64, device=dev)
        done = torch.zeros((bsz,), dtype=torch.bool, device=dev)
        for t in range(max_length):
            ctx = attend(t, features, proj, h)
            h, c, logits = self._tail(ctx, self._embedding(prev), h, c)
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            if end_id is not None:
                token = torch.where(done, end_id, token)
                done = done | (token == end_id)
            tokens[:, t] = token
            prev = token.long()
        tracing.count("decode.steps_run", bsz * max_length)
        return tokens

    @torch.no_grad()
    @full_f32()   # the f32 projection, h0/c0 and head products
    def stochastic_sample(
            self, features: torch.Tensor, start_id: int,
            generator: Optional[torch.Generator],
            depth_features: Optional[torch.Tensor] = None, *,
            max_length: int = 30, temperature: float = 1.0, top_k: int = 0,
            top_p: float = 1.0,
            noise: Optional[Callable[[int], torch.Tensor]] = None,
            att_noise: Optional[AttNoise] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched temperature / top-k / nucleus sampling: (tokens [B,
        max_length] int32, alphas [B, max_length, K] f32).

        Set-up as ``greedy_sample``, then ``max_length`` steps (no early
        exit, as the JAX scan), each: the embedding of the previous token,
        the attention-LSTM step, the vocab head, ``filtered_logits`` and a
        Gumbel-argmax draw. Soft attention runs the step as one kernel
        (``fused_decode_core``: h', c', alpha); hard attention draws the
        step's region first (``gumbel_max_attention``, one-hot alphas) and
        runs the rest in PyTorch ops. The token noise of step t is
        ``noise(t)`` [B, V] and hard attention's region noise ``att_noise(t,
        [B, K])`` when given (the tests feed the JAX package's draws), else
        drawn from ``generator``. Deterministic per generator state; top_k=1
        gives greedy argmax.
        """
        refuse_mixed(self.dtype, "stochastic sampling")

        def choose(t, logits):
            filt = filtered_logits(logits, temperature=temperature,
                                   top_k=top_k, top_p=top_p)
            z = (noise(t) if noise is not None
                 else gumbel_noise(filt.shape, generator))
            return gumbel_argmax(filt, z)

        return self._alpha_loop(features, start_id, depth_features, choose,
                                max_length=max_length,
                                att_noise=self._regions(att_noise, generator))

    @torch.no_grad()
    @full_f32()   # the f32 projection, h0/c0 and head products
    def greedy_alphas(self, features: torch.Tensor, start_id: int,
                      depth_features: Optional[torch.Tensor] = None, *,
                      max_length: int = 30,
                      generator: Optional[torch.Generator] = None,
                      att_noise: Optional[AttNoise] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched greedy decode with the attention weights: (tokens [B,
        max_length] int32, alphas [B, max_length, K] f32), the JAX
        ``greedy_sample``'s pair without ``end_id`` (sample mode's
        overlays). All ``max_length`` steps run, each as
        ``stochastic_sample``'s step with ``torch.argmax`` of the logits
        (the lowest index on ties, as ``jnp.argmax``) in place of the
        draw: soft attention runs the step kernel (K1) and returns its
        alphas, hard attention the region draw of ``att_noise(t, [B, K])``
        or ``generator`` and its one-hot alphas."""
        refuse_mixed(self.dtype, "greedy decode")
        return self._alpha_loop(
            features, start_id, depth_features,
            lambda t, logits: torch.argmax(logits, dim=-1).to(torch.int32),
            max_length=max_length,
            att_noise=self._regions(att_noise, generator))

    def _regions(self, att_noise: Optional[AttNoise],
                 generator: Optional[torch.Generator]
                 ) -> Optional[AttNoise]:
        """Hard attention's region noise: the hook, else draws from
        ``generator``; None for soft attention."""
        if self.attention_kind != "hard":
            return None
        return att_noise or region_noise(generator)

    def _alpha_loop(self, features, start_id, depth_features, choose, *,
                    max_length: int, att_noise: Optional[AttNoise]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``max_length`` steps of (embedding of the previous token, the
        attention-LSTM step, the vocab head, ``choose(t, logits)`` -> the
        token) -> (tokens, alphas). Soft attention runs the step as one
        kernel (``fused_decode_core``: h', c', alpha); hard attention draws
        the step's region first (``gumbel_max_attention`` on ``att_noise``,
        one-hot alphas) and runs the rest in PyTorch ops; so does a
        tensor-parallel decoder with soft attention in f32."""
        features, proj, h, c = self._prepare(features, depth_features)
        features = features.contiguous()
        hard = self.attention_kind == "hard"
        ops = hard or self.tp is not None    # the step in PyTorch ops
        if ops:
            att = self.att_params()
        else:
            w = self.seq_weights()
        bsz, k = features.shape[:2]
        tokens = torch.empty((bsz, max_length), dtype=torch.int32,
                             device=features.device)
        alphas = torch.empty((bsz, max_length, k), dtype=torch.float32,
                             device=features.device)
        prev = torch.full((bsz,), start_id, dtype=torch.int64,
                          device=features.device)
        for t in range(max_length):
            if ops:
                if hard:
                    ctx, alpha = gumbel_max_attention(
                        att, features, proj, h, att_noise(t, (bsz, k)),
                        torch.float32)
                else:
                    ctx, alpha = soft_attention(att, features, proj, h,
                                                torch.float32)
                h, c, logits = self._tail(ctx, self._embedding(prev), h, c)
            else:
                h, c, alpha = fused_decode_core(features, proj,
                                                w.embed[prev], h, c, w.step)
                logits = h @ w.w_out + w.b_out
            token = choose(t, logits)
            tokens[:, t] = token
            alphas[:, t] = alpha
            prev = token.long()
        tracing.count("decode.steps_run", bsz * max_length)
        return tokens, alphas

    @torch.no_grad()
    @full_f32()
    def beam_sample(self, features: torch.Tensor, start_id: int,
                    end_id: int,
                    depth_features: Optional[torch.Tensor] = None, *,
                    beam_size: int = 5, max_length: int = 30,
                    length_penalty: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    att_noise: Optional[AttNoise] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched beam search: (tokens [B, max_length] int32 of the best
        beam, its score [B]).

        Fuses ``depth_features`` into ``features``. Soft attention runs the
        whole search in one call (ops/kernels/beam_seq.py,
        csrc/beam_seq.cu; its plain version for CPU tensors), which stops
        once every beam has emitted <end>. Hard attention runs
        ``ops/decode.beam_search`` over PyTorch steps (``_hard_beam``), and
        so does a tensor-parallel soft decoder (``_loop_beam``).
        ``length_penalty`` alpha ranks the final beams by score /
        length**alpha (GNMT); 0 ranks by log-probability.
        """
        refuse_mixed(self.dtype, "beam search")
        if self.attention_kind == "hard":
            return self._hard_beam(
                features, start_id, end_id, depth_features,
                beam_size=beam_size, max_length=max_length,
                length_penalty=length_penalty,
                att_noise=att_noise or region_noise(generator))
        if self.tp is not None:
            att = self.att_params()

            def attend(t, features, proj, h):
                alpha = torch.softmax(self._beam_scores(
                    att, proj, h).to(torch.float32), dim=-1)
                return torch.bmm(alpha, features.to(torch.float32)).reshape(
                    h.shape[0], -1)
            return self._loop_beam(
                features, start_id, end_id, depth_features,
                beam_size=beam_size, max_length=max_length,
                length_penalty=length_penalty, attend=attend)
        features, proj, h, c = self._prepare(features, depth_features)
        out = fused_beam_decode(
            features.contiguous(), proj, h, c, self.seq_weights(),
            beam_size=beam_size, max_length=max_length, start_id=start_id,
            end_id=end_id)
        return select_best(out, end_id, length_penalty)

    def _hard_beam(self, features, start_id, end_id, depth_features, *,
                   beam_size: int, max_length: int, length_penalty: float,
                   att_noise: AttNoise) -> Tuple[torch.Tensor, torch.Tensor]:
        """Hard-attention beam search, the counterpart of JAX
        ``beam_sample``'s XLA path with ``early_exit``: one [B, W, K] noise
        draw a step (``att_noise(t, [B, W, K])``), each beam attending over
        its image's features, which stay [B, K, D] (never tiled by beam),
        then the gated context, the LSTM cell, the head and a log-softmax
        per beam, and the search of ``ops/decode.beam_search``."""
        att = self.att_params()

        def attend(t, features, proj, h):
            bsz, k = features.shape[:2]
            beam = h.shape[0] // bsz
            logits = self._beam_scores(att, proj, h)          # [B, W, K]
            pos = torch.argmax(logits + att_noise(t, (bsz, beam, k)), dim=-1)
            rows = torch.arange(bsz, device=features.device)[:, None]
            return features[rows, pos].to(torch.float32).reshape(
                bsz * beam, -1)
        return self._loop_beam(features, start_id, end_id, depth_features,
                               beam_size=beam_size, max_length=max_length,
                               length_penalty=length_penalty, attend=attend)

    @staticmethod
    def _beam_scores(att: AttentionParams, proj: torch.Tensor,
                     h: torch.Tensor) -> torch.Tensor:
        """Each beam's attention scores over its image's regions: h [B *
        W, H] against proj [B, K, A] -> [B, W, K]."""
        bsz = proj.shape[0]
        dec = h.reshape(bsz, h.shape[0] // bsz, -1) @ att.w_dec + att.b_dec
        act = torch.relu(proj[:, None] + dec[:, :, None, :])
        return act @ att.w_full + att.b_full

    def _loop_beam(self, features, start_id, end_id, depth_features, *,
                   beam_size: int, max_length: int, length_penalty: float,
                   attend) -> Tuple[torch.Tensor, torch.Tensor]:
        """Beam search over PyTorch steps: each step the beams' contexts
        ``attend(t, features, proj, h)`` [B * W, D], the gated context,
        the LSTM cell, the head and a log-softmax per beam, and the search
        of ``ops/decode.beam_search`` (which stops once every beam
        ended)."""
        features, proj, h0, c0 = self._prepare(features, depth_features)

        def step_fn(state, prev, t):
            ctx = attend(t, features, proj, state["h"])
            h, c, out = self._tail(ctx, self._embedding(prev.long()),
                                   state["h"], state["c"])
            return {"h": h, "c": c}, log_softmax(out)

        return beam_search(step_fn, tile_for_beams({"h": h0, "c": c0},
                                                   beam_size),
                           features.shape[0], start_id, end_id,
                           beam_size=beam_size, max_length=max_length,
                           length_penalty=length_penalty, early_exit=True)
