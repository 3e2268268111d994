"""Whole-sequence greedy decode: CUDA kernel wrapper, planner and plain
version.

Counterpart of the JAX ``ops/pallas/decode_seq.py``. Every step runs the
attention-LSTM step (``decode_step``'s function, here as phases of the
one launch: ``csrc/decode_phases.cuh``), then the vocab head
``h' @ w_out + b_out``, an argmax (lowest index on equal values) and the
embedding of the chosen token; the output is the token matrix [B, L].

``fused_greedy_decode`` launches ``csrc/decode_seq.cu`` for CUDA tensors:
one cooperative launch of one CTA per SM, the time loop inside it, each
CTA holding a column slice of the weights in shared memory for the whole
launch (``plan`` sizes it; ``LAST_PLAN`` is the plan of the last
launch). CPU tensors run ``fused_greedy_decode_plain`` (a Python time
loop); the wrapper calls operator ``dcap::greedy_decode``
(``library.py``), which dispatches on the device. ``end_id >= 0`` gives
finished rows <end>-padding and stops once every row is done, the output
of the JAX early-exit paths; ``end_id < 0`` runs all ``max_length`` steps.
With ``utils/tracing`` on, a call adds the steps it ran (``steps_run``) to
the counter ``decode.steps_run``. Any batch size B >= 1 is taken as it
is: there is no padding to a multiple of 8 as on the TPU. Widths the
phases cannot read (D, E or H not a multiple of 8, A not of 4) are
zero-padded for the launch (``pad_seq``), which leaves the tokens as
they are.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from depth_image_captioning_pub_torch.ops.kernels import _build, library
from depth_image_captioning_pub_torch.ops.kernels.decode_step import (
    A_MIN, FEATURE_DTYPES, G_UNITS, H_ROWS, H_TILE_MAX, SMEM_LIMIT, THREADS,
    TWO_UNITS_FROM, DecodeStepWeights, _sm_count, attention_lstm_step,
    check_float32, check_kernel_device, check_same_device, check_shape,
    check_step_weights, cuda_pointers, kernel_widths, pad_step_weights,
    plain_step_params, zero_pad)
from depth_image_captioning_pub_torch.utils import tracing

LAUNCHES = 0   # kernel launches of dcap_greedy_decode in this process

class GreedyPlan(NamedTuple):
    """How ``csrc/decode_seq.cu`` splits the work over ``ctas`` CTAs."""

    ctas: int
    h_slices: Tuple[Tuple[int, int], ...]  # per CTA: [c0, c1) of the
    #                       h-product columns [W_dec | W_fb | W_out]
    h_cols: int       # the widest slice, padded to a multiple of 4
    units: int        # hidden units per CTA of the gate products
    g_groups: int     # unit groups: CTA p takes group p % g_groups ...
    g_parts: int      # ... for row part p // g_groups of g_parts
    a_chunk: int      # feature columns per attention item
    h_rows: int       # rows of h per h-product tile
    smem_bytes: int
    scratch_floats: int
    scratch_ints: int


LAST_PLAN: Optional[GreedyPlan] = None   # the plan of the last launch


def smem_floats(k: int, d: int, a: int, e: int, h: int, h_cols: int,
                units: int, h_rows: int, threads: int) -> int:
    """Shared memory of one CTA in floats (``smem_floats`` of the .cu)."""
    return (h * h_cols + units * (e + d + h) * 4 + h_rows * (h + 4)
            + 8 * threads + 2 * h_rows * (h_cols // 4) + h_cols + 4 * units
            + 2 * a + k + threads // 32)


@functools.lru_cache(maxsize=256)
def plan(bsz: int, k: int, d: int, a: int, e: int, h: int, v: int,
         ctas: int) -> GreedyPlan:
    """Split the greedy decode of ``bsz`` rows over ``ctas`` CTAs.

    CTA p holds columns [p*N/ctas, (p+1)*N/ctas) of the N = A + D + V
    h-product columns, and the gate weights of ``units`` hidden units:
    those of group p % g_groups (g_groups = ceil(H / units)), for the rows
    of part p // g_groups of g_parts = max(1, ctas // g_groups). Two units
    per CTA from ``TWO_UNITS_FROM`` rows on, else one, where they fit
    beside a full h tile. Attention items are (row, chunk of ``a_chunk``
    feature columns), about ``ctas`` of them in all. The h-product row
    tile shrinks until the CTA fits in 227 KB of shared memory; raises
    ValueError when even the smallest does not.
    """
    if min(bsz, k, d, a, e, h, v, ctas) < 1:
        raise ValueError(f"greedy decode needs positive sizes, got B={bsz} "
                         f"K={k} D={d} A={a} E={e} H={h} V={v} "
                         f"ctas={ctas}")
    if d % 8 or e % 8 or h % 8 or a % 4:
        raise ValueError(f"the greedy kernel reads 16 or 32 bytes at a time: "
                         f"D={d}, E={e} and H={h} must be multiples of 8, "
                         f"A={a} a multiple of 4")
    n = a + d + v
    h_slices = tuple((p * n // ctas, (p + 1) * n // ctas)
                     for p in range(ctas))
    h_cols = -(-max(c1 - c0 for c0, c1 in h_slices) // 4) * 4
    least = -(-h // ctas)       # every unit needs a CTA
    if least > G_UNITS:
        raise ValueError(f"greedy kernel: H={h} hidden units over {ctas} "
                         f"CTAs needs {least} units per CTA, above the "
                         f"{G_UNITS} a CTA can hold")
    # two units per CTA halve the CTAs that read each row's input; with
    # fewer rows, one unit per CTA spreads the rows' work wider
    # (tools/decode_seq_ab.py)
    choices = [u for u in ((2, 1) if bsz >= TWO_UNITS_FROM else (1, 2))
               if u >= least]
    chunks = max(1, min(ctas // bsz, d // A_MIN))
    a_chunk = min(d, (-(-d // chunks) + 7) // 8 * 8)
    tile = -(-min(bsz, H_TILE_MAX) // H_ROWS) * H_ROWS

    def need_bytes(u, t):
        return 4 * smem_floats(k, d, a, e, h, h_cols, u, t, THREADS)

    fits = [u for u in choices if need_bytes(u, tile) <= SMEM_LIMIT]
    units = fits[0] if fits else choices[-1]
    while need_bytes(units, tile) > SMEM_LIMIT and tile > H_ROWS:
        tile -= H_ROWS
    need = need_bytes(units, tile)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"greedy kernel at K={k} D={d} A={a} E={e} H={h} V={v} over "
            f"{ctas} CTAs needs {need} bytes of shared memory per CTA "
            f"({units} hidden unit(s) of {e + d + h} x 4 gate weights, "
            f"{h_cols} h-product columns of {h}), above the {SMEM_LIMIT}-"
            f"byte limit of a block")
    groups = -(-h // units)
    return GreedyPlan(
        ctas=ctas, h_slices=h_slices, h_cols=h_cols, units=units,
        g_groups=groups, g_parts=max(1, ctas // groups), a_chunk=a_chunk,
        h_rows=tile, smem_bytes=need,
        scratch_floats=bsz * (2 * d + a + 3 * h + ctas),
        scratch_ints=2 + bsz * (ctas + 2))


@functools.lru_cache(maxsize=64)
def _max_ctas(index: int, bf16: int, smem: int) -> int:
    """CTAs of the kernel that can be co-resident on the current card
    ``index`` at ``smem`` bytes of shared memory each."""
    fits = _build.load().dcap_greedy_max_ctas(bf16, smem)
    if fits < 0:
        _build.check_launch(-fits, "dcap_greedy_max_ctas")
    return fits


class DecodeSeqWeights(NamedTuple):
    step: DecodeStepWeights
    w_out: torch.Tensor   # [H, V]
    b_out: torch.Tensor   # [1, V]
    embed: torch.Tensor   # [V, E]


def pad_seq(features, features_proj, h0, c0, w: DecodeSeqWeights):
    """The whole-sequence kernels' inputs zero-padded to ``decode_step.
    kernel_widths`` (``pad_step_weights``' argument: padded columns add
    exactly 0 and padded hidden units stay 0; the head's padded rows meet
    those zeros): (features, features_proj, h0, c0, w). Nothing is copied
    at widths the kernels take as they are (the published ones)."""
    bsz, k, d = features.shape
    vocab, e = w.embed.shape
    dp, ap, ep, hp = kernel_widths(d, features_proj.shape[-1], e,
                                   h0.shape[-1])
    return (zero_pad(features, (bsz, k, dp)),
            zero_pad(features_proj, (bsz, k, ap)), zero_pad(h0, (bsz, hp)),
            zero_pad(c0, (bsz, hp)),
            DecodeSeqWeights(pad_step_weights(w.step, dp, ap, ep, hp),
                             zero_pad(w.w_out, (hp, vocab)), w.b_out,
                             zero_pad(w.embed, (vocab, ep))))


def fused_greedy_decode_plain(features, features_proj, h0, c0,
                              w: DecodeSeqWeights, *, max_length: int = 30,
                              start_id: int = 0, end_id: int = -1
                              ) -> torch.Tensor:
    """Plain PyTorch version of the greedy kernel: tokens [B, L] int32."""
    p = plain_step_params(w.step)
    bsz = features.shape[0]
    tokens = torch.full((bsz, max_length), max(end_id, 0), dtype=torch.int32,
                        device=features.device)
    done = torch.zeros((bsz,), dtype=torch.bool, device=features.device)
    emb = w.embed[start_id].expand(bsz, -1)
    h, c = h0, c0
    for t in range(max_length):
        h, c, _ = attention_lstm_step(features, features_proj, emb, h, c, p)
        logits = h @ w.w_out + w.b_out
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        if end_id >= 0:
            token = torch.where(done, torch.full_like(token, end_id), token)
            done = done | (token == end_id)
        tokens[:, t] = token
        if end_id >= 0 and bool(done.all()):
            break
        emb = w.embed[token.long()]
    return tokens


def fused_greedy_decode(features: torch.Tensor, features_proj: torch.Tensor,
                        h0: torch.Tensor, c0: torch.Tensor,
                        w: DecodeSeqWeights, *, max_length: int = 30,
                        start_id: int = 0, end_id: int = -1) -> torch.Tensor:
    """Whole-sequence greedy decode; returns tokens [B, max_length] int32.

    features [B,K,D] float32 or bfloat16, features_proj [B,K,A] and
    h0/c0 [B,H] float32. Runs operator ``dcap::greedy_decode``: CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if features.dim() != 3 or features.shape[0] < 1:
        raise ValueError(f"features must be [B>=1, K, D], got "
                         f"{tuple(features.shape)}")
    bsz, k, d = features.shape
    a, hdim = features_proj.shape[-1], h0.shape[-1]
    vocab, e = w.embed.shape
    if features.dtype not in FEATURE_DTYPES:
        raise TypeError(f"features must be float32 or bfloat16, got "
                        f"{features.dtype}")
    check_shape("features_proj", features_proj, (bsz, k, a))
    check_shape("h0", h0, (bsz, hdim))
    check_shape("c0", c0, (bsz, hdim))
    check_shape("w_out", w.w_out, (hdim, vocab))
    check_shape("b_out", w.b_out, (1, vocab))
    check_step_weights(w.step, k, d, a, e, hdim)
    named = ([("features_proj", features_proj), ("h0", h0), ("c0", c0)]
             + list(zip(w.step._fields, w.step))
             + [("w_out", w.w_out), ("b_out", w.b_out), ("embed", w.embed)])
    check_float32(named)
    check_same_device(named, features.device)
    if max_length < 1:
        raise ValueError(f"max_length must be >= 1, got {max_length}")
    if not 0 <= start_id < vocab or end_id >= vocab:
        raise ValueError(f"start_id {start_id} / end_id {end_id} outside "
                         f"the vocabulary of {vocab}")
    check_kernel_device(features.device)
    tokens = torch.ops.dcap.greedy_decode(features, features_proj, h0, c0,
                                          seq_list(w), max_length, start_id,
                                          end_id)
    tracing.count_later("decode.steps_run", steps_run, tokens, end_id)
    return tokens


def steps_run(tokens: torch.Tensor, end_id: int) -> int:
    """The rows times the steps a call ran, from its tokens [B, L]. With
    ``end_id >= 0`` the kernel and the plain version stop after the step in
    which the last row emits <end> (the kernel also runs the next step's
    attention phase before its test, not counted): the first step whose
    column is all <end>, since a row that has ended is <end> from then on.
    Otherwise, or where a row never ends, all L steps."""
    bsz, length = tokens.shape
    if end_id < 0:
        return bsz * length
    ended = (tokens.cpu() == end_id).all(0)
    return bsz * (int(ended.int().argmax()) + 1 if bool(ended.any())
                  else length)


def seq_list(w: DecodeSeqWeights):
    """The weights as the operators' ``Tensor[]``: the step's ten, then
    w_out, b_out and embed."""
    return [*w.step, w.w_out, w.b_out, w.embed]


def seq_weights(ws) -> DecodeSeqWeights:
    """The inverse of ``seq_list``."""
    return DecodeSeqWeights(DecodeStepWeights(*ws[:10]), *ws[10:])


def _greedy_cpu(features, features_proj, h0, c0, w, max_length, start_id,
                end_id):
    return fused_greedy_decode_plain(
        features, features_proj, h0, c0, seq_weights(w),
        max_length=max_length, start_id=start_id, end_id=end_id)


def _greedy_fake(features, features_proj, h0, c0, w, max_length, start_id,
                 end_id):
    return h0.new_empty((features.shape[0], max_length), dtype=torch.int32)


def _greedy_cuda(features, features_proj, h0, c0, w, max_length, start_id,
                 end_id):
    """The kernel launch of ``dcap::greedy_decode``."""
    global LAUNCHES, LAST_PLAN
    w = seq_weights(w)
    bsz, k, _ = features.shape
    vocab = w.embed.shape[0]
    features, features_proj, h0, c0, w = pad_seq(features, features_proj,
                                                 h0, c0, w)
    d, a, hdim, e = (features.shape[-1], features_proj.shape[-1],
                     h0.shape[-1], w.embed.shape[-1])
    named = ([("features_proj", features_proj), ("h0", h0), ("c0", c0)]
             + list(zip(w.step._fields, w.step))
             + [("w_out", w.w_out), ("b_out", w.b_out), ("embed", w.embed)])
    ptrs = cuda_pointers([("features", features)] + named)
    for name, t in (("features", features), ("features_proj", features_proj),
                    ("h0", h0), ("embed", w.embed)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    lib = _build.load()
    bf16 = int(features.dtype == torch.bfloat16)
    with torch.cuda.device(features.device):
        index = torch.cuda.current_device()
        p = plan(bsz, k, d, a, e, hdim, vocab, _sm_count(index))
        while (fits := _max_ctas(index, bf16, p.smem_bytes)) < p.ctas:
            p = plan(bsz, k, d, a, e, hdim, vocab, fits)
        tokens = torch.empty((bsz, max_length), dtype=torch.int32,
                             device=features.device)
        fscr = torch.empty((p.scratch_floats,), dtype=torch.float32,
                           device=features.device)
        iscr = torch.empty((p.scratch_ints,), dtype=torch.int32,
                           device=features.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcap_greedy_decode(
            ptrs[0], bf16, *ptrs[1:], tokens.data_ptr(), fscr.data_ptr(),
            iscr.data_ptr(), bsz, k, d, a, e, hdim, vocab, max_length,
            start_id, end_id, p.ctas, p.h_cols, p.units, p.a_chunk,
            p.h_rows, p.smem_bytes, stream)
    _build.check_launch(err, "dcap_greedy_decode")
    LAUNCHES += 1
    LAST_PLAN = p
    return tokens


library.implement("greedy_decode", _greedy_cpu, _greedy_cuda, _greedy_fake)
