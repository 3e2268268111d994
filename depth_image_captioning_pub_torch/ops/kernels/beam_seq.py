"""Whole beam search of the attention decoder: CUDA kernel wrapper, plain
version, and the selection of the best beam.

Counterpart of the JAX ``ops/pallas/beam_seq.py``, with the search of
``ops/decode.beam_search``: beam 0 alone is live at step 0; each step runs
the attention-LSTM step (``decode_step``'s function, as phases of the one
launch) for the B·W beams, the vocab head and a log-softmax; finished
beams may only continue with <end> at zero cost; the flat top-W over W·V
(``lax.top_k``'s order) picks the new beams, whose state is gathered from
their parents. The search stops once every beam is finished; the records
of the skipped steps are <end> with identity parents, which is what
running them would give.

``fused_beam_decode`` launches ``csrc/beam_seq.cu`` for CUDA tensors: the
whole search (W = 2..8) in one cooperative launch of one CTA per SM on the
greedy kernel's phases (``csrc/decode_phases.cuh``), each CTA holding a
column slice of the weights in shared memory for the whole launch, the
beams' reorder a row map (``plan_beam`` sizes it; ``LAST_PLAN`` is the plan
of the last launch). CPU tensors run ``fused_beam_decode_plain``: the
wrapper calls operator ``dcap::beam_decode`` (``library.py``), which
dispatches on the device. Both return the per-step records
(``BeamSeqOutputs``); ``reconstruct_history`` and ``select_best`` turn
them into the best caption, in plain PyTorch.
Widths the phases cannot read (D, E or H not a multiple of 8, A not of 4)
are zero-padded for the launch (``decode_seq.pad_seq``); a beam wider
than the kernel's instances raises (``check_beam_size``), where the plain
version takes any W.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from depth_image_captioning_pub_torch.ops import decode
from depth_image_captioning_pub_torch.ops.kernels import _build, library
from depth_image_captioning_pub_torch.ops.kernels.decode_seq import (
    DecodeSeqWeights, pad_seq, seq_list, seq_weights)
from depth_image_captioning_pub_torch.ops.kernels.decode_step import (
    A_MIN, FEATURE_DTYPES, G_UNITS, SMEM_LIMIT, THREADS, TWO_UNITS_FROM,
    _sm_count, check_float32, check_kernel_device, check_same_device,
    check_shape, check_step_weights, cuda_pointers, plain_step_params)
from depth_image_captioning_pub_torch.ops.lstm import lstm_cell

LAUNCHES = 0   # kernel launches of dcap_beam_decode in this process

BEAM_SIZES = (2, 3, 4, 5, 6, 7, 8)   # the widths csrc/beam_seq.cu is
#                                      built for
STATIC_SMEM = 1024   # bytes kept free for the kernel's static shared arrays
BEAM_H_ROWS = 4      # kBeamHRows: the h tile's rows are a multiple of it
H_TILE_MAX = 128     # most rows of an h tile (the threads' fill sets it)
# The rest of the envelope is the greedy kernel's (threads, units by rows,
# attention items of at least A_MIN feature columns): the beam kernel runs
# its phases.


class BeamSeqOutputs(NamedTuple):
    tokens: torch.Tensor    # [B, W, L] int32: token chosen for beam w at t
    parents: torch.Tensor   # [B, W, L] int32: parent beam of beam w at t
    scores: torch.Tensor    # [B, W] f32: final cumulative log-probs


class BeamPlan(NamedTuple):
    """How ``csrc/beam_seq.cu`` splits the search over ``ctas`` CTAs."""

    ctas: int
    rows: int         # beam rows R = B * W
    h_slices: Tuple[Tuple[int, int], ...]  # per CTA: [c0, c1) of the
    #                       h-product columns [W_dec | W_fb | W_out]
    h_cols: int       # the widest slice, padded to a multiple of 4
    units: int        # hidden units per CTA of the gate products
    g_groups: int     # unit groups: CTA p takes group p % g_groups ...
    g_parts: int      # ... for row part p // g_groups of g_parts
    a_chunk: int      # feature columns per attention item (image, chunk)
    h_rows: int       # rows of h per h-product tile
    smem_bytes: int
    scratch_floats: int
    scratch_ints: int


LAST_PLAN: Optional[BeamPlan] = None   # the plan of the last launch


def smem_floats(k: int, d: int, a: int, e: int, h: int, beam: int,
                h_cols: int, units: int, h_rows: int) -> int:
    """Shared memory of one CTA in floats (``smem_floats`` of the .cu)."""
    return (h * h_cols + units * (e + d + h) * 4 + h_rows * (h + 4)
            + 2 * THREADS * beam + a + beam * a + h_cols + 4 * units
            + 2 * h_rows * (h_cols // 4) + beam * k)


@functools.lru_cache(maxsize=256)
def plan_beam(bsz: int, beam: int, k: int, d: int, a: int, e: int, h: int,
              v: int, ctas: int) -> BeamPlan:
    """Split the beam search of ``bsz`` images x ``beam`` beams over
    ``ctas`` CTAs.

    As the greedy kernel's ``plan`` over the R = bsz * beam beam rows: CTA
    p holds columns [p*N/ctas, (p+1)*N/ctas) of the N = A + D + V
    h-product columns and the gate weights of ``units`` hidden units (two
    from ``TWO_UNITS_FROM`` rows on, else one, where they fit), for the
    rows of part p // g_groups. Attention items are (image, chunk of
    ``a_chunk`` feature columns), about ``ctas`` of them in all, each for
    the image's W beams. The h-product row tile holds as many rows as give
    each thread one item of BEAM_H_ROWS rows x 4 columns (at most
    ``H_TILE_MAX``), and shrinks until the CTA fits in 227 KB of shared
    memory less ``STATIC_SMEM``; raises ValueError when even the smallest
    does not.
    """
    if min(bsz, k, d, a, e, h, v, ctas) < 1:
        raise ValueError(f"beam kernel needs positive sizes, got B={bsz} "
                         f"K={k} D={d} A={a} E={e} H={h} V={v} "
                         f"ctas={ctas}")
    if beam not in BEAM_SIZES:
        raise ValueError(f"the beam kernel is built for beam sizes "
                         f"{BEAM_SIZES}, got {beam}")
    if d % 8 or e % 8 or h % 8 or a % 4:
        raise ValueError(f"the beam kernel reads 16 or 32 bytes at a time: "
                         f"D={d}, E={e} and H={h} must be multiples of 8, "
                         f"A={a} a multiple of 4")
    rows = bsz * beam
    n = a + d + v
    h_slices = tuple((p * n // ctas, (p + 1) * n // ctas)
                     for p in range(ctas))
    h_cols = -(-max(c1 - c0 for c0, c1 in h_slices) // 4) * 4
    least = -(-h // ctas)       # every unit needs a CTA
    if least > G_UNITS:
        raise ValueError(f"beam kernel: H={h} hidden units over {ctas} "
                         f"CTAs needs {least} units per CTA, above the "
                         f"{G_UNITS} a CTA can hold")
    choices = [u for u in ((2, 1) if rows >= TWO_UNITS_FROM else (1, 2))
               if u >= least]
    chunks = max(1, min(ctas // bsz, d // A_MIN))
    a_chunk = min(d, (-(-d // chunks) + 7) // 8 * 8)
    # an h tile of as many rows as give every thread a (rows x 4 columns)
    # item: the beam kernel has 5x the greedy kernel's rows to spread
    fill = max(1, THREADS // (h_cols // 4)) * BEAM_H_ROWS
    tile = -(-min(rows, H_TILE_MAX, fill) // BEAM_H_ROWS) * BEAM_H_ROWS
    limit = SMEM_LIMIT - STATIC_SMEM

    def need_bytes(u, t):
        return 4 * smem_floats(k, d, a, e, h, beam, h_cols, u, t)

    fits = [u for u in choices if need_bytes(u, tile) <= limit]
    units = fits[0] if fits else choices[-1]
    while need_bytes(units, tile) > limit and tile > BEAM_H_ROWS:
        tile -= BEAM_H_ROWS
    need = need_bytes(units, tile)
    if need > limit:
        raise ValueError(
            f"beam kernel at W={beam} K={k} D={d} A={a} E={e} H={h} V={v} "
            f"over {ctas} CTAs needs {need} bytes of shared memory per CTA "
            f"({units} hidden unit(s) of {e + d + h} x 4 gate weights, "
            f"{h_cols} h-product columns of {h}), above the {limit} bytes "
            f"a block may use beside its static arrays")
    groups = -(-h // units)
    cands = bsz * max(1, min(ctas // bsz, v)) * beam   # T1's top-W per item
    return BeamPlan(
        ctas=ctas, rows=rows, h_slices=h_slices, h_cols=h_cols, units=units,
        g_groups=groups, g_parts=max(1, ctas // groups), a_chunk=a_chunk,
        h_rows=tile, smem_bytes=need,
        scratch_floats=rows * (2 * d + a + 4 * h + 2 * ctas) + cands,
        scratch_ints=2 + 3 * rows + cands)


@functools.lru_cache(maxsize=64)
def _max_ctas(index: int, bf16: int, beam: int, smem: int) -> int:
    """CTAs of the W=``beam`` kernel that can be co-resident on the current
    card ``index`` at ``smem`` bytes of shared memory each."""
    fits = _build.load().dcap_beam_max_ctas(bf16, beam, smem)
    if fits < 0:
        _build.check_launch(-fits, "dcap_beam_max_ctas")
    return fits


def check_beam_size(beam_size: int, device) -> None:
    """Raise, naming the kernel's widths, when a beam search of width
    ``beam_size`` on ``device`` would reach the beam kernel without an
    instance for it: a CUDA device and W outside ``BEAM_SIZES``. The plain
    version (CPU tensors) takes any W."""
    if (torch.device(device).type == "cuda"
            and beam_size not in BEAM_SIZES):
        raise ValueError(f"the beam kernel is built for beam sizes "
                         f"{BEAM_SIZES}, got {beam_size}")


def fused_beam_decode_plain(features, features_proj, h0, c0,
                            w: DecodeSeqWeights, *, beam_size: int,
                            max_length: int = 30, start_id: int = 0,
                            end_id: int = 0) -> BeamSeqOutputs:
    """Plain PyTorch version of the beam kernel, the same records. The
    attention reads each image's features once for its W beams."""
    p = plain_step_params(w.step)
    bsz, k, _ = features.shape
    beam, dev = beam_size, features.device
    feats = features.to(torch.float32)
    h = h0.repeat_interleave(beam, dim=0)
    c = c0.repeat_interleave(beam, dim=0)
    emb = w.embed[start_id].expand(bsz * beam, -1)
    scores = decode.initial_scores(bsz, beam, dev)
    finished = torch.zeros((bsz, beam), dtype=torch.bool, device=dev)
    tokens = torch.full((bsz, beam, max_length), end_id, dtype=torch.int32,
                        device=dev)
    parents = torch.arange(beam, dtype=torch.int32, device=dev)[
        None, :, None].repeat(bsz, 1, max_length)
    rows = torch.arange(bsz, device=dev)[:, None] * beam
    for t in range(max_length):
        if bool(finished.all()):
            break
        # the attention-LSTM step, beam-aware: [B, W, ...]
        h3 = h.reshape(bsz, beam, -1)
        dec = h3 @ p.att.w_dec + p.att.b_dec
        act = torch.relu(features_proj[:, None] + dec[:, :, None, :])
        alpha = torch.softmax(act @ p.att.w_full + p.att.b_full, dim=-1)
        ctx = torch.bmm(alpha, feats).reshape(bsz * beam, -1)
        gate = torch.sigmoid(h @ p.w_fb + p.b_fb)
        h, c = lstm_cell(p.lstm, torch.cat([emb, gate * ctx], dim=-1), h, c)
        lp = decode.log_softmax(h @ w.w_out + w.b_out)
        lp = decode.restrict_finished(lp.reshape(bsz, beam, -1), finished,
                                      end_id)
        scores, parent, token = decode.top_w(scores[..., None] + lp, beam)
        flat = (rows + parent).reshape(-1)
        h, c = h[flat], c[flat]
        finished = torch.gather(finished, 1, parent) | (token == end_id)
        emb = w.embed[token.reshape(-1).long()]
        tokens[:, :, t] = token
        parents[:, :, t] = parent.to(torch.int32)
    return BeamSeqOutputs(tokens, parents, scores)


def fused_beam_decode(features: torch.Tensor, features_proj: torch.Tensor,
                      h0: torch.Tensor, c0: torch.Tensor,
                      w: DecodeSeqWeights, *, beam_size: int,
                      max_length: int = 30, start_id: int = 0,
                      end_id: int = 0) -> BeamSeqOutputs:
    """The whole beam search in one call; returns the per-step records.

    features [B,K,D] float32 or bfloat16, features_proj [B,K,A] and h0/c0
    [B,H] float32, all per image (the search tiles the beams itself). Runs
    operator ``dcap::beam_decode``: CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise.
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
    if beam_size < 1 or beam_size > vocab:
        raise ValueError(f"beam_size must be in [1, {vocab}], got "
                         f"{beam_size}")
    if not 0 <= start_id < vocab or not 0 <= end_id < vocab:
        raise ValueError(f"start_id {start_id} / end_id {end_id} outside "
                         f"the vocabulary of {vocab}")
    check_kernel_device(features.device)
    return BeamSeqOutputs(*torch.ops.dcap.beam_decode(
        features, features_proj, h0, c0, seq_list(w), beam_size,
        max_length, start_id, end_id))


def _beam_cpu(features, features_proj, h0, c0, w, beam_size, max_length,
              start_id, end_id):
    return tuple(t.contiguous() for t in fused_beam_decode_plain(
        features, features_proj, h0, c0, seq_weights(w),
        beam_size=beam_size, max_length=max_length, start_id=start_id,
        end_id=end_id))


def _beam_fake(features, features_proj, h0, c0, w, beam_size, max_length,
               start_id, end_id):
    bsz = features.shape[0]
    tokens = h0.new_empty((bsz, beam_size, max_length), dtype=torch.int32)
    return (tokens, tokens.new_empty(tokens.shape),
            h0.new_empty((bsz, beam_size)))


def _beam_cuda(features, features_proj, h0, c0, w, beam_size, max_length,
               start_id, end_id):
    """The kernel launch of ``dcap::beam_decode``."""
    global LAUNCHES, LAST_PLAN
    w = seq_weights(w)
    bsz, k, _ = features.shape
    vocab = w.embed.shape[0]
    check_beam_size(beam_size, features.device)
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
    dev = features.device
    with torch.cuda.device(dev):
        index = torch.cuda.current_device()
        p = plan_beam(bsz, beam_size, k, d, a, e, hdim, vocab,
                      _sm_count(index))
        while (fits := _max_ctas(index, bf16, beam_size,
                                 p.smem_bytes)) < p.ctas:
            p = plan_beam(bsz, beam_size, k, d, a, e, hdim, vocab, fits)
        logits = torch.empty((bsz, beam_size, vocab), dtype=torch.float32,
                             device=dev)
        tokens = torch.empty((bsz, beam_size, max_length), dtype=torch.int32,
                             device=dev)
        parents = torch.empty_like(tokens)
        scores = torch.empty((bsz, beam_size), dtype=torch.float32,
                             device=dev)
        fscr = torch.empty((p.scratch_floats,), dtype=torch.float32,
                           device=dev)
        iscr = torch.empty((p.scratch_ints,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcap_beam_decode(
            ptrs[0], bf16, *ptrs[1:], logits.data_ptr(), tokens.data_ptr(),
            parents.data_ptr(), scores.data_ptr(), fscr.data_ptr(),
            iscr.data_ptr(), bsz, k, d, a, e, hdim, vocab, beam_size,
            max_length, start_id, end_id, p.ctas, p.h_cols, p.units,
            p.a_chunk, p.h_rows, p.smem_bytes, stream)
    _build.check_launch(err, "dcap_beam_decode")
    LAUNCHES += 1
    LAST_PLAN = p
    return tokens, parents, scores


library.implement("beam_decode", _beam_cpu, _beam_cuda, _beam_fake)


def reconstruct_history(out: BeamSeqOutputs) -> torch.Tensor:
    """Per-step (token, parent) records -> each final beam's tokens [B, W,
    L]: a reverse walk through its parent chain."""
    tokens, parents, _ = out
    bsz, beam, length = tokens.shape
    idx = torch.arange(beam, device=tokens.device).expand(bsz, beam)
    history = torch.empty_like(tokens)
    for t in range(length - 1, -1, -1):
        history[:, :, t] = torch.gather(tokens[:, :, t], 1, idx)
        idx = torch.gather(parents[:, :, t], 1, idx).long()
    return history


def select_best(out: BeamSeqOutputs, end_id: int,
                length_penalty: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens [B, L] of the best beam, its score [B]), as the tail of
    ``ops/decode.beam_search``."""
    return decode.select_best(out.scores, reconstruct_history(out), end_id,
                              length_penalty)
