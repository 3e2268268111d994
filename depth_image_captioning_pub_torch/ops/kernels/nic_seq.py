"""Whole-sequence NIC greedy decode: CUDA kernel wrapper, planner and plain
version.

Counterpart of the JAX ``ops/pallas/nic_seq.py``. A stacked LSTM starts
from zero state, is primed by the image embedding x0 at step 0, and each
step runs every layer (gates ``in @ w_ih + h @ w_hh + b`` with the biases
pre-summed, split (i, f, g, o)), the vocab head ``h_top @ w_out + b_out``,
an argmax (lowest index on equal values) and the embedding of the chosen
token. There is no <end> early exit: NIC's greedy decode always runs
``max_length`` steps.

``fused_nic_greedy_decode`` launches ``csrc/nic_seq.cu`` for CUDA tensors:
one cooperative launch of one CTA per SM on the greedy kernel's phases
(``csrc/decode_phases.cuh``), the time loop inside it, each CTA holding a
column slice of the vocab head and its hidden units' gate weights of every
layer in shared memory for the whole launch (``plan_nic`` sizes it;
``LAST_PLAN`` is the plan of the last launch). CPU tensors run
``fused_nic_greedy_decode_plain``: the wrapper calls operator
``dcap::nic_greedy_decode`` (``library.py``), which dispatches on the
device. Any batch B >= 1 is taken as it is (no padding to 8 as on the
TPU), with 1 to 4 layers; E and H that are not multiples of 4 are
zero-padded for the kernel (``pad_nic``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from depth_image_captioning_pub_torch.ops.kernels import _build, library
from depth_image_captioning_pub_torch.ops.kernels.decode_step import (
    G_UNITS, H_ROWS, H_TILE_MAX, SMEM_LIMIT, THREADS, _sm_count,
    check_float32, check_kernel_device, check_same_device, check_shape,
    cuda_pointers, pad_gates)
from depth_image_captioning_pub_torch.ops.lstm import (
    LSTMCellParams, StackedLSTMParams, stacked_lstm_step)

LAUNCHES = 0   # kernel launches of dcap_nic_greedy_decode in this process

MAX_LAYERS = 4   # kMaxLayers of csrc/nic_seq.cu
G_ROWS = 2       # kNicGRows: rows of a warp's gate products
WARPS = THREADS // 32
PART_FLOATS = WARPS * G_UNITS * G_ROWS * 4   # kPartFloats
TOK_SLOTS = WARPS * G_ROWS                   # kTokSlots
WIDTH_STEP = 4   # x0, embed and h rows are read 16 bytes at a time


class NICSeqWeights(NamedTuple):
    """``layer_mats`` is (w_ih_0, w_hh_0, b_0, w_ih_1, w_hh_1, b_1, ...)
    with b = b_ih + b_hh as [1, 4H]; all float32."""

    layer_mats: Tuple[torch.Tensor, ...]
    w_out: torch.Tensor   # [H, V]
    b_out: torch.Tensor   # [1, V]
    embed: torch.Tensor   # [V, E]


class NICPlan(NamedTuple):
    """How ``csrc/nic_seq.cu`` splits the decode over ``ctas`` CTAs."""

    ctas: int
    e: int            # the kernel's input width: E, padded to WIDTH_STEP
    h: int            # the kernel's hidden width: H, padded to WIDTH_STEP
    h_slices: Tuple[Tuple[int, int], ...]  # per CTA: [c0, c1) of W_out's
    #                                         columns
    h_cols: int       # the widest slice, padded to a multiple of 4
    units: int        # hidden units per CTA of the gate products
    g_groups: int     # unit groups: CTA p takes group p % g_groups ...
    g_parts: int      # ... for row part p // g_groups of g_parts
    h_rows: int       # rows of h per h-product tile
    smem_bytes: int
    scratch_floats: int
    scratch_ints: int


LAST_PLAN: Optional[NICPlan] = None   # the plan of the last launch


def pack_nic_weights(lstm: StackedLSTMParams, out_w: torch.Tensor,
                     out_b: torch.Tensor, embed: torch.Tensor
                     ) -> NICSeqWeights:
    """Bundle NICDecoder params for the kernel (biases pre-summed)."""
    mats = []
    for cell in lstm.layers:
        mats.extend([cell.w_ih, cell.w_hh, (cell.b_ih + cell.b_hh)[None, :]])
    return NICSeqWeights(tuple(mats), out_w, out_b[None, :], embed)


def smem_floats(e: int, h: int, layers: int, h_cols: int, units: int,
                h_rows: int) -> int:
    """Shared memory of one CTA in floats (``smem_floats`` of the .cu)."""
    rows = e + h + (layers - 1) * 2 * h
    return (h * h_cols + 4 * units * rows + h_rows * (h + 4) + PART_FLOATS
            + h_cols + 4 * units * layers + 2 * h_rows * (h_cols // 4)
            + TOK_SLOTS)


def _round_up(n: int, step: int) -> int:
    return -(-n // step) * step


def unit_choices(bsz: int, h: int, ctas: int) -> Tuple[int, ...]:
    """The hidden units per CTA to try, best first, as the G phases would
    split ``bsz`` rows with each: one pass over the CTA's rows before two,
    then no row group of exactly two warps, then one unit before two.

    (tools/nic_seq_ab.py, B = 1 to 128 on an H100: G_0 took 7.1-7.9 µs a
    step where its row groups had two warps, 5.2-5.7 with one or with four
    and more, and a second pass cost 3-4 µs more.)"""
    def cost(units):
        parts = max(1, ctas // -(-h // units))
        rows = -(-bsz // parts)          # the most rows of a CTA
        groups = -(-rows // G_ROWS)      # their row groups
        return (-(-groups // WARPS), max(1, WARPS // groups) == 2, units)

    least = -(-h // ctas)       # every unit needs a CTA
    return tuple(sorted((u for u in range(least, G_UNITS + 1)), key=cost))


@functools.lru_cache(maxsize=256)
def plan_nic(bsz: int, e: int, h: int, layers: int, v: int,
             ctas: int) -> NICPlan:
    """Split the NIC greedy decode of ``bsz`` rows over ``ctas`` CTAs.

    E and H are padded to multiples of ``WIDTH_STEP``. CTA p holds columns
    [p*V/ctas, (p+1)*V/ctas) of W_out and b_out, and the gate weights of
    ``units`` hidden units in every layer: those of group p % g_groups
    (g_groups = ceil(H / units)), for the rows of part p // g_groups of
    g_parts = max(1, ctas // g_groups). ``units`` is the first of
    ``unit_choices`` that fits beside a full h tile. The h-product row tile
    shrinks until the CTA fits in 227 KB of shared memory; raises
    ValueError when even the smallest does not.
    """
    if min(bsz, e, h, v, ctas) < 1:
        raise ValueError(f"NIC decode needs positive sizes, got B={bsz} "
                         f"E={e} H={h} V={v} ctas={ctas}")
    if not 1 <= layers <= MAX_LAYERS:
        raise ValueError(f"the NIC kernel takes 1 to {MAX_LAYERS} layers, "
                         f"got {layers}")
    ep, hp = _round_up(e, WIDTH_STEP), _round_up(h, WIDTH_STEP)
    h_slices = tuple((p * v // ctas, (p + 1) * v // ctas)
                     for p in range(ctas))
    h_cols = _round_up(max(c1 - c0 for c0, c1 in h_slices), 4)
    choices = unit_choices(bsz, hp, ctas)
    if not choices:
        raise ValueError(f"NIC kernel: H={hp} hidden units over {ctas} "
                         f"CTAs needs {-(-hp // ctas)} units per CTA, above "
                         f"the {G_UNITS} a CTA can hold")
    tile = _round_up(min(bsz, H_TILE_MAX), H_ROWS)

    def need_bytes(u, t):
        return 4 * smem_floats(ep, hp, layers, h_cols, u, t)

    fits = [u for u in choices if need_bytes(u, tile) <= SMEM_LIMIT]
    units = fits[0] if fits else choices[-1]
    while need_bytes(units, tile) > SMEM_LIMIT and tile > H_ROWS:
        tile -= H_ROWS
    need = need_bytes(units, tile)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"NIC kernel at E={ep} H={hp} layers={layers} V={v} over {ctas} "
            f"CTAs needs {need} bytes of shared memory per CTA ({units} "
            f"hidden unit(s) of {ep + hp} + {layers - 1} x {2 * hp} rows x "
            f"4 gate weights, {h_cols} head columns of {hp}), above the "
            f"{SMEM_LIMIT}-byte limit of a block")
    groups = -(-hp // units)
    return NICPlan(
        ctas=ctas, e=ep, h=hp, h_slices=h_slices, h_cols=h_cols,
        units=units, g_groups=groups, g_parts=max(1, ctas // groups),
        h_rows=tile, smem_bytes=need,
        scratch_floats=bsz * (3 * layers * hp + ctas),
        scratch_ints=2 + bsz * ctas)


@functools.lru_cache(maxsize=64)
def _max_ctas(index: int, smem: int) -> int:
    """CTAs of the kernel that can be co-resident on the current card
    ``index`` at ``smem`` bytes of shared memory each."""
    fits = _build.load().dcap_nic_max_ctas(smem)
    if fits < 0:
        _build.check_launch(-fits, "dcap_nic_max_ctas")
    return fits


def pad_nic(x0: torch.Tensor, w: NICSeqWeights, e: int, h: int
            ) -> Tuple[torch.Tensor, NICSeqWeights]:
    """x0 and the weights zero-padded to input width ``e`` and hidden width
    ``h`` (at least theirs): x0's and embed's columns and layer 0's W_ih
    rows to e; a zero column in each gate block, and zero rows of W_hh, the
    upper layers' W_ih and W_out, to h. A padded hidden unit stays exactly
    0: c' = sigmoid(0) * 0 + sigmoid(0) * tanh(0) = 0, so h' = 0. Returns
    the inputs themselves when they are as wide already."""
    e0, h0 = x0.shape[1], w.w_out.shape[0]
    if (e0, h0) == (e, h):
        return x0, w
    mats = []
    for li in range(0, len(w.layer_mats), 3):
        w_ih, w_hh, b = w.layer_mats[li:li + 3]
        mats += [pad_gates(w_ih, e if li == 0 else h, h),
                 pad_gates(w_hh, h, h), pad_gates(b, 1, h)]
    w_out = w.w_out.new_zeros((h, w.w_out.shape[1]))
    w_out[:h0] = w.w_out
    return F.pad(x0, (0, e - e0)), NICSeqWeights(
        tuple(mats), w_out, w.b_out, F.pad(w.embed, (0, e - e0)))


def _stacked(w: NICSeqWeights) -> StackedLSTMParams:
    m = w.layer_mats
    return StackedLSTMParams(tuple(
        LSTMCellParams(m[i], m[i + 1], m[i + 2][0],
                       torch.zeros_like(m[i + 2][0]))
        for i in range(0, len(m), 3)))


def fused_nic_greedy_decode_plain(x0: torch.Tensor, w: NICSeqWeights, *,
                                  max_length: int = 30) -> torch.Tensor:
    """Plain PyTorch version of the NIC greedy kernel: tokens [B, L]."""
    lstm = _stacked(w)
    bsz, hdim = x0.shape[0], w.w_out.shape[0]
    hs = torch.zeros((len(lstm.layers), bsz, hdim), dtype=torch.float32,
                     device=x0.device)
    cs = torch.zeros_like(hs)
    tokens = torch.empty((bsz, max_length), dtype=torch.int32,
                         device=x0.device)
    x = x0
    for t in range(max_length):
        out, hs, cs = stacked_lstm_step(lstm, x, hs, cs)
        token = torch.argmax(out @ w.w_out + w.b_out, dim=-1)
        tokens[:, t] = token.to(torch.int32)
        x = w.embed[token]
    return tokens


def fused_nic_greedy_decode(x0: torch.Tensor, w: NICSeqWeights, *,
                            max_length: int = 30) -> torch.Tensor:
    """Whole-sequence NIC greedy decode; returns tokens [B, max_length]
    int32. ``x0`` [B, E] float32 is the projected image embedding that
    primes the LSTM. Runs operator ``dcap::nic_greedy_decode``: CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x0.dim() != 2 or x0.shape[0] < 1:
        raise ValueError(f"x0 must be [B>=1, E], got {tuple(x0.shape)}")
    bsz, e = x0.shape
    hdim, vocab = w.w_out.shape
    layers = len(w.layer_mats) // 3
    if len(w.layer_mats) % 3 or not 1 <= layers <= MAX_LAYERS:
        raise ValueError(f"the kernel takes 1 to {MAX_LAYERS} layers of "
                         f"(w_ih, w_hh, b), got {len(w.layer_mats)} "
                         f"matrices")
    g = 4 * hdim
    for li in range(layers):
        w_ih, w_hh, b = w.layer_mats[3 * li:3 * li + 3]
        check_shape(f"w_ih_{li}", w_ih, (e if li == 0 else hdim, g))
        check_shape(f"w_hh_{li}", w_hh, (hdim, g))
        check_shape(f"b_{li}", b, (1, g))
    check_shape("b_out", w.b_out, (1, vocab))
    check_shape("embed", w.embed, (vocab, e))
    named = ([("x0", x0)]
             + [(f"layer_mats[{i}]", m) for i, m in enumerate(w.layer_mats)]
             + [("w_out", w.w_out), ("b_out", w.b_out), ("embed", w.embed)])
    check_float32(named)
    check_same_device(named, x0.device)
    if max_length < 1:
        raise ValueError(f"max_length must be >= 1, got {max_length}")
    check_kernel_device(x0.device)
    return torch.ops.dcap.nic_greedy_decode(
        x0, [*w.layer_mats, w.w_out, w.b_out, w.embed], max_length)


def _nic_weights(ws) -> NICSeqWeights:
    """The operator's ``Tensor[]`` (the layers' matrices, then w_out, b_out
    and embed) -> ``NICSeqWeights``."""
    return NICSeqWeights(tuple(ws[:-3]), *ws[-3:])


def _nic_cpu(x0, w, max_length):
    return fused_nic_greedy_decode_plain(x0, _nic_weights(w),
                                         max_length=max_length)


def _nic_fake(x0, w, max_length):
    return x0.new_empty((x0.shape[0], max_length), dtype=torch.int32)


def _nic_cuda(x0, w, max_length):
    """The kernel launch of ``dcap::nic_greedy_decode``."""
    global LAUNCHES, LAST_PLAN
    w = _nic_weights(w)
    bsz, e = x0.shape
    hdim, vocab = w.w_out.shape
    layers = len(w.layer_mats) // 3
    named = ([("x0", x0)]
             + [(f"layer_mats[{i}]", m) for i, m in enumerate(w.layer_mats)]
             + [("w_out", w.w_out), ("b_out", w.b_out), ("embed", w.embed)])
    cuda_pointers(named)   # every input contiguous
    lib = _build.load()
    with torch.cuda.device(x0.device):
        index = torch.cuda.current_device()
        p = plan_nic(bsz, e, hdim, layers, vocab, _sm_count(index))
        while (fits := _max_ctas(index, p.smem_bytes)) < p.ctas:
            p = plan_nic(bsz, e, hdim, layers, vocab, fits)
        x0k, wk = pad_nic(x0, w, p.e, p.h)
        for name, t in (("x0", x0k), ("embed", wk.embed)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary")
        layer_ptrs = ([m.data_ptr() for m in wk.layer_mats]
                      + [None] * (3 * (MAX_LAYERS - layers)))
        tokens = torch.empty((bsz, max_length), dtype=torch.int32,
                             device=x0.device)
        fscr = torch.empty((p.scratch_floats,), dtype=torch.float32,
                           device=x0.device)
        iscr = torch.empty((p.scratch_ints,), dtype=torch.int32,
                           device=x0.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcap_nic_greedy_decode(
            x0k.data_ptr(), *layer_ptrs, wk.w_out.data_ptr(),
            wk.b_out.data_ptr(), wk.embed.data_ptr(), tokens.data_ptr(),
            fscr.data_ptr(), iscr.data_ptr(), bsz, layers, p.e, p.h, vocab,
            max_length, p.ctas, p.h_cols, p.units, p.h_rows, p.smem_bytes,
            stream)
    _build.check_launch(err, "dcap_nic_greedy_decode")
    LAUNCHES += 1
    LAST_PLAN = p
    return tokens


library.implement("nic_greedy_decode", _nic_cpu, _nic_cuda, _nic_fake)
