"""Fused attention-LSTM decode step: CUDA kernel wrapper, planner and plain
version.

Counterpart of the JAX ``ops/pallas/decode_step.py``. One step computes

  dec    = h @ w_dec + b_dec                        [B, A]
  e      = relu(proj + dec) @ w_full + b_full       [B, K]
  alpha  = softmax(e)                               [B, K]
  ctx    = alpha @ features                         [B, D]
  gate   = sigmoid(h @ w_fb + b_fb)                 [B, D]
  gates  = emb @ w_ih_e + (gate*ctx) @ w_ih_c + h @ w_hh + b
  h',c'  = LSTM tail                                [B, H]

``fused_decode_core`` launches ``csrc/decode_step.cu`` for CUDA tensors:
one cooperative launch of one CTA per SM on the phases of
``csrc/decode_phases.cuh`` (the h-products, the attention, the gates), each
CTA holding a column slice of the step's weights in shared memory
(``plan_step`` sizes it; ``LAST_PLAN`` is the plan of the last launch).
CPU tensors run ``fused_decode_core_plain``: the wrapper calls operator
``dcap::decode_step`` (``library.py``), which dispatches on the device.
Features may be float32 or bfloat16 (upcast exactly as they are read);
everything else is float32, and alpha comes back float32. Any batch size B >= 1 is taken as it is;
widths the phases cannot read (D, E or H not a multiple of 8, A not of 4)
are zero-padded for the launch (``pad_step``) and h', c' sliced back.

The module also holds what the kernels on those phases share: their build
constants, the weight layout and the argument checks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from depth_image_captioning_pub_torch.ops.attention import (
    AttentionParams, soft_attention)
from depth_image_captioning_pub_torch.ops.kernels import _build, library
from depth_image_captioning_pub_torch.ops.lstm import LSTMCellParams, lstm_cell

LAUNCHES = 0   # kernel launches of dcap_decode_step in this process

FEATURE_DTYPES = (torch.float32, torch.bfloat16)

# csrc/decode_phases.cuh's build constants, shared by the kernels on its
# phases: threads per CTA and the rows of a thread's h-product tile (the
# tile's row count is a multiple of it)
THREADS = 512
H_ROWS = 4
G_UNITS = 2           # kGUnits: the most hidden units a CTA holds
SMEM_LIMIT = 232448   # shared memory a block may use on sm_90 (227 KB)
H_TILE_MAX = 64       # rows of h staged at once for the h-products
A_MIN = 128           # fewest feature columns of an attention item: each
#                       item recomputes its row's scores over K x A
TWO_UNITS_FROM = 32   # rows from which a CTA takes two hidden units
#                       (the whole-sequence kernels)
STEP_TWO_UNITS_FROM = 128   # the same for the step kernel: its gate slice
#                       is loaded on every launch, a gather of one 32-byte
#                       sector per element (tools/decode_step_ab.py: one
#                       unit faster at B = 1-64, two at 128)


class DecodeStepWeights(NamedTuple):
    """Step weights in kernel layout, float32."""

    w_dec: torch.Tensor    # [H, A]
    b_dec: torch.Tensor    # [1, A]
    w_full: torch.Tensor   # [A, 1]
    b_full: torch.Tensor   # [1, 1]
    w_fb: torch.Tensor     # [H, D]
    b_fb: torch.Tensor     # [1, D]
    w_ih_e: torch.Tensor   # [E, 4H]   (embedding rows of w_ih)
    w_ih_c: torch.Tensor   # [D, 4H]   (context rows of w_ih)
    w_hh: torch.Tensor     # [H, 4H]
    b_lstm: torch.Tensor   # [1, 4H]   (b_ih + b_hh)


def pack_weights(att_w_dec, att_b_dec, att_w_full, att_b_full, f_beta_w,
                 f_beta_b, lstm_w_ih, lstm_w_hh, lstm_b_ih, lstm_b_hh,
                 dim_embedding: int) -> DecodeStepWeights:
    """Split/reshape AttentionDecoder params into kernel layout (views,
    except the summed LSTM bias)."""
    return DecodeStepWeights(
        w_dec=att_w_dec, b_dec=att_b_dec[None, :],
        w_full=att_w_full.reshape(-1, 1),
        b_full=att_b_full.reshape(1, 1),
        w_fb=f_beta_w, b_fb=f_beta_b[None, :],
        w_ih_e=lstm_w_ih[:dim_embedding], w_ih_c=lstm_w_ih[dim_embedding:],
        w_hh=lstm_w_hh, b_lstm=(lstm_b_ih + lstm_b_hh)[None, :])


def kernel_widths(d: int, a: int, e: int, h: int
                  ) -> Tuple[int, int, int, int]:
    """(D, A, E, H) as the kernels on the shared phases run them: D, E and
    H rounded up to multiples of 8 and A to a multiple of 4 (the phases
    read 16 or 32 bytes at a time)."""
    return (-(-d // 8) * 8, -(-a // 4) * 4, -(-e // 8) * 8,
            -(-h // 8) * 8)


def zero_pad(t: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``t`` zero-padded at the end of every dim to ``shape``; ``t``
    itself when it has that shape already."""
    if tuple(t.shape) == tuple(shape):
        return t
    out = t.new_zeros(tuple(shape))
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def pad_gates(m: torch.Tensor, rows: int, h: int) -> torch.Tensor:
    """[n, 4H] -> [rows, 4h]: the rows and each gate block zero-padded;
    ``m`` itself when it has that shape already."""
    n, g = m.shape
    if (n, g) == (rows, 4 * h):
        return m
    out = m.new_zeros((rows, 4, h))
    out[:n, :, :g // 4] = m.reshape(n, 4, g // 4)
    return out.reshape(rows, 4 * h)


def pad_step_weights(w: DecodeStepWeights, d: int, a: int, e: int, h: int
                     ) -> DecodeStepWeights:
    """The step weights zero-padded to widths D=d, A=a, E=e, H=h (at least
    theirs). Every padded column or row meets a zero of the padded
    activations: a zero feature or attention column adds exactly 0, and a
    padded hidden unit stays exactly 0 (its gates are 0, so c' = sigmoid(0)
    * 0 + sigmoid(0) * tanh(0) = 0 and h' = 0). Tensors already as wide
    are returned as they are."""
    return DecodeStepWeights(
        w_dec=zero_pad(w.w_dec, (h, a)), b_dec=zero_pad(w.b_dec, (1, a)),
        w_full=zero_pad(w.w_full, (a, 1)), b_full=w.b_full,
        w_fb=zero_pad(w.w_fb, (h, d)), b_fb=zero_pad(w.b_fb, (1, d)),
        w_ih_e=pad_gates(w.w_ih_e, e, h), w_ih_c=pad_gates(w.w_ih_c, d, h),
        w_hh=pad_gates(w.w_hh, h, h), b_lstm=pad_gates(w.b_lstm, 1, h))


def pad_step(features, features_proj, emb, h, c, w: DecodeStepWeights):
    """The step kernel's inputs zero-padded to ``kernel_widths``: (features,
    features_proj, emb, h, c, w). Nothing is copied at widths the kernel
    takes as they are (the published ones)."""
    bsz, k, d = features.shape
    dp, ap, ep, hp = kernel_widths(d, features_proj.shape[-1],
                                   emb.shape[-1], h.shape[-1])
    return (zero_pad(features, (bsz, k, dp)),
            zero_pad(features_proj, (bsz, k, ap)), zero_pad(emb, (bsz, ep)),
            zero_pad(h, (bsz, hp)), zero_pad(c, (bsz, hp)),
            pad_step_weights(w, dp, ap, ep, hp))


class StepPlan(NamedTuple):
    """How ``csrc/decode_step.cu`` splits one step over ``ctas`` CTAs."""

    ctas: int
    h_slices: Tuple[Tuple[int, int], ...]  # per CTA: [c0, c1) of the
    #                       h-product columns [W_dec | W_fb]
    h_cols: int       # the widest slice, padded to a multiple of 4
    units: int        # hidden units per CTA of the gate products
    g_groups: int     # unit groups: CTA p takes group p % g_groups ...
    g_parts: int      # ... for row part p // g_groups of g_parts
    a_chunk: int      # feature columns per attention item
    h_rows: int       # rows of h per h-product tile
    smem_bytes: int
    scratch_floats: int
    scratch_ints: int


LAST_PLAN: Optional[StepPlan] = None   # the plan of the last launch


def step_smem_floats(k: int, d: int, a: int, e: int, h: int, h_cols: int,
                     units: int, h_rows: int) -> int:
    """Shared memory of one CTA in floats (``smem_floats`` of the .cu)."""
    return (h * h_cols + units * (e + d + h) * 4 + h_rows * (h + 4)
            + 8 * THREADS + h_cols + 4 * units + 2 * a + k + THREADS // 32)


@functools.lru_cache(maxsize=256)
def plan_step(bsz: int, k: int, d: int, a: int, e: int, h: int,
              ctas: int) -> StepPlan:
    """Split one step of ``bsz`` rows over ``ctas`` CTAs.

    CTA p holds columns [p*N/ctas, (p+1)*N/ctas) of the N = A + D
    h-product columns [W_dec | W_fb] and the gate weights of ``units``
    hidden units: those of group p % g_groups (g_groups = ceil(H /
    units)), for the rows of part p // g_groups of g_parts = max(1, ctas
    // g_groups). Two units per CTA from ``STEP_TWO_UNITS_FROM`` rows on,
    else one: each launch loads the slice anew, and a second unit doubles
    that load. Attention items are (row, chunk of ``a_chunk`` feature
    columns), about ``ctas`` of them in all. The h-product row tile
    shrinks until the CTA fits in 227 KB of shared memory; raises
    ValueError when even the smallest does not.
    """
    if min(bsz, k, d, a, e, h, ctas) < 1:
        raise ValueError(f"decode step needs positive sizes, got B={bsz} "
                         f"K={k} D={d} A={a} E={e} H={h} ctas={ctas}")
    if d % 8 or e % 8 or h % 8 or a % 4:
        raise ValueError(f"the step kernel reads 16 or 32 bytes at a time: "
                         f"D={d}, E={e} and H={h} must be multiples of 8, "
                         f"A={a} a multiple of 4")
    n = a + d
    h_slices = tuple((p * n // ctas, (p + 1) * n // ctas)
                     for p in range(ctas))
    h_cols = -(-max(c1 - c0 for c0, c1 in h_slices) // 4) * 4
    least = -(-h // ctas)       # every unit needs a CTA
    if least > G_UNITS:
        raise ValueError(f"step kernel: H={h} hidden units over {ctas} "
                         f"CTAs needs {least} units per CTA, above the "
                         f"{G_UNITS} a CTA can hold")
    choices = [u for u in ((2, 1) if bsz >= STEP_TWO_UNITS_FROM else (1, 2))
               if u >= least]
    chunks = max(1, min(ctas // bsz, d // A_MIN))
    a_chunk = min(d, (-(-d // chunks) + 7) // 8 * 8)
    tile = -(-min(bsz, H_TILE_MAX) // H_ROWS) * H_ROWS

    def need_bytes(u, t):
        return 4 * step_smem_floats(k, d, a, e, h, h_cols, u, t)

    fits = [u for u in choices if need_bytes(u, tile) <= SMEM_LIMIT]
    units = fits[0] if fits else choices[-1]
    while need_bytes(units, tile) > SMEM_LIMIT and tile > H_ROWS:
        tile -= H_ROWS
    need = need_bytes(units, tile)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"step kernel at K={k} D={d} A={a} E={e} H={h} over {ctas} "
            f"CTAs needs {need} bytes of shared memory per CTA ({units} "
            f"hidden unit(s) of {e + d + h} x 4 gate weights, {h_cols} "
            f"h-product columns of {h}), above the {SMEM_LIMIT}-byte limit "
            f"of a block")
    groups = -(-h // units)
    return StepPlan(
        ctas=ctas, h_slices=h_slices, h_cols=h_cols, units=units,
        g_groups=groups, g_parts=max(1, ctas // groups), a_chunk=a_chunk,
        h_rows=tile, smem_bytes=need, scratch_floats=bsz * (2 * d + a),
        scratch_ints=2 + bsz)


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=64)
def _max_ctas(index: int, bf16: int, smem: int) -> int:
    """CTAs of the step kernel that can be co-resident on the current card
    ``index`` at ``smem`` bytes of shared memory each."""
    fits = _build.load().dcap_step_max_ctas(bf16, smem)
    if fits < 0:
        _build.check_launch(-fits, "dcap_step_max_ctas")
    return fits


class PlainStepParams(NamedTuple):
    """The step weights regrouped for the ops-level composition."""

    att: AttentionParams
    lstm: LSTMCellParams
    w_fb: torch.Tensor
    b_fb: torch.Tensor


def plain_step_params(w: DecodeStepWeights) -> PlainStepParams:
    att = AttentionParams(None, None, w.w_dec, w.b_dec[0], w.w_full[:, 0],
                          w.b_full[0, 0])
    b = w.b_lstm[0]
    lstm = LSTMCellParams(torch.cat([w.w_ih_e, w.w_ih_c], dim=0), w.w_hh, b,
                          torch.zeros_like(b))
    return PlainStepParams(att, lstm, w.w_fb, w.b_fb[0])


def attention_lstm_step(features, features_proj, emb, h, c,
                        p: PlainStepParams):
    """The step composed from ops/attention and ops/lstm, in float32."""
    ctx, alpha = soft_attention(p.att, features, features_proj, h,
                                compute_dtype=torch.float32)
    gate = torch.sigmoid(h @ p.w_fb + p.b_fb)
    x = torch.cat([emb, gate * ctx], dim=-1)
    h_new, c_new = lstm_cell(p.lstm, x, h, c)
    return h_new, c_new, alpha


def fused_decode_core_plain(features, features_proj, emb, h, c,
                            w: DecodeStepWeights
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch version of the step kernel: (h', c', alpha)."""
    return attention_lstm_step(features, features_proj, emb, h, c,
                               plain_step_params(w))


def check_same_device(named: Sequence[Tuple[str, torch.Tensor]],
                      device: torch.device) -> None:
    for name, t in named:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def check_kernel_device(device: torch.device) -> None:
    """The operators have CPU and CUDA implementations only."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")


def check_float32(named: Sequence[Tuple[str, torch.Tensor]]) -> None:
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def check_shape(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def check_step_weights(w: DecodeStepWeights, k: int, d: int, a: int,
                       e: int, h: int) -> None:
    g = 4 * h
    for name, shape in (("w_dec", (h, a)), ("b_dec", (1, a)),
                        ("w_full", (a, 1)), ("b_full", (1, 1)),
                        ("w_fb", (h, d)), ("b_fb", (1, d)),
                        ("w_ih_e", (e, g)), ("w_ih_c", (d, g)),
                        ("w_hh", (h, g)), ("b_lstm", (1, g))):
        check_shape(name, getattr(w, name), shape)
    check_float32(list(zip(w._fields, w)))


def cuda_pointers(named: Sequence[Tuple[str, torch.Tensor]]):
    """Raw pointers for the kernel; every tensor must be contiguous."""
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return [t.data_ptr() for _, t in named]


def fused_decode_core(features: torch.Tensor, features_proj: torch.Tensor,
                      emb: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                      w: DecodeStepWeights
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused attention + gated context + LSTM cell.

    features [B,K,D] (float32 or bfloat16), features_proj [B,K,A],
    emb [B,E], h/c [B,H], all float32 but the features. Returns (h', c',
    alpha [B,K]). Runs operator ``dcap::decode_step``: CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise.
    """
    if features.dim() != 3 or features.shape[0] < 1:
        raise ValueError(f"features must be [B>=1, K, D], got "
                         f"{tuple(features.shape)}")
    bsz, k, d = features.shape
    a, e, hdim = features_proj.shape[-1], emb.shape[-1], h.shape[-1]
    if features.dtype not in FEATURE_DTYPES:
        raise TypeError(f"features must be float32 or bfloat16, got "
                        f"{features.dtype}")
    check_shape("features_proj", features_proj, (bsz, k, a))
    check_shape("emb", emb, (bsz, e))
    check_shape("h", h, (bsz, hdim))
    check_shape("c", c, (bsz, hdim))
    check_float32([("features_proj", features_proj), ("emb", emb),
                   ("h", h), ("c", c)])
    check_step_weights(w, k, d, a, e, hdim)
    named = [("features_proj", features_proj), ("emb", emb), ("h", h),
             ("c", c)] + list(zip(w._fields, w))
    check_same_device(named, features.device)
    check_kernel_device(features.device)
    return torch.ops.dcap.decode_step(features, features_proj, emb, h, c,
                                      list(w))


def _decode_step_cpu(features, features_proj, emb, h, c, w):
    return tuple(t.contiguous() for t in fused_decode_core_plain(
        features, features_proj, emb, h, c, DecodeStepWeights(*w)))


def _decode_step_fake(features, features_proj, emb, h, c, w):
    return (h.new_empty(h.shape), c.new_empty(c.shape),
            features_proj.new_empty(features.shape[:2]))


def _decode_step_cuda(features, features_proj, emb, h, c, w):
    """The kernel launch of ``dcap::decode_step``."""
    global LAUNCHES, LAST_PLAN
    w = DecodeStepWeights(*w)
    bsz, k, _ = features.shape
    hdim = h.shape[-1]
    features, features_proj, emb, h, c, w = pad_step(
        features, features_proj, emb, h, c, w)
    d, a, e, hp = (features.shape[-1], features_proj.shape[-1],
                   emb.shape[-1], h.shape[-1])
    named = [("features_proj", features_proj), ("emb", emb), ("h", h),
             ("c", c)] + list(zip(w._fields, w))
    ptrs = cuda_pointers([("features", features)] + named)
    for name, t in (("features", features), ("features_proj", features_proj),
                    ("emb", emb), ("h", h)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    lib = _build.load()
    bf16 = int(features.dtype == torch.bfloat16)
    with torch.cuda.device(features.device):
        index = torch.cuda.current_device()
        p = plan_step(bsz, k, d, a, e, hp, _sm_count(index))
        while (fits := _max_ctas(index, bf16, p.smem_bytes)) < p.ctas:
            p = plan_step(bsz, k, d, a, e, hp, fits)
        h_out = torch.empty_like(h)
        c_out = torch.empty_like(c)
        alpha = torch.empty((bsz, k), dtype=torch.float32,
                            device=features.device)
        fscr = torch.empty((p.scratch_floats,), dtype=torch.float32,
                           device=features.device)
        iscr = torch.empty((p.scratch_ints,), dtype=torch.int32,
                           device=features.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcap_decode_step(
            ptrs[0], bf16, *ptrs[1:], h_out.data_ptr(), c_out.data_ptr(),
            alpha.data_ptr(), fscr.data_ptr(), iscr.data_ptr(), bsz, k, d,
            a, e, hp, p.ctas, p.h_cols, p.units, p.a_chunk, p.h_rows,
            p.smem_bytes, stream)
    _build.check_launch(err, "dcap_decode_step")
    LAUNCHES += 1
    LAST_PLAN = p
    if hp != hdim:
        return (h_out[:, :hdim].contiguous(), c_out[:, :hdim].contiguous(),
                alpha)
    return h_out, c_out, alpha


library.implement("decode_step", _decode_step_cpu, _decode_step_cuda,
                  _decode_step_fake)
