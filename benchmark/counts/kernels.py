"""Operations and bytes of one launch of each hand-written kernel, and the
least time the card could take for them: the larger of the bytes (each
input read once, each output written once) over the memory rate and the
operations over the peak rate of the kernel's arithmetic."""

from __future__ import annotations

from typing import Iterable, Tuple

from counts import BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S
from counts.models import decoder_step


def least_seconds(nbytes: float, ops: float, peak: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def greedy_decode(row_steps: Iterable[int], k: int, d: int, a: int, e: int,
                  h: int, v: int, length: int, feature_bytes: int = 2
                  ) -> Tuple[int, int]:
    """K2, the whole greedy decode of one chunk: (operations, bytes) for
    rows that ran ``row_steps`` steps each (up to their first <end>).
    Inputs: features [B, K, D] (``feature_bytes`` an element), their f32
    projection [B, K, A], h0 and c0, the step's weights, the head and the
    embedding; the output tokens [B, length] int32; and each row's
    embedding row read at every step."""
    steps = list(row_steps)
    b, n = len(steps), sum(steps)
    step_weights = (h * a + 2 * a + 1 + h * d + d + (e + d + h) * 4 * h
                    + 4 * h)
    nbytes = (b * k * d * feature_bytes + 4 * (b * k * a + 2 * b * h)
              + 4 * (step_weights + h * v + v + v * e) + 4 * b * length
              + 4 * n * e)
    return n * decoder_step(k, d, a, e, h, v), nbytes


def greedy_decode_seconds(row_steps, k, d, a, e, h, v, length,
                          feature_bytes=2) -> float:
    ops, nbytes = greedy_decode(row_steps, k, d, a, e, h, v, length,
                                feature_bytes)
    return least_seconds(nbytes, ops, F32_FLOPS)


def vit_attention(z: int, n: int, d: int, elem_bytes: int = 2
                  ) -> Tuple[int, int]:
    """K5 over Z = batch x heads of N tokens of width d: softmax(q k^T) v,
    (operations, bytes): q, k, v read and the output written."""
    return 4 * z * n * n * d, 4 * z * n * d * elem_bytes


def vit_attention_seconds(z: int, n: int, d: int, elem_bytes: int = 2
                          ) -> float:
    ops, nbytes = vit_attention(z, n, d, elem_bytes)
    return least_seconds(nbytes, ops, BF16_FLOPS)


def group_norm(b: int, hw: int, c: int, residual: bool,
               elem_bytes: int = 2) -> int:
    """K6, one launch pair (statistics, apply) over x [b, hw, c]: its
    bytes, x read once, y written once and the residual read once; the
    statistics pass's second read of x is not counted, nor the few
    operations a value."""
    return (3 if residual else 2) * b * hw * c * elem_bytes


def group_norm_seconds(b: int, hw: int, c: int, residual: bool,
                       elem_bytes: int = 2) -> float:
    return least_seconds(group_norm(b, hw, c, residual, elem_bytes), 0,
                         BF16_FLOPS)
