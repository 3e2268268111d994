"""The greedy kernel's planner (``ops/kernels/decode_seq.plan``) and the
TF32 guard (``ops/precision.full_f32``), on the CPU.

The planner decides how ``csrc/decode_seq.cu`` splits the work over the
CTAs of one persistent launch; the kernel computes the same splits from
the plan's numbers. These tests hold the splits to "everything is computed
exactly once" and the shared memory to the 227 KB a block may use.
"""

import numpy as np
import pytest
import torch

from depth_image_captioning_pub_torch.models.decoder import AttentionDecoder
from depth_image_captioning_pub_torch.ops.kernels import decode_seq
from depth_image_captioning_pub_torch.ops.precision import full_f32

K, A, E, H, V = 196, 128, 128, 128, 9956     # the main shape
CASES = [(b, ctas, d) for b in (1, 16, 64, 130, 500) for ctas in (132, 114)
         for d in (2048, 2080)]


def _gate_owners(p, bsz, h):
    """(unit, row) -> number of CTAs computing it, as gates_phase splits
    the rows."""
    seen = np.zeros((h, bsz), dtype=np.int64)
    for cta in range(min(p.ctas, p.g_groups * p.g_parts)):
        j0 = cta % p.g_groups * p.units
        part = cta // p.g_groups
        lo = part * bsz // p.g_parts
        hi = (part + 1) * bsz // p.g_parts
        seen[j0:min(h, j0 + p.units), lo:hi] += 1
    return seen


@pytest.mark.parametrize("bsz,ctas,d", CASES)
def test_plan_computes_everything_once(bsz, ctas, d):
    p = decode_seq.plan(bsz, K, d, A, E, H, V, ctas)
    n = A + d + V
    bounds = [c for s in p.h_slices for c in s]
    assert bounds[0] == 0 and bounds[-1] == n
    assert all(c1 == c0 for c1, c0 in zip(bounds[1:-1:2], bounds[2::2]))
    assert all(c1 - c0 <= p.h_cols for c0, c1 in p.h_slices)
    assert p.h_cols % 4 == 0
    assert np.all(_gate_owners(p, bsz, H) == 1)
    # attention items: (row, chunk) with chunks covering D once
    chunks = -(-d // p.a_chunk)
    assert p.a_chunk % 8 == 0 and (chunks - 1) * p.a_chunk < d
    assert chunks * p.a_chunk >= d


@pytest.mark.parametrize("bsz,ctas,d", CASES)
def test_plan_fits_shared_memory(bsz, ctas, d):
    p = decode_seq.plan(bsz, K, d, A, E, H, V, ctas)
    assert p.smem_bytes <= decode_seq.SMEM_LIMIT == 227 * 1024
    assert p.smem_bytes == 4 * decode_seq.smem_floats(
        K, d, A, E, H, p.h_cols, p.units, p.h_rows, decode_seq.THREADS)
    assert p.h_rows % decode_seq.H_ROWS == 0 and p.h_rows >= 4
    assert 1 <= p.units <= decode_seq.G_UNITS


def test_plan_units_follow_the_rows():
    """One hidden unit per CTA below 32 rows, two from 32 on (half the
    CTAs read each row's input); more when H outnumbers the CTAs."""
    assert decode_seq.TWO_UNITS_FROM == 32
    assert decode_seq.plan(16, K, 2048, A, E, H, V, 132).units == 1
    assert decode_seq.plan(31, K, 2048, A, E, H, V, 132).units == 1
    assert decode_seq.plan(64, K, 2048, A, E, H, V, 132).units == 2
    assert decode_seq.plan(64, K, 2048, A, E, H, V, 132).g_parts == 2
    assert decode_seq.plan(1, K, 2048, A, E, H, V, 100).units == 2
    p = decode_seq.plan(32, K, 2048, A, E, H, V, 132)
    assert p.units == 2 and p.g_parts == 2
    assert np.all(_gate_owners(p, 32, H) == 1)


@pytest.mark.parametrize("kwargs,match", [
    (dict(d=2052), "multiples of 8"),
    (dict(e=12), "multiples of 8"),
    (dict(a=30), "multiple of 4"),
    (dict(h=512, ctas=100), "units per CTA"),
    (dict(d=16384), "shared memory"),
    (dict(bsz=0), "positive"),
])
def test_plan_raises_outside_envelope(kwargs, match):
    args = dict(bsz=8, k=K, d=2048, a=A, e=E, h=H, v=V, ctas=132)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        decode_seq.plan(**args)


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _set_flags(matmul, conv):
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = conv


@pytest.mark.parametrize("matmul,conv", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_full_f32_restores_both_flags(matmul, conv):
    saved = _flags()
    try:
        _set_flags(matmul, conv)
        with full_f32():
            assert _flags() == (False, False)
        assert _flags() == (matmul, conv)
        with pytest.raises(RuntimeError, match="inside"):
            with full_f32():
                raise RuntimeError("inside")
        assert _flags() == (matmul, conv)
    finally:
        _set_flags(*saved)


def test_decoder_products_run_without_tf32(monkeypatch):
    """greedy_sample's f32 products see both flags off; the caller's
    flags are back afterwards."""
    from depth_image_captioning_pub_torch.models import decoder as dec_mod
    seen = []
    real = dec_mod.project_features

    def probe(*args, **kwargs):
        seen.append(_flags())
        return real(*args, **kwargs)

    monkeypatch.setattr(dec_mod, "project_features", probe)
    dec = AttentionDecoder(40, dim_attention=8, dim_embedding=8,
                           dim_encoder=16, dim_decoder=8, device="cpu")
    dec.reset_parameters(torch.Generator().manual_seed(0))
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 9, 16)).astype(np.float32))
    saved = _flags()
    try:
        _set_flags(True, True)
        dec.greedy_sample(feats, 2, max_length=3)
        assert seen == [(False, False)]
        assert _flags() == (True, True)
    finally:
        _set_flags(*saved)
