"""The step kernel's planner (``ops/kernels/decode_step.plan_step``), on
the CPU.

The planner decides how ``csrc/decode_step.cu`` splits one step over the
CTAs of one cooperative launch; the kernel computes the same splits from
the plan's numbers (``load_slices``, ``attention_phase`` and
``gates_phase`` of ``csrc/decode_phases.cuh``). These tests hold the
splits to "everything is computed exactly once" and the shared memory to
the 227 KB a block may use.
"""

import numpy as np
import pytest

from depth_image_captioning_pub_torch.ops.kernels import decode_step

K, A, E, H = 196, 128, 128, 128     # the main shape
CASES = [(b, ctas, d) for b in (1, 3, 16, 64, 130, 500)
         for ctas in (132, 114) for d in (2048, 2080)]


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
    p = decode_step.plan_step(bsz, K, d, A, E, H, ctas)
    n = A + d                       # [W_dec | W_fb], no vocab head
    bounds = [c for s in p.h_slices for c in s]
    assert len(p.h_slices) == p.ctas == ctas
    assert bounds[0] == 0 and bounds[-1] == n
    assert all(c1 == c0 for c1, c0 in zip(bounds[1:-1:2], bounds[2::2]))
    assert all(c1 - c0 <= p.h_cols for c0, c1 in p.h_slices)
    assert p.h_cols % 4 == 0 and p.h_cols - 4 < -(-n // ctas)
    assert np.all(_gate_owners(p, bsz, H) == 1)
    # attention items: (row, chunk) with chunks covering D once, about
    # one item per CTA while the rows are fewer than the CTAs
    chunks = -(-d // p.a_chunk)
    assert p.a_chunk % 8 == 0 and (chunks - 1) * p.a_chunk < d
    assert chunks * p.a_chunk >= d
    assert bsz * chunks <= max(ctas, bsz) + bsz


@pytest.mark.parametrize("bsz,ctas,d", CASES)
def test_plan_fits_shared_memory(bsz, ctas, d):
    p = decode_step.plan_step(bsz, K, d, A, E, H, ctas)
    assert p.smem_bytes <= decode_step.SMEM_LIMIT == 227 * 1024
    assert p.smem_bytes == 4 * decode_step.step_smem_floats(
        K, d, A, E, H, p.h_cols, p.units, p.h_rows)
    assert p.h_rows % decode_step.H_ROWS == 0 and p.h_rows >= 4
    assert p.h_rows == -(-min(bsz, decode_step.H_TILE_MAX) // 4) * 4
    assert 1 <= p.units <= decode_step.G_UNITS
    assert p.scratch_floats == bsz * (2 * d + A)
    assert p.scratch_ints == 2 + bsz


@pytest.mark.parametrize("bsz,units,parts", [(1, 1, 1), (16, 1, 1),
                                             (32, 1, 1), (64, 1, 1),
                                             (127, 1, 1), (128, 2, 2),
                                             (130, 2, 2)])
def test_plan_units_follow_the_rows(bsz, units, parts):
    """One hidden unit per CTA below 128 rows, two from 128 on: each
    launch loads the gate slice anew, and a second unit doubles it."""
    assert decode_step.STEP_TWO_UNITS_FROM == 128
    p = decode_step.plan_step(bsz, K, 2048, A, E, H, 132)
    assert (p.units, p.g_parts, p.g_groups) == (units, parts, H // units)


def test_plan_shared_memory_by_batch():
    """Below 128 rows only the h tile grows with B, up to 64 rows; from
    128 rows a second unit's gate slice is added."""
    sizes = {b: decode_step.plan_step(b, K, 2048, A, E, H, 132)
             for b in (1, 16, 64, 130)}
    assert [sizes[b].h_rows for b in (1, 16, 64, 130)] == [4, 16, 64, 64]
    assert sizes[64].smem_bytes - sizes[16].smem_bytes == 4 * 48 * (H + 4)
    assert sizes[130].smem_bytes - sizes[64].smem_bytes == 4 * (
        (E + 2048 + H) * 4 + 4)
    assert sizes[1].smem_bytes == 67568        # measured plans, 132 CTAs
    assert max(p.smem_bytes for p in sizes.values()) < 150 * 1024


def test_plan_more_units_when_h_outnumbers_ctas():
    p = decode_step.plan_step(1, K, 2048, A, E, H, 100)
    assert p.units == 2 and np.all(_gate_owners(p, 1, H) == 1)


@pytest.mark.parametrize("kwargs,match", [
    (dict(d=2052), "multiples of 8"),
    (dict(e=12), "multiples of 8"),
    (dict(a=30), "multiple of 4"),
    (dict(h=512, ctas=100), "units per CTA"),
    (dict(d=16384), "shared memory"),
    (dict(bsz=0), "positive"),
])
def test_plan_raises_outside_envelope(kwargs, match):
    args = dict(bsz=8, k=K, d=2048, a=A, e=E, h=H, ctas=132)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        decode_step.plan_step(**args)
