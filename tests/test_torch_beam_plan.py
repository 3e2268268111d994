"""The beam kernel's planner (``ops/kernels/beam_seq.plan_beam``), on the
CPU.

The planner decides how ``csrc/beam_seq.cu`` splits the search of B images
x W beams over the CTAs of one persistent launch; the kernel computes the
same splits from the plan's numbers. These tests hold the splits to
"everything is computed exactly once" (h-product columns, (hidden unit,
beam row) pairs, attention items, each image's top-W) and the shared memory
to the 227 KB a block may use, less the kernel's static arrays.
"""

import numpy as np
import pytest

from depth_image_captioning_pub_torch.ops.kernels import beam_seq

K, A, E, H, V = 196, 128, 128, 128, 9956     # the main shape
WARPS = beam_seq.THREADS // 32
CASES = [(b, w, ctas, d) for b in (1, 16, 64, 130)
         for w in beam_seq.BEAM_SIZES
         for ctas in (132, 114) for d in (2048, 2080)]


def _gate_owners(p, rows, h):
    """(unit, row) -> number of CTAs computing it, as gates_phase splits
    the rows."""
    seen = np.zeros((h, rows), dtype=np.int64)
    for cta in range(min(p.ctas, p.g_groups * p.g_parts)):
        j0 = cta % p.g_groups * p.units
        part = cta // p.g_groups
        lo = part * rows // p.g_parts
        hi = (part + 1) * rows // p.g_parts
        seen[j0:min(h, j0 + p.units), lo:hi] += 1
    return seen


def _context_partials(wd, beam, vec):
    """Floats of phase A's shared partial sums for a chunk of wd columns
    (attention_phase: 8 column groups of `vec` per warp, warps over K)."""
    groups = wd // vec
    gblocks = -(-groups // 8)
    ws = max(1, WARPS // gblocks)
    return ws * wd * beam if ws > 1 else 0


@pytest.mark.parametrize("bsz,beam,ctas,d", CASES)
def test_plan_beam_computes_everything_once(bsz, beam, ctas, d):
    p = beam_seq.plan_beam(bsz, beam, K, d, A, E, H, V, ctas)
    rows = bsz * beam
    assert p.rows == rows
    n = A + d + V
    bounds = [c for s in p.h_slices for c in s]
    assert bounds[0] == 0 and bounds[-1] == n
    assert all(c1 == c0 for c1, c0 in zip(bounds[1:-1:2], bounds[2::2]))
    assert all(c1 - c0 <= p.h_cols for c0, c1 in p.h_slices)
    assert len(p.h_slices) == ctas and p.h_cols % 4 == 0
    assert np.all(_gate_owners(p, rows, H) == 1)
    # attention items (image, chunk), dealt out item % ctas: every image's
    # chunks cover D once
    chunks = -(-d // p.a_chunk)
    assert p.a_chunk % 8 == 0 and (chunks - 1) * p.a_chunk < d
    items = np.zeros((bsz, chunks), dtype=np.int64)
    for cta in range(ctas):
        for item in range(cta, bsz * chunks, ctas):
            items[item // chunks, item % chunks] += 1
    assert np.all(items == 1)
    # top-W: image b on CTA b % ctas, one owner each
    owners = np.bincount([b % ctas for b in range(bsz)], minlength=ctas)
    assert owners.sum() == bsz and owners.max() == -(-bsz // ctas)
    # gated, dec, gp, h and c twice, the rows' partial lse per CTA, and the
    # top-W of each (image, vocabulary chunk) item of phase T1
    chunks = max(1, min(ctas // bsz, V))
    assert p.scratch_floats == rows * (2 * d + A + 4 * H + 2 * ctas) + (
        bsz * chunks * beam)
    assert p.scratch_ints == 2 + 3 * rows + bsz * chunks * beam


@pytest.mark.parametrize("bsz,beam,ctas,d", CASES)
def test_plan_beam_fits_shared_memory(bsz, beam, ctas, d):
    p = beam_seq.plan_beam(bsz, beam, K, d, A, E, H, V, ctas)
    assert p.smem_bytes <= beam_seq.SMEM_LIMIT - beam_seq.STATIC_SMEM
    assert beam_seq.SMEM_LIMIT == 227 * 1024
    assert p.smem_bytes == 4 * beam_seq.smem_floats(
        K, d, A, E, H, beam, p.h_cols, p.units, p.h_rows)
    assert p.h_rows % beam_seq.BEAM_H_ROWS == 0 and p.h_rows >= 4
    assert 1 <= p.units <= beam_seq.G_UNITS
    # phase A's partial sums and the gate products' fit their carve
    part = 2 * beam_seq.THREADS * beam
    chunk_widths = {min(p.a_chunk, d - d0) for d0 in range(0, d, p.a_chunk)}
    for vec in (4, 8):          # f32 and bf16 features
        for wd in chunk_widths:
            assert _context_partials(wd, beam, vec) <= part
    assert WARPS * beam_seq.G_UNITS * 4 * 4 <= part   # up to 4 rows a warp


def test_plan_beam_units_follow_the_rows():
    """As the greedy kernel: one hidden unit per CTA below 32 beam rows,
    two from 32 on."""
    assert beam_seq.plan_beam(1, 5, K, 2048, A, E, H, V, 132).units == 1
    assert beam_seq.plan_beam(4, 5, K, 2048, A, E, H, V, 132).units == 1
    p = beam_seq.plan_beam(64, 5, K, 2048, A, E, H, V, 132)
    assert p.units == 2 and p.g_parts == 2 and p.rows == 320


@pytest.mark.parametrize("kwargs,match", [
    (dict(beam=9), "beam sizes"),
    (dict(beam=1), "beam sizes"),
    (dict(d=2052), "multiples of 8"),
    (dict(h=20), "multiples of 8"),
    (dict(a=30), "multiple of 4"),
    (dict(h=512, ctas=100), "units per CTA"),
    (dict(d=16384), "shared memory"),
    (dict(bsz=0), "positive"),
])
def test_plan_beam_raises_outside_envelope(kwargs, match):
    args = dict(bsz=8, beam=5, k=K, d=2048, a=A, e=E, h=H, v=V, ctas=132)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        beam_seq.plan_beam(**args)
