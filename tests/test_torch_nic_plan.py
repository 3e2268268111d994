"""The NIC greedy kernel's planner (``ops/kernels/nic_seq.plan_nic``) and
its zero-padding of E and H (``nic_seq.pad_nic``), on the CPU.

The planner decides how ``csrc/nic_seq.cu`` splits the work over the CTAs
of one persistent launch; the kernel computes the same splits from the
plan's numbers. These tests hold the splits to "everything is computed
exactly once", the shared memory to the 227 KB a block may use, and the
padding to "the same tokens": a padded hidden unit stays exactly 0, so the
padded weights give the unpadded logits (atol 1e-6: the products sum the
same terms plus exact zeros, in another order of blocks).
"""

import numpy as np
import pytest
import torch

from depth_image_captioning_pub_torch.models.nic import NICDecoder
from depth_image_captioning_pub_torch.ops.kernels import nic_seq
from depth_image_captioning_pub_torch.ops.lstm import stacked_lstm_step

SHAPES = {"main": (300, 128, 2, 9956),      # E, H, layers, V
          "four_layers": (300, 128, 4, 9956),
          "odd": (37, 30, 2, 41)}           # E and H padded, V < CTAs
CASES = [(shape, b, ctas) for shape in sorted(SHAPES)
         for b in (1, 16, 64, 130) for ctas in (132, 114)]


def _gate_owners(p, bsz):
    """(unit, row) -> number of CTAs computing it, as nic_gates_phase
    splits the rows."""
    seen = np.zeros((p.h, bsz), dtype=np.int64)
    for cta in range(min(p.ctas, p.g_groups * p.g_parts)):
        j0 = cta % p.g_groups * p.units
        part = cta // p.g_groups
        lo = part * bsz // p.g_parts
        hi = (part + 1) * bsz // p.g_parts
        seen[j0:min(p.h, j0 + p.units), lo:hi] += 1
    return seen


@pytest.mark.parametrize("shape,bsz,ctas", CASES)
def test_plan_computes_everything_once(shape, bsz, ctas):
    e, h, layers, v = SHAPES[shape]
    p = nic_seq.plan_nic(bsz, e, h, layers, v, ctas)
    assert p.ctas == ctas and len(p.h_slices) == ctas
    bounds = [c for s in p.h_slices for c in s]
    assert bounds[0] == 0 and bounds[-1] == v
    assert all(c1 == c0 for c1, c0 in zip(bounds[1:-1:2], bounds[2::2]))
    assert all(c1 - c0 <= p.h_cols for c0, c1 in p.h_slices)
    assert p.h_cols % 4 == 0
    assert p.e % 4 == 0 and e <= p.e < e + 4
    assert p.h % 4 == 0 and h <= p.h < h + 4
    assert p.g_groups * p.units >= p.h
    assert np.all(_gate_owners(p, bsz) == 1)


@pytest.mark.parametrize("shape,bsz,ctas", CASES)
def test_plan_fits_shared_memory(shape, bsz, ctas):
    e, h, layers, v = SHAPES[shape]
    p = nic_seq.plan_nic(bsz, e, h, layers, v, ctas)
    assert p.smem_bytes <= nic_seq.SMEM_LIMIT == 227 * 1024
    assert p.smem_bytes == 4 * nic_seq.smem_floats(
        p.e, p.h, layers, p.h_cols, p.units, p.h_rows)
    assert p.h_rows % nic_seq.H_ROWS == 0 and p.h_rows >= 4
    assert 1 <= p.units <= nic_seq.G_UNITS
    assert p.scratch_floats == bsz * (3 * layers * p.h + ctas)
    assert p.scratch_ints == 2 + bsz * ctas


def test_plan_main_shape():
    """No padding at E=300, H=128; 76 head columns per CTA; one h tile of
    the rows up to 64."""
    p = nic_seq.plan_nic(64, 300, 128, 2, 9956, 132)
    assert (p.e, p.h, p.h_cols, p.units, p.g_parts) == (300, 128, 76, 2, 2)
    assert p.h_rows == 64
    assert nic_seq.plan_nic(130, 300, 128, 2, 9956, 132).h_rows == 64
    assert nic_seq.plan_nic(1, 300, 128, 2, 9956, 100).units == 2


@pytest.mark.parametrize("bsz,units", [(1, 1), (8, 1), (10, 1), (11, 2),
                                       (16, 2), (17, 1), (32, 1), (33, 2),
                                       (64, 2), (130, 2)])
def test_units_follow_the_g_split(bsz, units):
    """One G pass over a CTA's rows before two, then no row group of
    exactly two warps, then one unit per CTA before two (at 132 CTAs one
    unit gives 128 unit groups and one row part, two give 64 and two)."""
    p = nic_seq.plan_nic(bsz, 300, 128, 2, 9956, 132)
    assert p.units == units
    rows = -(-bsz // p.g_parts)
    groups = -(-rows // nic_seq.G_ROWS)
    passes = -(-groups // nic_seq.WARPS)
    assert passes == 1 or bsz > 2 * nic_seq.WARPS * nic_seq.G_ROWS
    assert passes > 1 or nic_seq.WARPS // groups != 2


@pytest.mark.parametrize("kwargs,match", [
    (dict(bsz=0), "positive"),
    (dict(v=0), "positive"),
    (dict(layers=0), "1 to 4 layers"),
    (dict(layers=5), "1 to 4 layers"),
    (dict(h=600), "units per CTA"),
    (dict(e=60000), "shared memory"),
])
def test_plan_raises_outside_envelope(kwargs, match):
    args = dict(bsz=8, e=300, h=128, layers=2, v=9956, ctas=132)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        nic_seq.plan_nic(**args)


def _weights(e, h, layers, v, seed):
    dec = NICDecoder(v, dim_embedding=e, dim_hidden=h, num_layers=layers,
                     device="cpu")
    dec.reset_parameters(torch.Generator().manual_seed(seed))
    x0 = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (5, e)).astype(np.float32))
    return x0, dec.seq_weights()


def test_pad_nic_keeps_aligned_widths():
    x0, w = _weights(24, 16, 2, 40, 0)
    x0p, wp = nic_seq.pad_nic(x0, w, 24, 16)
    assert x0p is x0 and wp is w


@pytest.mark.parametrize("e,h,layers", [(37, 30, 2), (24, 18, 1),
                                        (13, 32, 3)])
@torch.no_grad()
def test_padded_weights_give_the_same_decode(e, h, layers):
    """The plain version on the padded inputs: integer-equal tokens, the
    unpadded logits and h at every step of the same token path, and the
    padded hidden units exactly 0."""
    x0, w = _weights(e, h, layers, 41, seed=e)
    p = nic_seq.plan_nic(x0.shape[0], e, h, layers, 41, 132)
    x0p, wp = nic_seq.pad_nic(x0, w, p.e, p.h)
    assert x0p.shape == (5, p.e) and wp.embed.shape == (41, p.e)
    assert wp.w_out.shape == (p.h, 41)
    want = nic_seq.fused_nic_greedy_decode_plain(x0, w, max_length=12)
    got = nic_seq.fused_nic_greedy_decode_plain(x0p, wp, max_length=12)
    assert torch.equal(got, want)
    lstm, lstm_p = nic_seq._stacked(w), nic_seq._stacked(wp)
    hs = torch.zeros((layers, 5, h))
    cs = torch.zeros_like(hs)
    hs_p = torch.zeros((layers, 5, p.h))
    cs_p = torch.zeros_like(hs_p)
    x, x_p = x0, x0p
    for t in range(12):
        out, hs, cs = stacked_lstm_step(lstm, x, hs, cs)
        out_p, hs_p, cs_p = stacked_lstm_step(lstm_p, x_p, hs_p, cs_p)
        np.testing.assert_allclose((out_p @ wp.w_out + wp.b_out).numpy(),
                                   (out @ w.w_out + w.b_out).numpy(),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(hs_p[..., :h].numpy(), hs.numpy(),
                                   atol=1e-6, rtol=0)
        assert not hs_p[..., h:].any() and not cs_p[..., h:].any()
        tok = want[:, t].long()
        x, x_p = w.embed[tok], wp.embed[tok]
