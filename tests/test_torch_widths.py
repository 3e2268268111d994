"""Widths and beam sizes the kernels of the shared decode phases take, on
the CPU.

* Odd widths: K1, K2 and K4 read 16 or 32 bytes at a time, so their
  wrappers zero-pad D, E and H to multiples of 8 and A to a multiple of 4
  for a launch (``decode_step.pad_step``, ``decode_seq.pad_seq``) and
  slice h' and c' back. Here the padding's plain-version twin (pad ->
  plain version -> slice) is held to the unpadded plain version: K2's
  tokens and K4's token and parent records integer-equal, K4's scores and
  K1's h', c' and alpha within 1e-6 (the zero terms can move a product's
  summation blocks), and every padded hidden unit exactly 0. At the
  published widths nothing is padded or copied.
* Beam widths: K4 has instances for W = 2..8 (``beam_seq.BEAM_SIZES``). A
  wider soft-attention beam on a CUDA device raises in
  ``make_caption_fn`` and ``CaptionPipeline`` before any work, through the
  same dispatch that picks the kernel; the CPU, hard attention and NIC run
  plain ops and take any W.
"""

import numpy as np
import pytest
import torch

from depth_image_captioning_pub_torch.config import ConfigTrain
from depth_image_captioning_pub_torch.engine.evaluate import make_caption_fn
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.models.decoder import AttentionDecoder
from depth_image_captioning_pub_torch.ops.attention import project_features
from depth_image_captioning_pub_torch.ops.kernels import (
    beam_seq, decode_seq, decode_step)
from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

K, V, L = 12, 41, 9
START, END = 1, 2
# (D, A, E, H): every width odd, one at a time, and the published ones
WIDTHS = {"odd": (44, 10, 20, 18), "d": (37, 16, 16, 16),
          "a": (32, 6, 16, 16), "e": (32, 16, 13, 16),
          "h": (32, 16, 16, 21), "aligned": (32, 16, 16, 16)}


def _decoder(d, a, e, h, seed):
    dec = AttentionDecoder(V, a, e, d, h, device="cpu")
    dec.reset_parameters(torch.Generator().manual_seed(seed))
    return dec


def _inputs(dec, d, bsz, seed):
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(np.abs(rng.standard_normal((bsz, K, d)))
                             .astype(np.float32))
    proj = project_features(dec.att_params(), feats,
                            compute_dtype=torch.float32)
    state = dec.init_state(feats)
    return feats, proj, state.h, state.c


@pytest.mark.parametrize("case", sorted(WIDTHS))
@torch.no_grad()
def test_padded_step_equals_the_step(case):
    d, a, e, h = WIDTHS[case]
    dec = _decoder(d, a, e, h, seed=len(case))
    feats, proj, h0, c0 = _inputs(dec, d, 5, seed=3)
    emb = dec.embed[torch.arange(5)]
    w = dec.seq_weights().step
    padded = decode_step.pad_step(feats, proj, emb, h0, c0, w)
    dp, ap, ep, hp = decode_step.kernel_widths(d, a, e, h)
    assert dp % 8 == ep % 8 == hp % 8 == 0 and ap % 4 == 0
    assert padded[0].shape == (5, K, dp) and padded[2].shape == (5, ep)
    assert padded[5].w_ih_c.shape == (dp, 4 * hp)
    want = decode_step.fused_decode_core_plain(feats, proj, emb, h0, c0, w)
    got = decode_step.fused_decode_core_plain(*padded)
    for g, x in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g[:, :h].numpy(), x.numpy(), rtol=0,
                                   atol=1e-6)
        assert not g[:, h:].any()          # padded hidden units stay 0
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), rtol=0,
                               atol=1e-6)
    if case == "aligned":                   # nothing padded, nothing copied
        assert all(p is x for p, x in zip(padded[:5],
                                          (feats, proj, emb, h0, c0)))
        assert all(p is x for p, x in zip(padded[5], w))


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("case", sorted(WIDTHS))
@torch.no_grad()
def test_padded_greedy_equals_the_greedy(case, forced):
    d, a, e, h = WIDTHS[case]
    dec = _decoder(d, a, e, h, seed=7 + len(case))
    feats, proj, h0, c0 = _inputs(dec, d, 6, seed=4)
    w = dec.seq_weights()
    if forced:                                 # every row ends at step 0
        w = w._replace(b_out=w.b_out + 100.0 * (torch.arange(V) == END))
    kw = dict(max_length=L, start_id=START, end_id=END)
    padded = decode_seq.pad_seq(feats, proj, h0, c0, w)
    assert padded[4].w_out.shape[0] % 8 == 0
    want = decode_seq.fused_greedy_decode_plain(feats, proj, h0, c0, w, **kw)
    got = decode_seq.fused_greedy_decode_plain(*padded, **kw)
    assert torch.equal(got, want)
    assert len({tuple(r) for r in want.tolist()}) > (0 if forced else 1)
    if forced:
        assert bool((got == END).all())
    if case == "aligned":
        assert all(p is x for p, x in zip(padded[:4], (feats, proj, h0, c0)))
        assert padded[4].w_out is w.w_out and padded[4].embed is w.embed


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("case", sorted(WIDTHS))
@torch.no_grad()
def test_padded_beam_equals_the_beam(case, forced):
    d, a, e, h = WIDTHS[case]
    dec = _decoder(d, a, e, h, seed=11 + len(case))
    feats, proj, h0, c0 = _inputs(dec, d, 4, seed=5)
    w = dec.seq_weights()
    if forced:
        w = w._replace(b_out=w.b_out + 100.0 * (torch.arange(V) == END))
    kw = dict(beam_size=3, max_length=L, start_id=START, end_id=END)
    want = beam_seq.fused_beam_decode_plain(feats, proj, h0, c0, w, **kw)
    got = beam_seq.fused_beam_decode_plain(
        *decode_seq.pad_seq(feats, proj, h0, c0, w), **kw)
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.parents, want.parents)
    np.testing.assert_allclose(got.scores.numpy(), want.scores.numpy(),
                               rtol=0, atol=1e-6)


def test_kernel_widths_keep_the_published_ones():
    cfg = ConfigTrain()
    widths = (cfg.dim_encoder, cfg.dim_attention, cfg.dim_embedding,
              cfg.dim_hidden)
    assert decode_step.kernel_widths(*widths) == widths
    assert decode_step.kernel_widths(2080, 128, 128, 128) == (2080, 128, 128,
                                                              128)
    assert decode_step.kernel_widths(2044, 50, 100, 100) == (2048, 52, 104,
                                                             104)


# ---- beam widths ------------------------------------------------------------

def test_beam_sizes_are_two_to_eight():
    assert beam_seq.BEAM_SIZES == tuple(range(2, 9))
    for beam in beam_seq.BEAM_SIZES + (1, 9, 12):
        beam_seq.check_beam_size(beam, torch.device("cpu"))
    for beam in beam_seq.BEAM_SIZES:
        beam_seq.check_beam_size(beam, torch.device("cuda"))
    for beam in (1, 9, 16):      # W = 1 is greedy decode, not the kernel
        with pytest.raises(ValueError, match=r"beam sizes \(2, 3, 4, 5, 6, "
                                             r"7, 8\), got"):
            beam_seq.check_beam_size(beam, "cuda")


def _captioner(kind):
    cap = build_captioner(kind, 30, ConfigTrain(),
                          encoder_dtype=torch.float32,
                          resnet_layers=(1, 1, 1, 1), device="cpu")
    cap.init(torch.Generator().manual_seed(0))
    return cap


class _NoWork:
    """Fails the test if the encoder or the decoder is reached."""

    def __init__(self, cap):
        self.cap = cap

    def __enter__(self):
        def boom(*args, **kwargs):
            raise AssertionError("work started before the refusal")
        self.cap.encoder.forward = boom
        self.cap.decoder.beam_sample = boom
        return self

    def __exit__(self, *exc):
        del self.cap.encoder.forward, self.cap.decoder.beam_sample


def test_wide_soft_beam_on_the_card_raises_before_any_work(monkeypatch):
    """A soft captioner that says it lives on the card: W = 9 raises in
    ``make_caption_fn`` and ``CaptionPipeline.__init__``, naming the
    widths, before any encoder or decoder call; W = 8 builds."""
    cap = _captioner("base-soft")
    monkeypatch.setattr(cap, "device", torch.device("cuda"))
    w2i = {f"w{i}": i for i in range(30)}
    w2i.update({"<start>": 26, "<end>": 27})
    i2w = {i: w for w, i in w2i.items()}
    with _NoWork(cap):
        with pytest.raises(ValueError, match="beam sizes"):
            make_caption_fn(cap, 26, end_id=27, beam_size=9)
        with pytest.raises(ValueError, match="beam sizes"):
            CaptionPipeline(cap, w2i, i2w, beam_size=9)
        make_caption_fn(cap, 26, end_id=27, beam_size=8)
        make_caption_fn(cap, 26, end_id=27, beam_size=1)


@pytest.mark.parametrize("kind", ["base-soft", "base-hard", "nic"])
def test_any_beam_width_on_plain_ops(kind):
    """The CPU's plain search (soft attention), hard attention's and
    NIC's take W = 9."""
    cap = _captioner(kind)
    images = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 64, 64, 3), dtype=np.uint8))
    fn = make_caption_fn(cap, 26, max_length=5, end_id=27, beam_size=9,
                         generator=torch.Generator().manual_seed(0))
    toks = fn(images)
    assert toks.shape == (2, 5) and toks.dtype == torch.int32
