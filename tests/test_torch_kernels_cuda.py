"""The CUDA kernels == their plain PyTorch versions, on the card.

Every test needs a CUDA device and skips without one. The file imports no
JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)

Tolerances: atol 1e-4 on h', c', alpha for the step (f32 sums in another
order than cuBLAS's); greedy tokens agree on >= 99% of positions (a
near-tie argmax may flip and the flip cascades along its row) and are
equal when the <end> bias ends every row at step 0.
"""

import numpy as np
import pytest
import torch

from depth_image_captioning_pub_torch.models.decoder import AttentionDecoder
from depth_image_captioning_pub_torch.ops.attention import project_features
from depth_image_captioning_pub_torch.ops.kernels import (
    decode_seq, decode_step)

pytestmark = pytest.mark.cuda

SHAPES = {"small": (10, 49, 64, 32, 24, 32, 40),      # B, K, D, A, E, H, V
          "main": (8, 196, 2048, 128, 128, 128, 9956)}
END = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _decoder(shape, dev, seed=0):
    bsz, k, d, a, e, h, v = shape
    dec = AttentionDecoder(v, dim_attention=a, dim_embedding=e,
                           dim_encoder=d, dim_decoder=h, device=dev)
    dec.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(np.abs(rng.standard_normal((bsz, k, d))).astype(
        np.float32)).to(dev)
    return dec, feats


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_step_kernel_matches_plain(cuda, shape, storage):
    dec, feats = _decoder(SHAPES[shape], cuda)
    bsz, e, h = feats.shape[0], dec.dim_embedding, dec.att_w_dec.shape[0]
    f = feats.to(getattr(torch, storage))
    rng = np.random.default_rng(1)
    emb, hh, cc = (torch.from_numpy(rng.standard_normal((bsz, n)).astype(
        np.float32)).to(cuda) for n in (e, h, h))
    with torch.inference_mode():
        proj = project_features(dec.att_params(), f,
                                compute_dtype=torch.float32)
        w = dec.seq_weights().step
        before = decode_step.LAUNCHES
        got = decode_step.fused_decode_core(f, proj, emb, hh, cc, w)
        torch.cuda.synchronize()
        assert decode_step.LAUNCHES == before + 1
        want = decode_step.fused_decode_core_plain(f, proj, emb, hh, cc, w)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("end_bias", [0.0, 100.0])
def test_greedy_kernel_matches_plain(cuda, shape, end_bias):
    dec, feats = _decoder(SHAPES[shape], cuda, seed=2)
    f = feats.to(torch.bfloat16)
    with torch.inference_mode():
        dec.out_b[END] += end_bias
        proj = project_features(dec.att_params(), f,
                                compute_dtype=torch.float32)
        state = dec.init_state(f)
        w = dec.seq_weights()
        before = decode_seq.LAUNCHES
        got = decode_seq.fused_greedy_decode(
            f, proj, state.h, state.c, w, max_length=30, start_id=2,
            end_id=END)
        torch.cuda.synchronize()
        assert decode_seq.LAUNCHES == before + 1
        want = decode_seq.fused_greedy_decode_plain(
            f, proj, state.h, state.c, w, max_length=30, start_id=2,
            end_id=END)
    assert got.dtype == torch.int32
    agree = (got == want).float().mean().item()
    assert agree >= 0.99, agree
    if end_bias:
        assert torch.equal(got, want) and bool((got == END).all())


def test_decoder_greedy_sample_on_card_matches_cpu(cuda):
    """AttentionDecoder.greedy_sample without <end>: the kernel on the card
    against the same decoder's plain path on the CPU."""
    dec, feats = _decoder(SHAPES["small"], cuda, seed=3)
    with torch.inference_mode():
        before = decode_seq.LAUNCHES
        got = dec.greedy_sample(feats, 2, max_length=7)
        assert decode_seq.LAUNCHES == before + 1
        want = dec.cpu().greedy_sample(feats.cpu(), 2, max_length=7)
    assert tuple(got.shape) == (feats.shape[0], 7)
    assert (got.cpu() == want).float().mean().item() >= 0.99


def test_kernel_wrappers_reject_strided_input(cuda):
    dec, feats = _decoder(SHAPES["small"], cuda)
    with torch.inference_mode():
        proj = project_features(dec.att_params(), feats,
                                compute_dtype=torch.float32)
        state = dec.init_state(feats)
        strided = feats.transpose(1, 2).contiguous().transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            decode_seq.fused_greedy_decode(strided, proj, state.h, state.c,
                                           dec.seq_weights())
        with pytest.raises(ValueError, match="expected"):
            decode_seq.fused_greedy_decode(feats, proj.cpu(), state.h,
                                           state.c, dec.seq_weights())
