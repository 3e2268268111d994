"""The CUDA kernels == their plain PyTorch versions, on the card.

Every test needs a CUDA device and skips without one. The file imports no
JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)

Tolerances: atol 1e-4 on h', c', alpha for the step (f32 sums in another
order than cuBLAS's); greedy tokens agree on >= 99% of positions (a
near-tie argmax may flip and the flip cascades along its row) and are
equal when the <end> bias ends every row at step 0. ViT attention (K5):
in f32, atol 1e-5 (sums in another order); in bf16, atol of one bf16 ulp
of max|v| (2^-7 * max|v|; each output is a convex mix of v's rows, so
|out| <= max|v|), because p and the output are rounded to bf16 and an f32
sum in another order can round either way.
"""

import numpy as np
import pytest
import torch

from depth_image_captioning_pub_torch.models.decoder import AttentionDecoder
from depth_image_captioning_pub_torch.ops.attention import project_features
from depth_image_captioning_pub_torch.ops.kernels import (
    decode_seq, decode_step, vit_attention)

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


@pytest.mark.parametrize("n,n_valid", [(1, 1), (17, 17), (577, 577),
                                       (584, 577)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_attention_matches_plain(cuda, n, n_valid, dtype):
    rng = np.random.default_rng(n)
    z, d = 6, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((z, n, d)).astype(
        np.float32)).to(cuda, getattr(torch, dtype)) for _ in range(3))
    before = vit_attention.LAUNCHES
    got = vit_attention.fused_attention(q, k, v, scale=d ** -0.5,
                                        n_valid=n_valid)
    torch.cuda.synchronize()
    assert vit_attention.LAUNCHES == before + 1
    want = vit_attention.fused_attention_plain(q, k, v, scale=d ** -0.5,
                                               n_valid=n_valid)
    assert got.dtype == v.dtype and got.shape == v.shape
    atol = 1e-5 if dtype == "float32" else 2 ** -7 * v.abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def test_vit_attention_masks_padded_keys(cuda):
    """Keys >= n_valid get no weight: garbage there changes nothing."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 40, 32)).astype(
        np.float32)).to(cuda) for _ in range(3))
    out = vit_attention.fused_attention(q, k, v, scale=0.2, n_valid=33)
    k[:, 33:] = 1e4
    v[:, 33:] = float("nan")
    again = vit_attention.fused_attention(q, k, v, scale=0.2, n_valid=33)
    assert torch.equal(out, again)


def test_vit_attention_rejects_outside_envelope(cuda):
    q = torch.zeros(2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        vit_attention.fused_attention(q, q, q, scale=1.0, n_valid=8)
    q = torch.zeros(1, 4096, 64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        vit_attention.fused_attention(q, q, q, scale=1.0, n_valid=4096)
    q = torch.zeros(2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        vit_attention.fused_attention(q.transpose(0, 1).contiguous()
                                      .transpose(0, 1), q, q, scale=1.0,
                                      n_valid=8)
