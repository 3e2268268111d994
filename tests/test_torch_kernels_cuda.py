"""The CUDA kernels == their plain PyTorch versions, on the card.

Every test needs a CUDA device and skips without one. The file imports no
JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)

Tolerances: atol 1e-4 on h', c', alpha for the step (f32 sums in another
order than cuBLAS's), also at widths that are zero-padded for the launch
and at mdepth's D=2080 with f32 features, and two calls of the step
bit-identical; sampled tokens through the step agree with those through
its plain version on the same noise on >= 99% of positions (a near-tie
of logits + noise may flip a draw); greedy tokens agree on >= 99% of
positions (a near-tie argmax may flip and the flip cascades along its row) and are
equal when the <end> bias ends every row at step 0; two calls of the
greedy kernel give bit-identical tokens (fixed sum orders). The same holds for the
NIC greedy kernel (K3; exact when one token's bias is raised by 100) and
for the beam kernel (K4): best tokens and (token, parent) records agree on
>= 99% and the final scores within 1e-3 (log-probabilities summed over up to 30 steps, each from sums
in another order); records are exact when <end> is forced and when a
zeroed vocab head makes every token tie (the tie order alone decides). ViT attention (K5):
in f32, atol 1e-5 (sums in another order); in bf16 (the tensor-core
route, at d = 32, 64, 128 and N from 1 to 2048), atol of one bf16 ulp of
max|v| (2^-7 * max|v|; each output is a convex mix of v's rows, so
|out| <= max|v|), because p and the output are rounded to bf16 and an f32
sum in another order can round either way. NHWC GroupNorm (K6) against
its plain version: f32 within 1e-5 of max|y|, bf16 within one bf16 ulp of
each value (two with a residual: the normalised value's and the sum's)
plus that floor, since only the order of the f32 statistic sums differs
(``_gn_check``); against nn.GroupNorm on the NCHW copy the same, and in
bf16 the reference's own error besides, since it applies its mean and
rstd rounded to bf16 (``_gn_library_slack``); two calls bit-identical. A two-set scored evaluation
(``engine/evaluate.evaluate`` over checkpoint files that
``utils/checkpoint.save_component`` wrote) on the card agrees with the
same run on the CPU on >= 99% of caption words, with finite scores (f32
encoders: cuDNN and the CPU sum the convs in other orders).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from depth_image_captioning_pub_torch.models.decoder import AttentionDecoder
from depth_image_captioning_pub_torch.ops.attention import project_features
from depth_image_captioning_pub_torch.models.nic import NICDecoder
from depth_image_captioning_pub_torch.ops.kernels import (
    beam_seq, decode_seq, decode_step, group_norm, nic_seq, vit_attention)

pytestmark = pytest.mark.cuda

SHAPES = {"small": (10, 49, 64, 32, 24, 32, 40),      # B, K, D, A, E, H, V
          "main": (8, 196, 2048, 128, 128, 128, 9956),
          "concat": (8, 196, 2080, 128, 128, 128, 9956)}  # mdepth-* D
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


def _step_inputs(dec, f, seed=1):
    bsz, e, h = f.shape[0], dec.dim_embedding, dec.att_w_dec.shape[0]
    rng = np.random.default_rng(seed)
    emb, hh, cc = (torch.from_numpy(rng.standard_normal((bsz, n)).astype(
        np.float32)).to(f.device) for n in (e, h, h))
    with torch.inference_mode():
        proj = project_features(dec.att_params(), f,
                                compute_dtype=torch.float32)
    return f, proj, emb, hh, cc, dec.seq_weights().step


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("bsz", [1, 3, 16, 64, 130])
def test_step_kernel_matches_plain(cuda, shape, storage, bsz):
    """K1 from one row to more rows than SMs, at D=2048 and D=2080, f32
    and bf16 features: h', c', alpha within 1e-4 of the plain version; a
    second call bit-identical; the launch's plan recorded."""
    dec, feats = _decoder((bsz,) + SHAPES[shape][1:], cuda, seed=bsz)
    args = _step_inputs(dec, feats.to(getattr(torch, storage)))
    with torch.inference_mode():
        before = decode_step.LAUNCHES
        got = decode_step.fused_decode_core(*args)
        torch.cuda.synchronize()
        assert decode_step.LAUNCHES == before + 1
        plan = decode_step.LAST_PLAN
        again = decode_step.fused_decode_core(*args)
        want = decode_step.fused_decode_core_plain(*args)
    index = torch.cuda.current_device()
    fits = decode_step._max_ctas(index, int(storage == "bfloat16"),
                                 plan.smem_bytes)
    assert plan.ctas == min(decode_step._sm_count(index), fits)
    for g, a, x in zip(got, again, want):
        assert g.shape == x.shape and g.dtype == torch.float32
        assert torch.equal(g, a)
        torch.testing.assert_close(g, x, atol=1e-4, rtol=0)


def test_step_kernel_ignores_tf32_flags(cuda):
    """The kernel computes in f32 whatever the TF32 flags say, and the
    sampling loop pins them off for its products: with both flags on, the
    step and the sampled tokens equal those with both off."""
    dec, feats = _decoder((16,) + SHAPES["main"][1:], cuda, seed=12)
    f = feats.to(torch.bfloat16)
    args = _step_inputs(dec, f)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    out = {}
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            torch.backends.cudnn.allow_tf32 = flag
            with torch.inference_mode():
                step = decode_step.fused_decode_core(*args)
                toks, _ = dec.stochastic_sample(
                    f, 2, torch.Generator(device=cuda).manual_seed(0),
                    max_length=30, top_p=0.9)
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == (flag, flag)
            out[flag] = (step, toks)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    for a, b in zip(out[True][0], out[False][0]):
        assert torch.equal(a, b)
    assert torch.equal(out[True][1], out[False][1])


def test_step_kernel_rejects_outside_envelope(cuda):
    """Widths the phases cannot read are padded, not refused (see
    ``test_step_kernel_odd_widths``); a CTA's shared memory still bounds
    D."""
    dec, feats = _decoder((2, 9, 60, 8, 8, 8, 16), cuda)
    args = _step_inputs(dec, feats)
    with torch.inference_mode():
        got = decode_step.fused_decode_core(*args)
        want = decode_step.fused_decode_core_plain(*args)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, atol=1e-4, rtol=0)
    dec, feats = _decoder((1, 4, 16384, 8, 8, 8, 16), cuda)
    with pytest.raises(ValueError, match="shared memory"):
        decode_step.fused_decode_core(*_step_inputs(dec, feats))


@pytest.mark.parametrize("shape", ["main", "concat"])
@pytest.mark.parametrize("bsz", [1, 16, 64])
def test_sampled_tokens_match_plain_step(cuda, shape, bsz, monkeypatch):
    """stochastic_sample through K1 against the same loop through the
    plain step, on the same noise: >= 99% of tokens agree (a draw can flip
    on a near-tie of filt + noise, and the flip cascades along its row);
    30 launches of K1, none of K2."""
    from depth_image_captioning_pub_torch.models import decoder as dec_mod
    dec, feats = _decoder((bsz,) + SHAPES[shape][1:], cuda, seed=20 + bsz)
    f = feats.to(torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(bsz)
    noise = [torch.empty((bsz, dec.vocab_size), device=cuda).exponential_(
        generator=gen).log_().neg_() for _ in range(30)]
    kw = dict(max_length=30, temperature=1.0, top_p=0.9,
              noise=lambda t: noise[t])
    with torch.inference_mode():
        before = (decode_step.LAUNCHES, decode_seq.LAUNCHES)
        got, alphas = dec.stochastic_sample(f, 2, None, **kw)
        assert (decode_step.LAUNCHES, decode_seq.LAUNCHES) == (
            before[0] + 30, before[1])
        monkeypatch.setattr(dec_mod, "fused_decode_core",
                            decode_step.fused_decode_core_plain)
        want, want_alphas = dec.stochastic_sample(f, 2, None, **kw)
    assert got.shape == (bsz, 30) and alphas.shape == (bsz, 30, f.shape[1])
    assert (got == want).float().mean().item() >= 0.99
    assert torch.allclose(alphas.sum(-1), torch.ones_like(alphas[..., 0]),
                          atol=1e-5)


@pytest.mark.parametrize("bsz", [1, 16, 64])
def test_greedy_kernel_equals_step_loop_top1(cuda, bsz):
    """K2 and the K1 loop run the same attention phase: greedy tokens
    without <end> equal the top_k=1 draws of the sampling loop on >= 99%
    of positions."""
    dec, feats = _decoder((bsz,) + SHAPES["main"][1:], cuda, seed=30 + bsz)
    f = feats.to(torch.bfloat16)
    with torch.inference_mode():
        greedy = dec.greedy_sample(f, 2, max_length=30)
        top1, _ = dec.stochastic_sample(
            f, 2, torch.Generator(device=cuda).manual_seed(0),
            max_length=30, top_k=1)
    assert (greedy == top1).float().mean().item() >= 0.99


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


def _greedy_inputs(dec, f):
    with torch.inference_mode():
        proj = project_features(dec.att_params(), f,
                                compute_dtype=torch.float32)
        state = dec.init_state(f)
    return f, proj, state.h, state.c, dec.seq_weights()


def _greedy(fn, inputs, max_length=30, end_id=END):
    with torch.inference_mode():
        return fn(*inputs, max_length=max_length, start_id=2, end_id=end_id)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("bsz", [1, 10, 64, 130])
def test_greedy_kernel_batch_sizes(cuda, shape, bsz):
    """The persistent kernel from one row to more rows than SMs."""
    dec, feats = _decoder((bsz,) + SHAPES[shape][1:], cuda, seed=bsz)
    inputs = _greedy_inputs(dec, feats.to(torch.bfloat16))
    before = decode_seq.LAUNCHES
    got = _greedy(decode_seq.fused_greedy_decode, inputs)
    torch.cuda.synchronize()
    assert decode_seq.LAUNCHES == before + 1
    want = _greedy(decode_seq.fused_greedy_decode_plain, inputs)
    assert got.shape == want.shape == (bsz, 30)
    assert (got == want).float().mean().item() >= 0.99


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("max_length", [1, 7, 30])
def test_greedy_kernel_without_end(cuda, shape, max_length):
    """end_id < 0 runs every step; any max_length."""
    dec, feats = _decoder(SHAPES[shape], cuda, seed=max_length)
    inputs = _greedy_inputs(dec, feats)
    got = _greedy(decode_seq.fused_greedy_decode, inputs, max_length, -1)
    want = _greedy(decode_seq.fused_greedy_decode_plain, inputs, max_length,
                   -1)
    assert got.shape == want.shape == (feats.shape[0], max_length)
    assert (got == want).float().mean().item() >= 0.99


@pytest.mark.parametrize("shape,scale,bias", [("small", 20.0, 0.3),
                                              ("main", 10.0, 0.0)])
def test_greedy_kernel_rows_end_at_different_steps(cuda, shape, scale, bias):
    """With <end>'s head column scaled, rows end at different steps (and
    at main shape all end early, so the loop exits): every slot after a
    row's first <end> is <end>."""
    dec, feats = _decoder((64,) + SHAPES[shape][1:], cuda, seed=5)
    with torch.inference_mode():
        dec.out_w[:, END] *= scale
        dec.out_b[END] += bias
    inputs = _greedy_inputs(dec, feats)
    got = _greedy(decode_seq.fused_greedy_decode, inputs).cpu().numpy()
    want = _greedy(decode_seq.fused_greedy_decode_plain, inputs)
    assert (got == want.cpu().numpy()).mean() >= 0.99
    ended = got == END
    first = np.where(ended.any(1), ended.argmax(1), got.shape[1])
    assert len(set(first.tolist())) >= 2, first
    for row, t in zip(got, first):
        assert np.all(row[t:] == END)


def test_greedy_kernel_repeats_bit_identical(cuda):
    """Fixed sum orders and no float atomics: two calls, the same tokens."""
    dec, feats = _decoder((64,) + SHAPES["main"][1:], cuda, seed=6)
    inputs = _greedy_inputs(dec, feats.to(torch.bfloat16))
    first = _greedy(decode_seq.fused_greedy_decode, inputs, end_id=-1)
    again = _greedy(decode_seq.fused_greedy_decode, inputs, end_id=-1)
    assert torch.equal(first, again)


def test_greedy_kernel_rejects_outside_envelope(cuda):
    """D=60 is padded, not refused; shared memory still bounds D."""
    dec, feats = _decoder((2, 9, 60, 8, 8, 8, 16), cuda)
    inputs = _greedy_inputs(dec, feats)
    agree = (_greedy(decode_seq.fused_greedy_decode, inputs)
             == _greedy(decode_seq.fused_greedy_decode_plain, inputs))
    assert agree.float().mean().item() >= 0.99
    # D=16384: one hidden unit's gate weights alone need 264 KB
    dec, feats = _decoder((1, 4, 16384, 8, 8, 8, 16), cuda)
    with pytest.raises(ValueError, match="shared memory"):
        _greedy(decode_seq.fused_greedy_decode, _greedy_inputs(dec, feats))


def test_greedy_sample_ignores_tf32_flags(cuda):
    """greedy_sample pins TF32 off for its f32 products: with both flags
    turned on first, the tokens equal those of a call with them off."""
    dec, feats = _decoder((16,) + SHAPES["main"][1:], cuda, seed=7)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with torch.inference_mode():
            got = dec.greedy_sample(feats, 2, max_length=30, end_id=END)
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (True, True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with torch.inference_mode():
            want = dec.greedy_sample(feats, 2, max_length=30, end_id=END)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    assert torch.equal(got, want)


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


F32_VIT_SHAPES = [(1, 1), (17, 17), (197, 197), (577, 577), (584, 577)]
BF16_VIT_SHAPES = [(1, 1), (17, 17), (63, 63), (64, 64), (65, 65),
                   (197, 197), (577, 577), (584, 577), (2048, 2048)]
VIT_CASES = ([("float32", 64, n, nv) for n, nv in F32_VIT_SHAPES]
             + [("bfloat16", d, n, nv) for d in (32, 64, 128)
                for n, nv in BF16_VIT_SHAPES])


def _qkv(seed, shape, dev, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dev, getattr(torch, dtype)) for _ in range(3)]


def _vit_atol(v):
    """1e-5 in f32; one bf16 ulp of max|v| in bf16."""
    return 1e-5 if v.dtype == torch.float32 else 2 ** -7 * v.abs().max().item()


@pytest.mark.parametrize("dtype,d,n,n_valid", VIT_CASES)
def test_vit_attention_matches_plain(cuda, dtype, d, n, n_valid):
    q, k, v = _qkv(n, (6, n, d), cuda, dtype)
    before = vit_attention.LAUNCHES
    got = vit_attention.fused_attention(q, k, v, scale=d ** -0.5,
                                        n_valid=n_valid)
    torch.cuda.synchronize()
    assert vit_attention.LAUNCHES == before + 1
    want = vit_attention.fused_attention_plain(q, k, v, scale=d ** -0.5,
                                               n_valid=n_valid)
    assert got.dtype == v.dtype and got.shape == v.shape
    torch.testing.assert_close(got.float(), want.float(), atol=_vit_atol(v),
                               rtol=0)


def test_vit_attention_at_dpt_224(cuda):
    """The DPT at 224x224 (``--dpt-size 224``): 197 tokens, a 16-image
    chunk's Z = 16 * 12 heads of 64, bf16; and the DPT's blocks launch the
    kernel at that shape."""
    from depth_image_captioning_pub_torch.models.dpt import (
        TINY_DPT, DPTDepthEstimator)
    q, k, v = _qkv(197, (16 * 12, 197, 64), cuda, "bfloat16")
    got = vit_attention.fused_attention(q, k, v, scale=0.125, n_valid=197)
    want = vit_attention.fused_attention_plain(q, k, v, scale=0.125,
                                               n_valid=197)
    torch.testing.assert_close(got.float(), want.float(), atol=_vit_atol(v),
                               rtol=0)
    # the tests' DPT with heads of 64 (K5 takes d = 32, 64, 128)
    est = DPTDepthEstimator(image_size=224, device=cuda,
                            **dict(TINY_DPT, vit_dim=128, vit_heads=2))
    est.init(torch.Generator().manual_seed(0))
    before = vit_attention.LAUNCHES
    images = torch.randint(0, 256, (2, 224, 224, 3), dtype=torch.uint8,
                           device=cuda)
    depth = est.depth_fn()(images)
    torch.cuda.synchronize()
    assert vit_attention.LAUNCHES == before + TINY_DPT["vit_blocks"]
    assert depth.shape == (2, 224, 224, 1)
    assert bool(torch.isfinite(depth).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,n_valid", [(577, 577), (578, 577)])
def test_vit_attention_at_tp_and_sp_shapes(cuda, dtype, n, n_valid):
    """K5 as the parallel DPT launches it (``parallel/tp``): half of
    ViT-B's 12 heads over two model ranks, Z = 4 images x 6 heads of 64,
    at N = 577, and at the 577 tokens padded to 578 that token sharding
    gathers over two ranks (n_valid 577)."""
    q, k, v = _qkv(n + 1, (4 * 6, n, 64), cuda, dtype)
    before = vit_attention.LAUNCHES
    got = vit_attention.fused_attention(q, k, v, scale=0.125,
                                        n_valid=n_valid)
    torch.cuda.synchronize()
    assert vit_attention.LAUNCHES == before + 1
    want = vit_attention.fused_attention_plain(q, k, v, scale=0.125,
                                               n_valid=n_valid)
    torch.testing.assert_close(got.float(), want.float(), atol=_vit_atol(v),
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_attention_masks_padded_keys(cuda, dtype):
    """Keys >= n_valid get no weight: garbage there changes nothing (in
    bf16 the rows are never read, so NaN cannot reach the mma)."""
    q, k, v = _qkv(5, (4, 40, 32), cuda, dtype)
    out = vit_attention.fused_attention(q, k, v, scale=0.2, n_valid=33)
    k[:, 33:] = 1e4
    v[:, 33:] = float("nan")
    again = vit_attention.fused_attention(q, k, v, scale=0.2, n_valid=33)
    assert torch.equal(out, again)


def test_vit_attention_rejects_outside_envelope(cuda):
    q = torch.zeros(2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        vit_attention.fused_attention(q, q, q, scale=1.0, n_valid=8)
    # f32 keeps a tile's score rows in shared memory; bf16 keeps none
    q, k, v = _qkv(4096, (1, 4096, 64), cuda, "float32")
    with pytest.raises(ValueError, match="shared memory"):
        vit_attention.fused_attention(q, k, v, scale=1.0, n_valid=4096)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got = vit_attention.fused_attention(q, k, v, scale=0.125, n_valid=4096)
    want = vit_attention.fused_attention_plain(q, k, v, scale=0.125,
                                               n_valid=4096)
    torch.testing.assert_close(got.float(), want.float(), atol=_vit_atol(v),
                               rtol=0)
    q = torch.zeros(2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        vit_attention.fused_attention(q.transpose(0, 1).contiguous()
                                      .transpose(0, 1), q, q, scale=1.0,
                                      n_valid=8)
    q = torch.zeros(2 * 8 * 64 + 4, device=cuda, dtype=torch.bfloat16)
    q = q[4:].view(2, 8, 64)       # contiguous, 8 bytes off a boundary
    with pytest.raises(ValueError, match="16-byte"):
        vit_attention.fused_attention(q, q, q, scale=1.0, n_valid=8)


# ---- NHWC GroupNorm (K6) ---------------------------------------------------

# every distinct (H, W, C) of a GroupNorm in the DPT's ResNetV2 backbone at
# 384x384 and at 224x224 (``--dpt-size 224``): the stem's, then stages 0-2
GN_SHAPES = [(s // d, s // d, c) for s in (384, 224)
             for d, c in ((2, 64), (4, 64), (4, 128), (4, 256), (8, 128),
                          (8, 256), (8, 512), (16, 256), (16, 1024))]
GN_EPILOGUES = ("none", "relu", "residual")


def _gn_inputs(seed, shape, dev, dtype):
    """x ~ N(0.5, 2^2) (a group mean away from 0), weight ~ U(0.5, 1.5),
    bias ~ N(0, 0.1), a residual ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    c = shape[-1]

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
    return (t(0.5 + 2.0 * rng.standard_normal(shape)),
            t(rng.uniform(0.5, 1.5, c)), t(0.1 * rng.standard_normal(c)),
            t(rng.standard_normal(shape)))


def _gn_library(x, w, b, relu, residual):
    """nn.GroupNorm's function on the NCHW-contiguous tensor, then the
    bottleneck's ``relu(y + shortcut)`` or the ReLU, back to NHWC."""
    y = F.group_norm(x.permute(0, 3, 1, 2).contiguous(), 32, w, b, 1e-5)
    y = y.permute(0, 2, 3, 1)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def _gn_library_slack(x, w):
    """How far nn.GroupNorm's bf16 route lies from f32 statistics: it
    returns its mean and rstd in x's dtype (``native_group_norm``) and
    applies the rounded ones, so a = rstd * w and the mean each carry a
    relative error of up to 2^-9, and y = (x - mean) a + bias moves by up to
    2^-9 |a| (|x - mean| + |mean|); 2^-8 of that leaves room for the
    products' own rounding. 0 in f32, where the statistics stay f32."""
    if x.dtype != torch.bfloat16:
        return 0.0
    bsz, h, wd, c = x.shape
    xf = x.float().reshape(bsz, h * wd, 32, c // 32)
    var, mean = torch.var_mean(xf, dim=(1, 3), correction=0, keepdim=True)
    a = torch.rsqrt(var + 1e-5) * w.float().reshape(1, 1, 32, c // 32)
    slack = 2 ** -8 * a.abs() * ((xf - mean).abs() + mean.abs())
    return slack.reshape(x.shape)


def _gn_check(got, want, normed=None, slack=0.0):
    """|got - want| <= tol elementwise. The kernel and ``want`` sum the f32
    statistics in other orders: in f32 that is within 1e-5 max|want|; in
    bf16 a value whose f32 form lies within that difference of a rounding
    boundary rounds the other way, by one bf16 ulp (<= 2^-7 of its size),
    and with a residual the normalised value's flip (one ulp of
    ``normed``, the value before the add) carries into the rounded sum:
    tol = 2^-7 (|want| + |normed|) + 1e-5 max|want|. ``slack``: what the
    reference's own rounding adds (``_gn_library_slack``)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    tol = 1e-5 * want.abs().max().item() + slack
    if bf16:
        tol = tol + 2 ** -7 * want.abs()
        if normed is not None:
            tol = tol + 2 ** -7 * normed.float().abs()
    err = (got - want).abs()
    bad = err > tol
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.numel()} values off; the worst, "
        f"{err[bad].max().item():.3g}, got {got[bad][0].item():.6g} want "
        f"{want[bad][0].item():.6g} (first off)")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("bsz", [1, 64])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_group_norm_matches_plain_and_library(cuda, shape, bsz, dtype):
    """K6 at each backbone shape, without an epilogue, with the ReLU and
    with the residual add + ReLU, against its plain version and against
    nn.GroupNorm on the NCHW copy followed by the same ReLU or add; two
    launches a call."""
    x, w, b, r = _gn_inputs(GN_SHAPES.index(shape) + bsz,
                            (bsz,) + shape, cuda, getattr(torch, dtype))
    with torch.inference_mode():
        normed = group_norm.group_norm_nhwc_plain(x, w, b)
        slack = _gn_library_slack(x, w)
        for epilogue in GN_EPILOGUES:
            relu = epilogue != "none"
            res = r if epilogue == "residual" else None
            before = group_norm.LAUNCHES
            got = group_norm.group_norm_nhwc(x, w, b, relu=relu,
                                             residual=res)
            torch.cuda.synchronize()
            assert group_norm.LAUNCHES == before + 2
            assert got.is_contiguous()
            pre = normed if res is not None else None
            plain = group_norm.group_norm_nhwc_plain(x, w, b, relu=relu,
                                                     residual=res)
            _gn_check(got, plain, pre)
            _gn_check(got, _gn_library(x, w, b, relu, res), pre, slack)


def test_group_norm_repeats_bit_identical(cuda):
    x, w, b, r = _gn_inputs(7, (64, 96, 96, 256), cuda, torch.bfloat16)
    with torch.inference_mode():
        one = group_norm.group_norm_nhwc(x, w, b, relu=True, residual=r)
        two = group_norm.group_norm_nhwc(x, w, b, relu=True, residual=r)
    assert torch.equal(one, two)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(96, 96, 256), (48, 48, 512),
                                   (24, 24, 256)])
def test_group_norm_is_batch_invariant(cuda, shape, dtype):
    """An image normalises to the same bits alone, in a batch of 15 or 30
    (a two-rank and a one-rank training batch) or of 64: the tiling, and
    so the order of the statistic sums, depends on H*W and C alone."""
    x, w, b, r = _gn_inputs(8, (64,) + shape, cuda, getattr(torch, dtype))
    with torch.inference_mode():
        full = group_norm.group_norm_nhwc(x, w, b, relu=True, residual=r)
        for lo, hi in ((0, 1), (0, 15), (15, 30), (3, 33), (63, 64)):
            part = group_norm.group_norm_nhwc(
                x[lo:hi].contiguous(), w, b, relu=True,
                residual=r[lo:hi].contiguous())
            assert torch.equal(part, full[lo:hi]), (lo, hi)


def test_group_norm_rejects_outside_envelope(cuda):
    x, w, b, r = _gn_inputs(8, (2, 4, 4, 64), cuda, torch.bfloat16)
    gn = group_norm.group_norm_nhwc
    with torch.inference_mode():
        with pytest.raises(ValueError, match="32 groups"):
            gn(x, w, b, groups=16)
        x2, w2, b2, _ = _gn_inputs(9, (2, 4, 4, 384), cuda, torch.bfloat16)
        with pytest.raises(ValueError, match="16-byte vectors"):
            gn(x2, w2, b2)          # 12 channels a group straddle vectors
        x2, w2, b2, _ = _gn_inputs(9, (2, 4, 4, 1056), cuda, torch.bfloat16)
        with pytest.raises(ValueError, match="at most 1024"):
            gn(x2, w2, b2)
        with pytest.raises(ValueError, match="contiguous"):
            gn(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), w, b)
        flat = torch.zeros(x.numel() + 1, device=cuda, dtype=x.dtype)
        with pytest.raises(ValueError, match="16-byte"):
            gn(flat[1:].view(x.shape), w, b)
        with pytest.raises(ValueError, match="residual has shape"):
            gn(x, w, b, residual=r[:1])
        with pytest.raises(TypeError, match="weight"):
            gn(x, w.float(), b)
    with pytest.raises(ValueError, match="no backward"):
        gn(x, w.clone().requires_grad_(), b)


def test_dpt_group_norms_launch_the_kernel(cuda):
    """Every GroupNorm of the DPT at full width (stem, 16 bottlenecks x 3,
    3 downsample norms: 52 a forward) launches K6 twice on the card."""
    from depth_image_captioning_pub_torch.models.dpt import (
        DPTDepthEstimator, GroupNormAct)
    est = DPTDepthEstimator(device=cuda)
    est.init(torch.Generator().manual_seed(0))
    norms = [m for m in est.model.modules() if isinstance(m, GroupNormAct)]
    assert len(norms) == 52
    images = torch.randint(0, 256, (2, 224, 224, 3), dtype=torch.uint8,
                           device=cuda)
    before = group_norm.LAUNCHES
    depth = est.depth_fn()(images)
    torch.cuda.synchronize()
    assert group_norm.LAUNCHES == before + 2 * 52
    assert bool(torch.isfinite(depth).all())


# ---- NIC greedy decode (K3) -------------------------------------------------

NIC_SHAPES = {"B1": (1, 300, 128, 2, 9956),      # B, E, H, layers, V
              "odd": (7, 37, 32, 2, 41),         # odd E and V
              "one_layer": (5, 24, 16, 1, 40),
              "main": (64, 300, 128, 2, 9956),
              "B16": (16, 300, 128, 2, 9956),
              "B130": (130, 300, 128, 2, 9956),  # more rows than CTAs
              "four_layers": (16, 300, 128, 4, 9956),
              "odd_h": (9, 30, 30, 3, 77)}       # E and H zero-padded


def _nic(shape, dev, seed=0):
    bsz, e, h, layers, v = shape
    dec = NICDecoder(v, dim_embedding=e, dim_hidden=h, num_layers=layers,
                     device=dev)
    dec.reset_parameters(torch.Generator().manual_seed(seed))
    x0 = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (bsz, e)).astype(np.float32)).to(dev)
    return dec, x0


@pytest.mark.parametrize("shape", sorted(NIC_SHAPES))
def test_nic_kernel_matches_plain(cuda, shape):
    dec, x0 = _nic(NIC_SHAPES[shape], cuda)
    with torch.inference_mode():
        w = dec.seq_weights()
        before = nic_seq.LAUNCHES
        got = nic_seq.fused_nic_greedy_decode(x0, w, max_length=30)
        torch.cuda.synchronize()
        assert nic_seq.LAUNCHES == before + 1
        # one CTA per SM, all co-resident
        plan = nic_seq.LAST_PLAN
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert plan.ctas == min(sms, nic_seq._max_ctas(0, plan.smem_bytes))
        want = nic_seq.fused_nic_greedy_decode_plain(x0, w, max_length=30)
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert (got == want).float().mean().item() >= 0.99
        b_out = w.b_out.clone()
        b_out[0, 3] += 100.0
        w_tok = w._replace(b_out=b_out)
        got = nic_seq.fused_nic_greedy_decode(x0, w_tok, max_length=30)
        want = nic_seq.fused_nic_greedy_decode_plain(x0, w_tok,
                                                     max_length=30)
    assert torch.equal(got, want) and bool((got == 3).all())


def test_nic_kernel_repeats_bit_identical(cuda):
    """Fixed sum orders and no float atomics: two calls, the same tokens."""
    dec, x0 = _nic(NIC_SHAPES["main"], cuda, seed=6)
    with torch.inference_mode():
        w = dec.seq_weights()
        first = nic_seq.fused_nic_greedy_decode(x0, w, max_length=30)
        again = nic_seq.fused_nic_greedy_decode(x0, w, max_length=30)
    assert torch.equal(first, again)


def test_nic_greedy_sample_ignores_tf32_flags(cuda):
    """With both TF32 flags on, NICDecoder.greedy_sample (the kernel) gives
    the tokens of a call with them off, and agrees with the plain version
    run with them off."""
    dec, x0 = _nic(NIC_SHAPES["B16"], cuda, seed=7)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        before = nic_seq.LAUNCHES
        with torch.inference_mode():
            got = dec.greedy_sample(x0, max_length=30)
        assert nic_seq.LAUNCHES == before + 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with torch.inference_mode():
            want = dec.greedy_sample(x0, max_length=30)
            plain = nic_seq.fused_nic_greedy_decode_plain(
                x0, dec.seq_weights(), max_length=30)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    assert torch.equal(got, want)
    assert (got == plain).float().mean().item() >= 0.99


def test_nic_kernel_rejects_bad_input(cuda):
    dec, x0 = _nic(NIC_SHAPES["odd"], cuda)
    w = dec.seq_weights()
    with pytest.raises(ValueError, match="expected"):
        nic_seq.fused_nic_greedy_decode(x0.cpu(), w)
    with pytest.raises(TypeError, match="float32"):
        nic_seq.fused_nic_greedy_decode(x0.half(), w)
    with pytest.raises(ValueError, match="contiguous"):
        nic_seq.fused_nic_greedy_decode(
            x0.t().contiguous().t(), w)


# ---- beam search (K4) ---------------------------------------------------------

BEAM_SHAPES = {"B1": (1,) + SHAPES["main"][1:],
               "odd": (5, 49, 64, 32, 24, 32, 41),       # odd B and V
               "main": (64,) + SHAPES["main"][1:],
               "concat": (16,) + SHAPES["concat"][1:]}   # mdepth-* D=2080


def _beam_inputs(shape, dev, seed, storage=torch.bfloat16):
    dec, feats = _decoder(shape, dev, seed=seed)
    f = feats.to(storage)
    with torch.inference_mode():
        proj = project_features(dec.att_params(), f,
                                compute_dtype=torch.float32)
        state = dec.init_state(f)
    return dec, f, proj, state


def _run_beam(fn, f, proj, state, w, beam, end=END):
    return fn(f, proj, state.h, state.c, w, beam_size=beam, max_length=30,
              start_id=2, end_id=end)


@pytest.mark.parametrize("shape", sorted(BEAM_SHAPES))
@pytest.mark.parametrize("beam", [2, 3, 4, 5])
def test_beam_kernel_matches_plain(cuda, shape, beam):
    dec, f, proj, state = _beam_inputs(BEAM_SHAPES[shape], cuda, seed=beam)
    with torch.inference_mode():
        w = dec.seq_weights()
        before = beam_seq.LAUNCHES
        got = _run_beam(beam_seq.fused_beam_decode, f, proj, state, w, beam)
        torch.cuda.synchronize()
        assert beam_seq.LAUNCHES == before + 1
        want = _run_beam(beam_seq.fused_beam_decode_plain, f, proj, state, w,
                         beam)
    assert got.tokens.dtype == got.parents.dtype == torch.int32
    assert got.tokens.shape == want.tokens.shape
    best_got = beam_seq.select_best(got, END)[0]
    best_want = beam_seq.select_best(want, END)[0]
    assert (best_got == best_want).float().mean().item() >= 0.99
    torch.testing.assert_close(got.scores, want.scores, atol=1e-3, rtol=0)


@pytest.mark.parametrize("beam", [2, 5])
@pytest.mark.parametrize("case", ["forced_end", "all_ties"])
def test_beam_kernel_exact_cases(cuda, beam, case):
    dec, f, proj, state = _beam_inputs(BEAM_SHAPES["odd"], cuda, seed=7)
    with torch.inference_mode():
        if case == "forced_end":
            dec.out_b[END] += 100.0
        else:
            dec.out_w.zero_()
            dec.out_b.zero_()
        w = dec.seq_weights()
        got = _run_beam(beam_seq.fused_beam_decode, f, proj, state, w, beam)
        want = _run_beam(beam_seq.fused_beam_decode_plain, f, proj, state, w,
                         beam)
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.parents, want.parents)
    torch.testing.assert_close(got.scores, want.scores, atol=1e-4, rtol=0)
    if case == "all_ties":
        assert bool((got.tokens < beam).all())


def test_decoder_beam_sample_on_card_matches_cpu(cuda):
    """AttentionDecoder.beam_sample on the card (K4) against the same
    decoder's plain path on the CPU, f32 features."""
    dec, feats = _decoder(SHAPES["small"], cuda, seed=4)
    with torch.inference_mode():
        before = beam_seq.LAUNCHES
        got, got_s = dec.beam_sample(feats, 2, END, beam_size=3,
                                     max_length=9, length_penalty=0.7)
        assert beam_seq.LAUNCHES == before + 1
        want, want_s = dec.cpu().beam_sample(feats.cpu(), 2, END,
                                             beam_size=3, max_length=9,
                                             length_penalty=0.7)
    assert (got.cpu() == want).float().mean().item() >= 0.99
    torch.testing.assert_close(got_s.cpu(), want_s, atol=1e-3, rtol=0)


def test_beam_kernel_rejects_outside_envelope(cuda):
    dec, f, proj, state = _beam_inputs(BEAM_SHAPES["odd"], cuda, seed=1)
    w = dec.seq_weights()
    with pytest.raises(ValueError, match="beam sizes"):
        _run_beam(beam_seq.fused_beam_decode, f, proj, state, w, 9)
    with pytest.raises(ValueError, match="beam sizes"):
        _run_beam(beam_seq.fused_beam_decode, f, proj, state, w, 1)
    with pytest.raises(ValueError, match="expected"):
        _run_beam(beam_seq.fused_beam_decode, f, proj.cpu(), state, w, 3)
    with pytest.raises(TypeError, match="float32"):
        _run_beam(beam_seq.fused_beam_decode, f.half(), proj, state, w, 3)
    # D=16384: one hidden unit's gate weights alone need 264 KB
    dec, f, proj, state = _beam_inputs((1, 4, 16384, 8, 8, 8, 16), cuda, 1)
    with pytest.raises(ValueError, match="shared memory"):
        _run_beam(beam_seq.fused_beam_decode, f, proj, state,
                  dec.seq_weights(), 5)
    # D=60 is padded, not refused
    dec, f, proj, state = _beam_inputs((2, 9, 60, 8, 8, 8, 16), cuda, 1)
    with torch.inference_mode():
        got = _run_beam(beam_seq.fused_beam_decode, f, proj, state,
                        dec.seq_weights(), 3)
        want = _run_beam(beam_seq.fused_beam_decode_plain, f, proj, state,
                         dec.seq_weights(), 3)
    _beam_agrees(got, want)


def _beam_agrees(got, want):
    """Best tokens and records agree on >= 99%, scores within 1e-3."""
    best_got = beam_seq.select_best(got, END)[0]
    best_want = beam_seq.select_best(want, END)[0]
    assert (best_got == best_want).float().mean().item() >= 0.99
    for g, x in ((got.tokens, want.tokens), (got.parents, want.parents)):
        assert (g == x).float().mean().item() >= 0.99
    torch.testing.assert_close(got.scores, want.scores, atol=1e-3, rtol=0)


@pytest.mark.parametrize("bsz", [1, 5, 16, 64, 130])
@pytest.mark.parametrize("beam", [2, 3, 4, 5])
def test_beam_kernel_batch_sizes(cuda, bsz, beam):
    """The persistent kernel from one image to more images than SMs."""
    shape = (bsz,) + SHAPES["main"][1:]
    dec, f, proj, state = _beam_inputs(shape, cuda, seed=bsz + beam)
    with torch.inference_mode():
        w = dec.seq_weights()
        before = beam_seq.LAUNCHES
        got = _run_beam(beam_seq.fused_beam_decode, f, proj, state, w, beam)
        torch.cuda.synchronize()
        assert beam_seq.LAUNCHES == before + 1
        assert beam_seq.LAST_PLAN.rows == bsz * beam
        want = _run_beam(beam_seq.fused_beam_decode_plain, f, proj, state, w,
                         beam)
    assert got.tokens.shape == want.tokens.shape == (bsz, beam, 30)
    _beam_agrees(got, want)


def _steps_per_image(out):
    """The step after which each image's beams had all finished (the
    records' replay), or the length when they never did."""
    tok = out.tokens.cpu().numpy()
    par = out.parents.cpu().numpy().astype(np.int64)
    fin = np.zeros(tok.shape[:2], bool)
    steps = np.full(tok.shape[0], tok.shape[2])
    for t in range(tok.shape[2]):
        fin = np.take_along_axis(fin, par[:, :, t], 1) | (tok[:, :, t] == END)
        steps = np.where(fin.all(1) & (steps == tok.shape[2]), t + 1, steps)
    return steps, tok, par


def test_beam_kernel_images_end_at_different_steps(cuda):
    """With <end>'s head column scaled and its bias raised, images finish
    at different steps and all before the last, so the grid leaves the
    loop early: every record after an image's last step is <end> with an
    identity parent."""
    dec, f, proj, state = _beam_inputs((64,) + SHAPES["main"][1:], cuda,
                                       seed=5)
    with torch.inference_mode():
        dec.out_w[:, END] *= 10.0
        dec.out_b[END] += 0.6
        w = dec.seq_weights()
        got = _run_beam(beam_seq.fused_beam_decode, f, proj, state, w, 3)
        want = _run_beam(beam_seq.fused_beam_decode_plain, f, proj, state, w,
                         3)
    _beam_agrees(got, want)
    steps, tok, par = _steps_per_image(got)
    assert len(set(steps.tolist())) >= 2 and steps.max() < 30, steps
    for b, t in enumerate(steps):
        assert np.all(tok[b, :, t:] == END)
        assert np.all(par[b, :, t:] == np.arange(3)[:, None])


def test_beam_kernel_repeats_bit_identical(cuda):
    """Fixed sum orders and no float atomics: two calls, the same records
    and scores."""
    dec, f, proj, state = _beam_inputs((64,) + SHAPES["main"][1:], cuda,
                                       seed=6)
    with torch.inference_mode():
        w = dec.seq_weights()
        first = _run_beam(beam_seq.fused_beam_decode, f, proj, state, w, 5)
        again = _run_beam(beam_seq.fused_beam_decode, f, proj, state, w, 5)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_beam_sample_ignores_tf32_flags(cuda):
    """beam_sample pins TF32 off for its f32 products: with both flags on
    first, the tokens and scores equal those of a call with them off."""
    dec, feats = _decoder((16,) + SHAPES["main"][1:], cuda, seed=8)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        got = dec.beam_sample(feats, 2, END, beam_size=5, max_length=30)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        want = dec.beam_sample(feats, 2, END, beam_size=5, max_length=30)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_depth_soft_beam_sample_on_card_matches_cpu(cuda):
    """Depth-soft beam search: bf16 RGB and depth annotation vectors added
    in bf16 (add fusion), K4 on the card against the same decoder's plain
    path on the CPU."""
    bsz, k, d, a, e, h, v = (8,) + SHAPES["main"][1:]
    dec = AttentionDecoder(v, dim_attention=a, dim_embedding=e,
                           dim_encoder=d, dim_decoder=h, fusion="add",
                           device=cuda)
    dec.reset_parameters(torch.Generator().manual_seed(9))
    rng = np.random.default_rng(9)
    rgb, depth = (torch.from_numpy(np.abs(rng.standard_normal(
        (bsz, k, d))).astype(np.float32)).to(cuda, torch.bfloat16)
        for _ in range(2))
    before = beam_seq.LAUNCHES
    got, got_s = dec.beam_sample(rgb, 2, END, depth, beam_size=5)
    assert beam_seq.LAUNCHES == before + 1
    want, want_s = dec.cpu().beam_sample(rgb.cpu(), 2, END, depth.cpu(),
                                         beam_size=5)
    assert (got.cpu() == want).float().mean().item() >= 0.99
    torch.testing.assert_close(got_s.cpu(), want_s, atol=1e-3, rtol=0)


class _ImageSet:
    """Seeded uint8 images with five placeholder-word references each."""

    def __init__(self, n, hw, words, seed):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
        self.refs = [[" ".join(rng.choice(words, rng.integers(3, 12)))
                      for _ in range(5)] for _ in range(n)]

    def __len__(self):
        return len(self.images)

    def load_image(self, i):
        return self.images[i]

    def captions(self, i):
        return self.refs[i]


def _scale_kernels(tree, factor):
    """Random torch-default conv inits shrink activations layer by layer;
    scaled kernels keep the features image-dependent."""
    return {k: (_scale_kernels(v, factor) if isinstance(v, dict)
                else v * factor if k == "kernel" else v)
            for k, v in tree.items()}


def test_evaluate_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    from depth_image_captioning_pub_torch import cli
    from depth_image_captioning_pub_torch.config import ConfigEval
    from depth_image_captioning_pub_torch.engine import evaluate as ev
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.utils.checkpoint import (
        save_component)
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        params_to_jax)
    w2i, i2w = cli.placeholder_vocab(SHAPES["main"][-1])
    cfg = ConfigEval()
    cfg.batch_size = 16
    cfg.save_directory_soft = str(tmp_path)
    save_dir, files = cli.eval_tables(cfg, "soft", False, False)

    def captioner(device):
        return build_captioner("base-soft", len(w2i), cfg,
                               encoder_dtype=torch.float32,
                               resnet_layers=(1, 1, 1, 1), device=device)

    src = captioner("cpu")
    for i in (1, 2):
        src.init(torch.Generator().manual_seed(i))
        trainable, frozen, _ = params_to_jax(src)
        save_component(f"{save_dir}/{files[i][0]}",
                       _scale_kernels(frozen["encoder"], 3.0))
        save_component(f"{save_dir}/{files[i][1]}", trainable["decoder"])
    data = _ImageSet(32, 224, [f"w{i}" for i in range(50)], seed=0)

    hypos = {}
    load_textfiles = ev.load_textfiles
    for device in ("cuda", "cpu"):
        rec = hypos.setdefault(device, [])
        monkeypatch.setattr(ev, "load_textfiles", lambda r, h, rec=rec: (
            rec.append(list(h)) or load_textfiles(r, h)))
        cap = captioner(device)
        before = decode_seq.LAUNCHES
        scores = ev.evaluate(
            "base-soft", "coco", cap,
            lambda i: cli.load_eval_components(save_dir, files[i], cap),
            data, w2i, i2w, cfg, num_sets=2, quiet=True)
        # 2 sets x 2 batches of 16 on K2; the CPU runs the plain version
        assert decode_seq.LAUNCHES == before + (4 if device == "cuda" else 0)
        assert all(len(v) == 2 and np.all(np.isfinite(v))
                   for v in scores.values())
    assert len(hypos["cuda"]) == len(hypos["cpu"]) == 2
    assert hypos["cuda"][0] != hypos["cuda"][1]
    for got, want in zip(hypos["cuda"], hypos["cpu"]):
        same = total = 0
        for g, w in zip(got, want):
            g, w = g.split(), w.split()
            same += sum(a == b for a, b in zip(g, w))
            total += max(len(g), len(w))
        assert total and same >= 0.99 * total, (same, total)


# ---- odd widths, wide beams, f32 features at D=2080 (mdepth-*) --------------

# B, K, D, A, E, H, V: every width padded for the phases' 16-byte reads
ODD = (6, 49, 2044, 50, 100, 100, 9956)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_step_kernel_odd_widths(cuda, storage):
    """K1 at D=2044, A=50, E=H=100: zero-padded for the launch, h' and c'
    sliced back, within 1e-4 of the plain version on the unpadded
    inputs."""
    dec, feats = _decoder(ODD, cuda, seed=21)
    args = _step_inputs(dec, feats.to(getattr(torch, storage)))
    with torch.inference_mode():
        got = decode_step.fused_decode_core(*args)
        want = decode_step.fused_decode_core_plain(*args)
    for g, x in zip(got, want):
        assert g.shape == x.shape and g.is_contiguous()
        torch.testing.assert_close(g, x, atol=1e-4, rtol=0)


@pytest.mark.parametrize("end_bias", [0.0, 100.0])
def test_greedy_kernel_odd_widths(cuda, end_bias):
    dec, feats = _decoder(ODD, cuda, seed=22)
    with torch.inference_mode():
        dec.out_b[END] += end_bias
    inputs = _greedy_inputs(dec, feats.to(torch.bfloat16))
    got = _greedy(decode_seq.fused_greedy_decode, inputs)
    want = _greedy(decode_seq.fused_greedy_decode_plain, inputs)
    assert (got == want).float().mean().item() >= 0.99
    if end_bias:
        assert torch.equal(got, want) and bool((got == END).all())


@pytest.mark.parametrize("case", ["forced_end", "random"])
def test_beam_kernel_odd_widths(cuda, case):
    dec, f, proj, state = _beam_inputs(ODD, cuda, seed=23)
    with torch.inference_mode():
        if case == "forced_end":
            dec.out_b[END] += 100.0
        w = dec.seq_weights()
        got = _run_beam(beam_seq.fused_beam_decode, f, proj, state, w, 3)
        want = _run_beam(beam_seq.fused_beam_decode_plain, f, proj, state, w,
                         3)
    if case == "forced_end":
        assert torch.equal(got.tokens, want.tokens)
        assert torch.equal(got.parents, want.parents)
        torch.testing.assert_close(got.scores, want.scores, atol=1e-4,
                                   rtol=0)
    else:
        _beam_agrees(got, want)


@pytest.mark.parametrize("bsz", [16, 64])
@pytest.mark.parametrize("beam", [6, 7, 8])
def test_beam_kernel_wide_beams(cuda, beam, bsz):
    """K4's W = 6..8 instances at the main shape. The records' agreement
    is a share of B x W x 30 records, where one near-tie flip cascades
    along its beam: at B=1 and W=8 one flip is 240ths of the records (1.7%
    in one run), so the batches are the path's 16 and 64."""
    dec, f, proj, state = _beam_inputs((bsz,) + SHAPES["main"][1:], cuda,
                                       seed=beam)
    with torch.inference_mode():
        w = dec.seq_weights()
        got = _run_beam(beam_seq.fused_beam_decode, f, proj, state, w, beam)
        plan = beam_seq.LAST_PLAN
        want = _run_beam(beam_seq.fused_beam_decode_plain, f, proj, state, w,
                         beam)
    assert plan.rows == bsz * beam
    assert got.tokens.shape == (bsz, beam, 30)
    _beam_agrees(got, want)


@pytest.mark.parametrize("bsz", [1, 16, 64])
def test_greedy_kernel_concat_f32(cuda, bsz):
    """K2 on mdepth's f32 features at D=2080."""
    dec, feats = _decoder((bsz,) + SHAPES["concat"][1:], cuda, seed=24)
    inputs = _greedy_inputs(dec, feats)
    assert feats.dtype == torch.float32
    got = _greedy(decode_seq.fused_greedy_decode, inputs)
    want = _greedy(decode_seq.fused_greedy_decode_plain, inputs)
    assert (got == want).float().mean().item() >= 0.99
    with torch.inference_mode():
        dec.out_b[END] += 100.0
    inputs = _greedy_inputs(dec, feats)
    assert torch.equal(_greedy(decode_seq.fused_greedy_decode, inputs),
                       _greedy(decode_seq.fused_greedy_decode_plain, inputs))


@pytest.mark.parametrize("beam", [2, 5, 8])
def test_beam_kernel_concat_f32(cuda, beam):
    """K4 on mdepth's f32 features at D=2080."""
    dec, f, proj, state = _beam_inputs((16,) + SHAPES["concat"][1:], cuda,
                                       seed=25, storage=torch.float32)
    with torch.inference_mode():
        w = dec.seq_weights()
        got = _run_beam(beam_seq.fused_beam_decode, f, proj, state, w, beam)
        want = _run_beam(beam_seq.fused_beam_decode_plain, f, proj, state, w,
                         beam)
    _beam_agrees(got, want)


# ---- the kernels as dcap:: operators (export.py keeps them) -----------------

class _SeenOps:
    """A dispatch mode that records every operator called under it."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        seen = self.seen = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                seen.append(str(func))
                return func(*args, **(kwargs or {}))
        self.mode = Mode()


def _operator_cases(dev):
    """name -> (kernel module, its CUDA implementation, public wrapper call,
    operator arguments) at full width, B=4, bf16 features."""
    dec, feats = _decoder((4,) + SHAPES["main"][1:], dev, seed=31)
    f = feats.to(torch.bfloat16)
    with torch.inference_mode():
        step = _step_inputs(dec, f)
        state = dec.init_state(f)
        w = dec.seq_weights()
    ws = decode_seq.seq_list(w)
    nic, x0 = _nic(NIC_SHAPES["B16"], dev, seed=32)
    nw = nic.seq_weights()
    q, k, v = _qkv(33, (12, 577, 64), dev, "bfloat16")
    x, gw, gb, r = _gn_inputs(34, (4, 96, 96, 256), dev, torch.bfloat16)
    proj = step[1]
    return {
        "decode_step": (decode_step, decode_step._decode_step_cuda,
                        lambda: decode_step.fused_decode_core(*step),
                        (*step[:5], list(step[5]))),
        "greedy_decode": (decode_seq, decode_seq._greedy_cuda,
                          lambda: decode_seq.fused_greedy_decode(
                              f, proj, state.h, state.c, w, max_length=30,
                              start_id=2, end_id=END),
                          (f, proj, state.h, state.c, ws, 30, 2, END)),
        "nic_greedy_decode": (nic_seq, nic_seq._nic_cuda,
                              lambda: nic_seq.fused_nic_greedy_decode(
                                  x0, nw, max_length=30),
                              (x0, [*nw.layer_mats, nw.w_out, nw.b_out,
                                    nw.embed], 30)),
        "beam_decode": (beam_seq, beam_seq._beam_cuda,
                        lambda: beam_seq.fused_beam_decode(
                            f, proj, state.h, state.c, w, beam_size=5,
                            max_length=30, start_id=2, end_id=END),
                        (f, proj, state.h, state.c, ws, 5, 30, 2, END)),
        "vit_attention": (vit_attention, vit_attention._vit_cuda,
                          lambda: vit_attention.fused_attention(
                              q, k, v, scale=0.125, n_valid=577),
                          (q, k, v, 0.125, 577)),
        "group_norm_nhwc": (group_norm, group_norm._gn_cuda,
                            lambda: group_norm.group_norm_nhwc(
                                x, gw, gb, relu=True, residual=r),
                            (x, gw, gb, r, 32, 1e-5, True)),
    }


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", ["decode_step", "greedy_decode",
                                  "nic_greedy_decode", "beam_decode",
                                  "vit_attention", "group_norm_nhwc"])
def test_operator_equals_direct_kernel(cuda, name):
    """The public wrapper on CUDA tensors goes through ``dcap::<name>``,
    whose CUDA implementation launches the kernel (one launch; K6 two),
    and the operator's outputs equal a direct call of that implementation
    bit for bit (the kernels' sums run in a fixed order)."""
    mod, direct, wrapper, args = _operator_cases(cuda)[name]
    per_call = 2 if name == "group_norm_nhwc" else 1
    seen = _SeenOps()
    with torch.inference_mode():
        before = mod.LAUNCHES
        with seen.mode:
            via_wrapper = wrapper()
        assert f"dcap.{name}.default" in seen.seen
        assert mod.LAUNCHES == before + per_call
        via_op = getattr(torch.ops.dcap, name)(*args)
        want = direct(*args)
        assert mod.LAUNCHES == before + 3 * per_call
    for got in (via_op, via_wrapper):
        for a, b in zip(_flat(got), _flat(want)):
            assert a.device.type == "cuda" and torch.equal(a, b)
