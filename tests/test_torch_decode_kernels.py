"""The decode kernels' plain versions == the JAX Pallas kernels (interpret
mode on the CPU) and the XLA early-exit scan. (The CUDA kernels are held
to these plain versions on the card by tests/test_torch_kernels_cuda.py.)

Tolerances: atol 1e-5 on h', c', alpha for the f32 step (sums in another
order); integer-equal tokens for greedy decode on the CPU."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from depth_image_captioning_pub_tpu.models.decoder import (
    AttentionDecoder as JaxDecoder)
from depth_image_captioning_pub_tpu.ops.attention import (
    AttentionParams, project_features)
from depth_image_captioning_pub_tpu.ops.pallas import decode_step as jstep
from depth_image_captioning_pub_torch.models.decoder import AttentionDecoder
from depth_image_captioning_pub_torch.ops.kernels import (
    decode_seq, decode_step)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

B, K, D, A, H, E = 16, 196, 64, 32, 32, 24   # tests/test_pallas_decode.py


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def step_case():
    rng = np.random.default_rng(0)

    def arr(*shape, scale=0.3):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    raw = dict(att_w_enc=arr(D, A), att_b_enc=arr(A), att_w_dec=arr(H, A),
               att_b_dec=arr(A), att_w_full=arr(A),
               att_b_full=np.float32(0.1), f_beta_w=arr(H, D),
               f_beta_b=arr(D), lstm_w_ih=arr(E + D, 4 * H),
               lstm_w_hh=arr(H, 4 * H), lstm_b_ih=arr(4 * H),
               lstm_b_hh=arr(4 * H))
    feats = arr(B, K, D, scale=1.0)
    emb = arr(B, E, scale=1.0)
    h, c = arr(B, H, scale=1.0), arr(B, H, scale=1.0)
    return raw, feats, emb, h, c


def _pack(mod, raw, lib):
    conv = jnp.asarray if lib == "jax" else _t
    return mod.pack_weights(
        conv(raw["att_w_dec"]), conv(raw["att_b_dec"]),
        conv(raw["att_w_full"]), conv(raw["att_b_full"]),
        conv(raw["f_beta_w"]), conv(raw["f_beta_b"]),
        conv(raw["lstm_w_ih"]), conv(raw["lstm_w_hh"]),
        conv(raw["lstm_b_ih"]), conv(raw["lstm_b_hh"]), dim_embedding=E)


def test_pack_weights_matches_jax(step_case):
    raw = step_case[0]
    jw, tw = _pack(jstep, raw, "jax"), _pack(decode_step, raw, "torch")
    assert jw._fields == tw._fields
    for name, jx, tx in zip(jw._fields, jw, tw):
        assert tuple(tx.shape) == jx.shape, name
        assert tx.is_contiguous(), name
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def test_plain_step_matches_pallas_interpret(step_case):
    raw, feats, emb, h, c = step_case
    jatt = AttentionParams(jnp.asarray(raw["att_w_enc"]),
                           jnp.asarray(raw["att_b_enc"]), None, None, None,
                           None)
    proj = project_features(jatt, jnp.asarray(feats))
    want = jstep.fused_decode_core(jnp.asarray(feats), proj,
                                   jnp.asarray(emb), jnp.asarray(h),
                                   jnp.asarray(c), _pack(jstep, raw, "jax"),
                                   interpret=True)
    before = decode_step.LAUNCHES
    got = decode_step.fused_decode_core(
        _t(feats), _t(proj), _t(emb), _t(h), _t(c),
        _pack(decode_step, raw, "torch"))
    assert decode_step.LAUNCHES == before   # CPU tensors: plain version
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_step_wrapper_rejects_bad_arguments(step_case):
    raw, feats, emb, h, c = step_case
    w = _pack(decode_step, raw, "torch")
    proj = torch.zeros(B, K, A)
    with pytest.raises(TypeError):
        decode_step.fused_decode_core(_t(feats).double(), proj, _t(emb),
                                      _t(h), _t(c), w)
    with pytest.raises(ValueError):
        decode_step.fused_decode_core(_t(feats), proj[:, :5], _t(emb),
                                      _t(h), _t(c), w)
    meta = [torch.empty(x.shape, device="meta")
            for x in (feats, proj, emb, h, c)]
    wmeta = decode_step.DecodeStepWeights(
        *[torch.empty(x.shape, device="meta") for x in w])
    with pytest.raises(ValueError, match="no kernel"):
        decode_step.fused_decode_core(*meta, wmeta)


# ---- whole-sequence greedy decode ------------------------------------------

V, GA, GE, GD, GH, END = 40, 8, 8, 16, 12, 3


def _decoders(n, seed):
    jdec = JaxDecoder(vocab_size=V, dim_attention=GA, dim_embedding=GE,
                      dim_encoder=GD, dim_decoder=GH, dtype=jnp.float32)
    feats = np.random.default_rng(seed).standard_normal(
        (n, 49, GD)).astype(np.float32)
    params = jdec.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                       jnp.zeros((n, 5), jnp.int32), train=False,
                       rng=jax.random.PRNGKey(1))["params"]
    params = {k: np.asarray(v) for k, v in params.items()}
    tdec = AttentionDecoder(V, dim_attention=GA, dim_embedding=GE,
                            dim_encoder=GD, dim_decoder=GH)
    return jdec, tdec, params, feats


def _load(tdec, params):
    tdec.load_state_dict({k: _t(v) for k, v in params.items()}, strict=True)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_plain_greedy_matches_pallas_no_end(storage):
    """B=10 (no multiple of 8), all 9 steps; bf16-stored features are
    upcast exactly on both sides."""
    jdec, tdec, params, feats = _decoders(10, 7)
    _load(tdec, params)
    jf = jnp.asarray(feats).astype(storage)
    want, _ = jdec.apply({"params": params}, jf, 2, max_length=9,
                         use_pallas=True, method=jdec.greedy_sample)
    with torch.inference_mode():
        got = tdec.greedy_sample(_t(feats).to(getattr(torch, storage)), 2,
                                 max_length=9)
    assert got.dtype == torch.int32 and tuple(got.shape) == (10, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bias", [6.0, -6.0])
def test_plain_greedy_early_exit_matches_jax(bias):
    """<end> everywhere from step 0 (+6) vs (almost) never (-6): equal to
    the Pallas kernel (interpret) and to the XLA early-exit scan."""
    jdec, tdec, params, feats = _decoders(10, 11)
    params = dict(params)
    out_b = params["out_b"].copy()
    out_b[END] += bias
    params["out_b"] = out_b
    _load(tdec, params)
    jf = jnp.asarray(feats)
    pallas, _ = jdec.apply({"params": params}, jf, 2, max_length=9,
                           end_id=END, use_pallas=True,
                           method=jdec.greedy_sample)
    xla, _ = jdec.apply({"params": params}, jf, 2, max_length=9,
                        end_id=END, method=jdec.greedy_sample)
    before = decode_seq.LAUNCHES
    with torch.inference_mode():
        got = tdec.greedy_sample(_t(feats), 2, max_length=9, end_id=END)
    assert decode_seq.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    if bias > 0:
        assert np.all(got.numpy() == END)


def test_greedy_wrapper_rejects_bad_ids():
    _, tdec, params, feats = _decoders(2, 3)
    _load(tdec, params)
    with pytest.raises(ValueError, match="vocabulary"):
        tdec.greedy_sample(_t(feats), V, max_length=4)
    with pytest.raises(ValueError, match="max_length"):
        tdec.greedy_sample(_t(feats), 2, max_length=0)
