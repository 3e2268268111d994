"""Beam search of the attention decoder: the port == the JAX package, on
the CPU.

The beam kernel's plain version against the Pallas kernel in interpret
mode (per-step records), ``AttentionDecoder.beam_sample`` against the JAX
XLA search (``use_pallas=False``) in the cases that decide a search (length
penalty 0 and 0.7, a batch that is no multiple of 8, <end> forced, a zeroed
vocab head that makes every token tie, add fusion), the backtrace and
selection against JAX's, and base-soft beam captioning end to end
(``make_caption_fn(beam_size=3)``, ``cli --beam 3``).

Tolerances: tokens and parents integer-equal (the CPU is deterministic and
the seeds fixed); scores atol 1e-5 (f32 sums in another order).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from depth_image_captioning_pub_tpu.config import ConfigTrain
from depth_image_captioning_pub_tpu.data.tokenizer import SPECIAL
from depth_image_captioning_pub_tpu.engine.evaluate import (
    make_caption_fn as jax_make_caption_fn)
from depth_image_captioning_pub_tpu.models.captioner import (
    build_captioner as jax_build_captioner)
from depth_image_captioning_pub_tpu.models.decoder import (
    AttentionDecoder as JaxAttentionDecoder)
from depth_image_captioning_pub_tpu.ops import decode as jdecode
from depth_image_captioning_pub_tpu.ops.pallas import beam_seq as jbeam_seq
from depth_image_captioning_pub_tpu.ops.pallas.decode_seq import (
    DecodeSeqWeights as JaxDecodeSeqWeights)
from depth_image_captioning_pub_tpu.ops.pallas.decode_step import (
    pack_weights as jax_pack_weights)
from depth_image_captioning_pub_torch import cli
from depth_image_captioning_pub_torch.engine.evaluate import make_caption_fn
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.models.decoder import AttentionDecoder
from depth_image_captioning_pub_torch.ops import decode as tdecode
from depth_image_captioning_pub_torch.ops.attention import project_features
from depth_image_captioning_pub_torch.ops.kernels import beam_seq
from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    params_from_jax, save_npz)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

VOCAB, K, D, DIM = 37, 12, 16, 8
START, END = 1, 2
L = 9


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _jax_decoder(fusion="none", seed=0):
    dec = JaxAttentionDecoder(vocab_size=VOCAB, dim_attention=DIM,
                              dim_embedding=DIM, dim_encoder=D,
                              dim_decoder=DIM, fusion=fusion)
    feats = jnp.zeros((1, K, D))
    dep = feats if fusion != "none" else None
    params = dec.init(jax.random.PRNGKey(seed), feats,
                      jnp.zeros((1, 5), jnp.int32), dep)["params"]
    return dec, _np_tree(params)


def _port_decoder(params, fusion="none"):
    dec = AttentionDecoder(VOCAB, dim_attention=DIM, dim_embedding=DIM,
                           dim_encoder=D, dim_decoder=DIM, fusion=fusion,
                           device="cpu")
    dec.load_state_dict({k: torch.tensor(v) for k, v in params.items()},
                        strict=True)
    return dec


def _features(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, K, D)).astype(
        np.float32)


@pytest.mark.parametrize("beam", [2, 5])
def test_plain_records_match_pallas_kernel(beam):
    """Per-step (token, parent) records and final scores of the plain
    version == the Pallas kernel's (interpret mode), at B=8."""
    _, params = _jax_decoder()
    feats = _features(8, seed=beam)
    tdec = _port_decoder(params)
    with torch.no_grad():
        f = torch.from_numpy(feats)
        proj = project_features(tdec.att_params(), f,
                                compute_dtype=torch.float32)
        state = tdec.init_state(f)
        before = beam_seq.LAUNCHES
        got = beam_seq.fused_beam_decode(
            f, proj, state.h, state.c, tdec.seq_weights(), beam_size=beam,
            max_length=L, start_id=START, end_id=END)
        assert beam_seq.LAUNCHES == before   # the CPU runs the plain version
    p = {k: jnp.asarray(v) for k, v in params.items()}
    sw = jax_pack_weights(p["att_w_dec"], p["att_b_dec"],
                          p["att_w_full"][:, 0], p["att_b_full"][0],
                          p["f_beta_w"], p["f_beta_b"], p["lstm_w_ih"],
                          p["lstm_w_hh"], p["lstm_b_ih"], p["lstm_b_hh"],
                          dim_embedding=DIM)
    jw = JaxDecodeSeqWeights(sw, p["out_w"], p["out_b"][None, :],
                             p["embed"])
    want = jbeam_seq.fused_beam_decode(
        jnp.asarray(feats), jnp.asarray(proj.numpy()),
        jnp.asarray(state.h.numpy()), jnp.asarray(state.c.numpy()), jw,
        beam_size=beam, max_length=L, start_id=START, end_id=END,
        interpret=True)
    assert got.tokens.dtype == got.parents.dtype == torch.int32
    assert tuple(got.tokens.shape) == (8, beam, L)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.parents.numpy(),
                                  np.asarray(want.parents))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-5)
    assert (np.asarray(want.parents) != 0).any()   # beams did reorder


def _compare_beam_sample(params, feats, dep=None, fusion="none", end=END,
                         **kw):
    jdec = JaxAttentionDecoder(vocab_size=VOCAB, dim_attention=DIM,
                               dim_embedding=DIM, dim_encoder=D,
                               dim_decoder=DIM, fusion=fusion)
    want_tok, want_score = jdec.apply(
        {"params": params}, jnp.asarray(feats), START, end,
        None if dep is None else jnp.asarray(dep), max_length=L,
        use_pallas=False, method=JaxAttentionDecoder.beam_sample, **kw)
    got_tok, got_score = _port_decoder(params, fusion).beam_sample(
        torch.from_numpy(feats), START, end,
        None if dep is None else torch.from_numpy(dep), max_length=L, **kw)
    want_tok = np.asarray(want_tok)
    assert got_tok.dtype == torch.int32
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)
    np.testing.assert_allclose(got_score.numpy(), np.asarray(want_score),
                               rtol=0, atol=1e-5)
    return want_tok


@pytest.mark.parametrize("length_penalty", [0.0, 0.7])
@pytest.mark.parametrize("beam", [3, 5])
def test_beam_sample_matches_jax(beam, length_penalty):
    """B=5 (no multiple of 8); <end> raised a little, so that some images'
    best beam ends and others' never does."""
    _, params = _jax_decoder()
    params["out_b"] = params["out_b"].copy()
    params["out_b"][END] += 0.02
    toks = _compare_beam_sample(params, _features(5, seed=1),
                                beam_size=beam,
                                length_penalty=length_penalty)
    assert len({tuple(r) for r in toks}) > 1
    assert (toks == END).any() and not (toks == END).any(axis=1).all()


def test_beam_sample_forced_end():
    _, params = _jax_decoder()
    params["out_b"] = params["out_b"].copy()
    params["out_b"][END] += 50.0
    toks = _compare_beam_sample(params, _features(5, seed=2), beam_size=4)
    assert (toks == END).all()


def test_beam_sample_all_ties():
    """A zeroed vocab head gives every token the same log-probability: the
    search is decided by the tie order alone (lower flat index first). With
    <end> the last token, no beam ends, and with END among the first W
    tokens, the beam that took it at step 0 wins."""
    _, params = _jax_decoder()
    params["out_w"] = np.zeros_like(params["out_w"])
    params["out_b"] = np.zeros_like(params["out_b"])
    toks = _compare_beam_sample(params, _features(5, seed=3), beam_size=4,
                                end=VOCAB - 1, length_penalty=0.7)
    assert (toks == 0).all()   # the lowest token of beam 0, every step
    toks = _compare_beam_sample(params, _features(5, seed=3), beam_size=4)
    assert (toks == END).all()


def test_beam_sample_add_fusion():
    _, params = _jax_decoder(fusion="add", seed=5)
    rng = np.random.default_rng(5)
    dep = rng.standard_normal((5, K, D)).astype(np.float32)
    _compare_beam_sample(params, _features(5, seed=4), dep, fusion="add",
                         beam_size=3)


def test_reconstruct_history_and_select_best_match_jax():
    rng = np.random.default_rng(6)
    bsz, beam = 4, 3
    tokens = rng.integers(0, 6, (bsz, beam, L)).astype(np.int32)
    parents = rng.integers(0, beam, (bsz, beam, L)).astype(np.int32)
    scores = -rng.random((bsz, beam)).astype(np.float32) * 5
    jout = jbeam_seq.BeamSeqOutputs(*map(jnp.asarray,
                                         (tokens, parents, scores)))
    tout = beam_seq.BeamSeqOutputs(*map(torch.from_numpy,
                                        (tokens, parents, scores)))
    np.testing.assert_array_equal(
        beam_seq.reconstruct_history(tout).numpy(),
        np.asarray(jbeam_seq.reconstruct_history(jout)))
    for lp in (0.0, 0.7):
        want_tok, want_score = jbeam_seq.select_best(jout, 5, lp)
        got_tok, got_score = beam_seq.select_best(tout, 5, lp)
        np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
        np.testing.assert_allclose(got_score.numpy(),
                                   np.asarray(want_score), rtol=0, atol=1e-6)


def test_select_best_unended_beam_has_length_one():
    """As the JAX package: a beam that never emits <end> is measured as
    length 1 by the length penalty (argmax of an all-False row is 0)."""
    history = torch.tensor([[[3, 3, 3, 3], [3, 2, 2, 2]]], dtype=torch.int32)
    scores = torch.tensor([[-2.0, -3.0]])
    _, got = tdecode.select_best(scores, history, end_id=2,
                                 length_penalty=1.0)
    _, want = jdecode._select_best(jnp.asarray(scores.numpy()),
                                   jnp.asarray(history.numpy()), 2, 1.0, 4)
    assert float(got[0]) == float(np.asarray(want)[0]) == -1.5


def test_top_w_takes_lax_top_k_order():
    total = torch.tensor([[[0.0, 1.0, 1.0], [1.0, 0.5, 1.0]]])
    want = jax.lax.top_k(jnp.asarray(total.numpy().reshape(1, -1)), 4)
    vals, parent, token = tdecode.top_w(total, 4)
    np.testing.assert_array_equal((parent * 3 + token).numpy(),
                                  np.asarray(want[1]))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want[0]))


def test_beam_kernel_wrapper_checks():
    _, params = _jax_decoder()
    tdec = _port_decoder(params)
    f = torch.from_numpy(_features(2))
    proj = project_features(tdec.att_params(), f,
                            compute_dtype=torch.float32)
    state = tdec.init_state(f)
    w = tdec.seq_weights()
    with pytest.raises(ValueError, match="end_id"):
        beam_seq.fused_beam_decode(f, proj, state.h, state.c, w,
                                   beam_size=3, end_id=VOCAB)
    with pytest.raises(ValueError, match="beam_size"):
        beam_seq.fused_beam_decode(f, proj, state.h, state.c, w,
                                   beam_size=0)
    with pytest.raises(TypeError, match="float32"):
        beam_seq.fused_beam_decode(f.double(), proj, state.h, state.c, w,
                                   beam_size=3)
    plan = beam_seq.plan_beam(64, 5, 196, 2048, 128, 128, 128, 9956, 132)
    assert plan.smem_bytes <= beam_seq.SMEM_LIMIT - beam_seq.STATIC_SMEM


# ---- base-soft beam captioning end to end ----------------------------------

LAYERS = (1, 1, 1, 1)
HW = 64
MAX_LEN = 8


def _scale_kernels(tree, factor):
    return {k: (_scale_kernels(v, factor) if isinstance(v, dict)
                else np.asarray(v) * (factor if k == "kernel" else 1.0))
            for k, v in tree.items()}


def test_base_soft_beam_caption_fn_and_cli(tmp_path, capsys):
    words = ["a", "dog", "runs", "in", "park", "cat", "sits", "on", "mat",
             "man", "rides", "bike", "red", "blue"]
    words += [SPECIAL.start, SPECIAL.end, SPECIAL.unk, SPECIAL.null]
    w2i = {w: i for i, w in enumerate(words)}
    i2w = {i: w for w, i in w2i.items()}
    start, end = w2i[SPECIAL.start], w2i[SPECIAL.end]
    jcap = jax_build_captioner("base-soft", len(w2i), ConfigTrain(),
                               encoder_dtype=jnp.float32,
                               resnet_layers=LAYERS)
    params, frozen, stats = jcap.init(jax.random.PRNGKey(0),
                                      image_hw=(HW, HW))
    trainable = _np_tree(params)
    frozen = {"encoder": _scale_kernels(_np_tree(frozen)["encoder"], 3.0)}
    images = np.random.default_rng(3).integers(0, 256, (5, HW, HW, 3),
                                               dtype=np.uint8)
    fn = jax_make_caption_fn(jcap, start, max_length=MAX_LEN, end_id=end,
                             beam_size=3, length_penalty=0.7)
    want = np.asarray(fn(jax.tree_util.tree_map(jnp.asarray, frozen),
                         jax.tree_util.tree_map(jnp.asarray, trainable),
                         stats, jnp.asarray(images), jax.random.PRNGKey(0)))
    assert len({tuple(r) for r in want}) > 1

    cap = build_captioner("base-soft", len(w2i), ConfigTrain(),
                          encoder_dtype=torch.float32, resnet_layers=LAYERS,
                          device="cpu")
    params_from_jax(cap, trainable, frozen)
    got = make_caption_fn(cap, start, max_length=MAX_LEN, end_id=end,
                          beam_size=3, length_penalty=0.7)(
        torch.from_numpy(images))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="end_id"):
        make_caption_fn(cap, start, beam_size=3)

    # the CLI (bf16 encoder, its default) == the pipeline on the same trees
    save_npz(str(tmp_path / "params.npz"), trainable, frozen)
    np.save(tmp_path / "images.npy", images)
    import pickle
    with open(tmp_path / "w2i.pkl", "wb") as f:
        pickle.dump(w2i, f)
    capsys.readouterr()
    cli.main(["caption", "--images", str(tmp_path / "images.npy"),
              "--weights", str(tmp_path / "params.npz"),
              "--vocab", str(tmp_path / "w2i.pkl"), "--device", "cpu",
              "--resnet-layers", "1,1,1,1", "--image-size", str(HW),
              "--max-length", str(MAX_LEN), "--batch-buckets", "4",
              "--beam", "3", "--length-penalty", "0.7"])
    lines = capsys.readouterr().out.splitlines()
    bf16 = build_captioner("base-soft", len(w2i), ConfigTrain(),
                           resnet_layers=LAYERS, device="cpu")
    params_from_jax(bf16, trainable, frozen)
    pipe = CaptionPipeline(bf16, w2i, i2w, max_length=MAX_LEN,
                           batch_buckets=(4,), image_hw=(HW, HW),
                           beam_size=3, length_penalty=0.7)
    assert lines == pipe(list(images)) and len(lines) == 5
