"""Hard attention: the port == the JAX package, on the CPU.

Hard attention has no TPU kernel: the JAX package runs it on XLA alone
(``gumbel_max_attention``, JAX ``ops/attention.py``; the hard branch of
``_attend``, JAX ``models/decoder.py``), and the port on PyTorch ops. The
two frameworks' generators give different numbers, so every test feeds the
port the JAX package's own Gumbel draws through the decoders'
``att_noise(t, shape)`` hook, drawn with the keys the JAX loops use:

* greedy (``_greedy_sample_early_exit``): ``gumbel(fold_in(rng, t), [B,
  K])``;
* beam search: ``gumbel(fold_in(rng, t), [B, W, K])``;
* sampling: ``k_att, k_tok = split(fold_in(rng, t))``, ``gumbel(k_att, [B,
  K])`` for the region and ``gumbel(k_tok, [B, V])`` for the token.

Tolerances: ``gumbel_max_attention``'s alpha and context exactly equal;
tokens integer-equal (the CPU is deterministic and the seeds fixed); beam
scores within 1e-5 (f32 log-softmax terms summed in another order).
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
from depth_image_captioning_pub_tpu.models import dpt as jdpt
from depth_image_captioning_pub_tpu.models.captioner import (
    build_captioner as jax_build_captioner)
from depth_image_captioning_pub_tpu.models.decoder import (
    AttentionDecoder as JaxAttentionDecoder)
from depth_image_captioning_pub_tpu.ops import attention as jatt
from depth_image_captioning_pub_torch.engine.evaluate import make_caption_fn
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.models.decoder import AttentionDecoder
from depth_image_captioning_pub_torch.models.dpt import (
    TINY_DPT, DPTDepthEstimator)
from depth_image_captioning_pub_torch.ops import attention as tatt
from depth_image_captioning_pub_torch.ops.kernels import (
    beam_seq, decode_seq, decode_step)
from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    dpt_params_from_jax, params_from_jax)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

VOCAB, K, D, DIM = 37, 12, 16, 8
START, END = 1, 2
L = 9


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _gumbel(key, shape):
    return np.array(jax.random.gumbel(key, shape))


def greedy_noise(rng):
    """Replays JAX greedy's and beam search's region draws."""
    return lambda t, shape: torch.from_numpy(
        _gumbel(jax.random.fold_in(rng, t), tuple(shape)))


def sampling_noise(rng, steps, bsz):
    """(att_noise hook, token noise hook) of JAX ``stochastic_sample``."""
    keys = [jax.random.split(jax.random.fold_in(rng, t))
            for t in range(steps)]
    att = [_gumbel(k[0], (bsz, K)) for k in keys]
    tok = [_gumbel(k[1], (bsz, VOCAB)) for k in keys]
    return (lambda t, shape: torch.from_numpy(att[t]),
            lambda t: torch.from_numpy(tok[t]))


# ---- gumbel_max_attention ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_gumbel_max_attention_matches_jax(seed, dtype):
    rng = np.random.default_rng(seed)
    bsz, a, h = 5, 6, 7
    w = [rng.standard_normal(s).astype(np.float32)
         for s in ((D, a), (a,), (h, a), (a,), (a,), ())]
    feats = rng.standard_normal((bsz, K, D)).astype(np.float32)
    hidden = rng.standard_normal((bsz, h)).astype(np.float32)
    noise = _gumbel(jax.random.PRNGKey(seed), (bsz, K))
    jp = jatt.AttentionParams(*map(jnp.asarray, w))
    jf = jnp.asarray(feats).astype(dtype)
    jproj = jatt.project_features(jp, jf, compute_dtype=jnp.float32)
    want_ctx, want_alpha = jatt.gumbel_max_attention(
        jp, jf, jproj, jnp.asarray(hidden), jax.random.PRNGKey(seed),
        compute_dtype=jnp.float32)
    tp = tatt.AttentionParams(*map(torch.from_numpy, w))
    tf = torch.from_numpy(feats).to(getattr(torch, dtype))
    tproj = torch.from_numpy(np.asarray(jproj))
    got_ctx, got_alpha = tatt.gumbel_max_attention(
        tp, tf, tproj, torch.from_numpy(hidden), torch.from_numpy(noise),
        torch.float32)
    assert got_ctx.dtype == got_alpha.dtype == torch.float32
    np.testing.assert_array_equal(got_alpha.numpy(), np.asarray(want_alpha))
    np.testing.assert_array_equal(got_ctx.numpy(), np.asarray(want_ctx))
    assert got_alpha.sum(1).eq(1).all()


def test_gumbel_max_attention_ties_take_the_lowest_region():
    p = tatt.AttentionParams(None, None, torch.zeros(3, 2), torch.zeros(2),
                             torch.zeros(2), torch.zeros(()))
    feats = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    ctx, alpha = tatt.gumbel_max_attention(
        p, feats, torch.zeros(2, 4, 2), torch.zeros(2, 3),
        torch.tensor([[0.0, 1.0, 1.0, 0.0], [2.0, 2.0, 2.0, 2.0]]))
    assert alpha.argmax(1).tolist() == [1, 0]
    assert torch.equal(ctx, feats[[0, 1], [1, 0]])


# ---- the decoder's three paths ----------------------------------------------

def _jax_decoder(fusion, seed):
    dec = JaxAttentionDecoder(vocab_size=VOCAB, dim_attention=DIM,
                              dim_embedding=DIM, dim_encoder=D,
                              dim_decoder=DIM, attention_kind="hard",
                              fusion=fusion)
    feats = jnp.zeros((1, K, D))
    params = dec.init(jax.random.PRNGKey(seed), feats,
                      jnp.zeros((1, 5), jnp.int32),
                      feats if fusion != "none" else None,
                      rng=jax.random.PRNGKey(0))["params"]
    params = _np_tree(params)
    params["out_w"] = params["out_w"] * 20.0     # a peaked distribution
    return dec, params


def _port_decoder(params, fusion):
    dec = AttentionDecoder(VOCAB, DIM, DIM, D, DIM, fusion=fusion,
                           device="cpu", attention_kind="hard")
    dec.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in params.items()}, strict=True)
    return dec


def _features(fusion, bsz, seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((bsz, K, D)).astype(np.float32)
    dep = (rng.standard_normal((bsz, K, D)).astype(np.float32)
           if fusion == "add" else None)
    return feats, dep


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("end", [True, False])
@pytest.mark.parametrize("fusion", ["none", "add"])
def test_hard_greedy_matches_jax(fusion, end):
    """base-hard's (no fusion) and depth-hard's (add) decoders: greedy
    tokens on JAX's own noise, with the <end> exit (rows end at different
    steps) and without it (the plain scan)."""
    jdec, params = _jax_decoder(fusion, seed=12)
    params["out_b"] = params["out_b"].copy()
    params["out_b"][END] += 1.5
    feats, dep = _features(fusion, 7, seed=4)
    key = jax.random.PRNGKey(5)
    end_id = END if end else None
    want, _ = jdec.apply({"params": params}, jnp.asarray(feats), START,
                         _j(dep), max_length=L, rng=key, end_id=end_id,
                         method=JaxAttentionDecoder.greedy_sample)
    want = np.asarray(want)
    launches = (decode_seq.LAUNCHES, decode_step.LAUNCHES)
    got = _port_decoder(params, fusion).greedy_sample(
        torch.from_numpy(feats), START, _t(dep), max_length=L,
        end_id=end_id, att_noise=greedy_noise(key))
    assert (decode_seq.LAUNCHES, decode_step.LAUNCHES) == launches
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len({tuple(r) for r in want}) > 1
    if end:
        ends = [list(r).index(END) for r in want if END in r]
        assert len(set(ends)) > 1 and len(ends) < len(want)


@pytest.mark.parametrize("penalty", [0.0, 0.7])
@pytest.mark.parametrize("fusion", ["none", "add"])
def test_hard_beam_matches_jax(fusion, penalty):
    jdec, params = _jax_decoder(fusion, seed=6)
    params["out_b"] = params["out_b"].copy()
    params["out_b"][END] += 0.5
    feats, dep = _features(fusion, 5, seed=7)
    key = jax.random.PRNGKey(8)
    want, want_s = jdec.apply(
        {"params": params}, jnp.asarray(feats), START, END, _j(dep),
        beam_size=3, max_length=L, length_penalty=penalty, rng=key,
        early_exit=True, method=JaxAttentionDecoder.beam_sample)
    launches = beam_seq.LAUNCHES
    got, got_s = _port_decoder(params, fusion).beam_sample(
        torch.from_numpy(feats), START, END, _t(dep), beam_size=3,
        max_length=L, length_penalty=penalty, att_noise=greedy_noise(key))
    assert beam_seq.LAUNCHES == launches
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-5)
    assert len({tuple(r) for r in np.asarray(want)}) > 1


@pytest.mark.parametrize("settings", [
    dict(temperature=1.0, top_k=0, top_p=1.0),
    dict(temperature=0.7, top_k=5, top_p=0.9),
])
@pytest.mark.parametrize("fusion", ["none", "add"])
def test_hard_sampling_matches_jax(fusion, settings):
    jdec, params = _jax_decoder(fusion, seed=9)
    feats, dep = _features(fusion, 5, seed=10)
    key = jax.random.PRNGKey(11)
    want_tok, want_alpha = jdec.apply(
        {"params": params}, jnp.asarray(feats), START, key, _j(dep),
        max_length=L, method=JaxAttentionDecoder.stochastic_sample,
        **settings)
    att, tok = sampling_noise(key, L, 5)
    launches = decode_step.LAUNCHES
    got_tok, got_alpha = _port_decoder(params, fusion).stochastic_sample(
        torch.from_numpy(feats), START, None, _t(dep), max_length=L,
        noise=tok, att_noise=att, **settings)
    assert decode_step.LAUNCHES == launches
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(got_alpha.numpy(), np.asarray(want_alpha))
    assert len({tuple(r) for r in np.asarray(want_tok)}) > 1


def test_hard_paths_need_a_noise_source():
    _, params = _jax_decoder("none", seed=0)
    dec = _port_decoder(params, "none")
    feats = torch.zeros((2, K, D))
    with pytest.raises(ValueError, match="generator or an att_noise"):
        dec.greedy_sample(feats, START, max_length=3)
    with pytest.raises(ValueError, match="generator or an att_noise"):
        dec.beam_sample(feats, START, END, beam_size=2, max_length=3)
    gen = torch.Generator().manual_seed(0)
    first = dec.greedy_sample(feats + 1, START, max_length=L, generator=gen)
    again = dec.greedy_sample(feats + 1, START, max_length=L,
                              generator=gen.manual_seed(0))
    assert torch.equal(first, again)


# ---- the base-hard and depth-hard slices ------------------------------------

LAYERS = (1, 1, 1, 1)
HW = 64
MAX_LEN = 8
END_BIAS = 0.3     # some captions end before MAX_LEN, not all at once


def _scale_kernels(tree, factor):
    return {k: (_scale_kernels(v, factor) if isinstance(v, dict)
                else np.asarray(v) * (factor if k == "kernel" else 1.0))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def vocab():
    words = ["a", "dog", "runs", "in", "park", "cat", "sits", "on", "mat",
             "man", "rides", "bike", "red", "blue"]
    words += [SPECIAL.start, SPECIAL.end, SPECIAL.unk, SPECIAL.null]
    w2i = {w: i for i, w in enumerate(words)}
    return w2i, {i: w for w, i in w2i.items()}


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(3).integers(0, 256, (6, HW, HW, 3),
                                             dtype=np.uint8)


def _slice(kind, w2i):
    """(JAX captioner, trainable, frozen incl. "dpt" for depth, stats)."""
    jcap = jax_build_captioner(kind, len(w2i), ConfigTrain(),
                               encoder_dtype=jnp.float32,
                               resnet_layers=LAYERS)
    params, frozen, stats = jcap.init(jax.random.PRNGKey(0),
                                      image_hw=(HW, HW))
    trainable = _np_tree(params)
    dec = dict(trainable["decoder"])
    dec["out_b"] = dec["out_b"].copy()
    dec["out_b"][w2i[SPECIAL.end]] += END_BIAS
    # the scaled encoder's features give attention scores ~1e3 apart:
    # scores of order 1 let the region noise move the tokens
    dec["att_w_full"] = dec["att_w_full"] * 1e-3
    trainable["decoder"] = dec
    frozen = {"encoder": _scale_kernels(_np_tree(frozen)["encoder"], 3.0)}
    if kind == "depth-hard":
        trainable["depth_encoder"] = _scale_kernels(
            trainable["depth_encoder"], 6.0)
        dpt = jdpt.DPTDepthModel(**TINY_DPT)
        frozen["dpt"] = _np_tree(jax.jit(dpt.init)(
            jax.random.PRNGKey(1), jnp.zeros((1, HW, HW, 3))))
    return jcap, trainable, frozen, _np_tree(stats)


@pytest.fixture(scope="module")
def slices(vocab):
    return {kind: _slice(kind, vocab[0])
            for kind in ("base-hard", "depth-hard")}


def _jax_depth_fn():
    est = jdpt.DPTDepthEstimator(dtype=jnp.float32, image_size=HW)
    est.model = jdpt.DPTDepthModel(**TINY_DPT)
    return est.depth_fn()


def _port_slice(kind, w2i, trees):
    _, trainable, frozen, stats = trees
    cap = build_captioner(kind, len(w2i), ConfigTrain(),
                          encoder_dtype=torch.float32, resnet_layers=LAYERS,
                          device="cpu")
    params_from_jax(cap, trainable, frozen, stats)
    depth_fn = None
    if "dpt" in frozen:
        est = DPTDepthEstimator(dtype=torch.float32, image_size=HW,
                                device="cpu", **TINY_DPT)
        dpt_params_from_jax(est, frozen["dpt"])
        depth_fn = est.depth_fn()
    return cap, depth_fn


@pytest.mark.parametrize("beam", [1, 3])
@pytest.mark.parametrize("kind", ["base-hard", "depth-hard"])
def test_hard_slice_matches_jax(kind, beam, vocab, slices, images):
    """The whole caption program (f32 encoders, the tiny DPT for
    depth-hard): the JAX ``make_caption_fn`` on one key and the port's on
    that key's draws, greedy with <end> and beam 3."""
    w2i, _ = vocab
    trees = slices[kind]
    jcap, trainable, frozen, stats = trees
    start, end = w2i[SPECIAL.start], w2i[SPECIAL.end]
    key = jax.random.PRNGKey(21)
    jfn = jax_make_caption_fn(
        jcap, start, max_length=MAX_LEN, end_id=end, beam_size=beam,
        depth_fn=_jax_depth_fn() if kind == "depth-hard" else None)
    want = np.asarray(jfn(*(jax.tree_util.tree_map(jnp.asarray, t)
                            for t in (frozen, trainable, stats)),
                          jnp.asarray(images), key))
    cap, depth_fn = _port_slice(kind, w2i, trees)
    fn = make_caption_fn(cap, start, MAX_LEN, depth_fn, end_id=end,
                         beam_size=beam)
    got = fn(torch.from_numpy(images), att_noise=greedy_noise(key))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len({tuple(r) for r in want}) > 1
    with pytest.raises(ValueError, match="generator or an att_noise"):
        fn(torch.from_numpy(images))


def _pipe(vocab, cap, **kw):
    w2i, i2w = vocab
    return CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                           batch_buckets=(2, 4), image_hw=(HW, HW), **kw)


@pytest.mark.parametrize("beam", [1, 3])
def test_hard_pipeline_is_seeded(beam, vocab, slices, images):
    """Without ``sample`` a hard pipeline captions a request the same way
    on every call (each chunk re-seeds the draws with ``seed``), and
    another seed gives other captions; with ``sample`` each call draws
    fresh ones, deterministic per seed. The CPU launches no kernel."""
    cap, _ = _port_slice("base-hard", vocab[0], slices["base-hard"])
    before = (decode_seq.LAUNCHES, decode_step.LAUNCHES, beam_seq.LAUNCHES)
    pipe = _pipe(vocab, cap, seed=3, beam_size=beam)
    a = pipe.caption_tokens(images)
    assert a.shape == (len(images), MAX_LEN)
    np.testing.assert_array_equal(pipe.caption_tokens(images), a)
    np.testing.assert_array_equal(
        _pipe(vocab, cap, seed=3, beam_size=beam).caption_tokens(images), a)
    other = _pipe(vocab, cap, seed=4, beam_size=beam).caption_tokens(images)
    assert not np.array_equal(other, a)
    if beam == 1:
        sampled = _pipe(vocab, cap, seed=3, sample=True)
        s1, s2 = sampled.caption_tokens(images), sampled.caption_tokens(
            images)
        assert not np.array_equal(s1, s2)
        np.testing.assert_array_equal(
            _pipe(vocab, cap, seed=3, sample=True).caption_tokens(images),
            s1)
    assert (decode_seq.LAUNCHES, decode_step.LAUNCHES,
            beam_seq.LAUNCHES) == before
