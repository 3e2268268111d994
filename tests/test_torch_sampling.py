"""Stochastic sampling: the port == the JAX package, on the CPU.

The JAX package draws each token with ``jax.random.categorical(k,
filtered_logits(logits))``, which is ``argmax(gumbel(k, (B, V)) + filt)``.
PyTorch's generators give other numbers, so the decoder tests feed the
port the JAX package's own Gumbel noise (``noise=``), drawn with the keys
the JAX scans use: ``split(fold_in(rng, t))[1]`` for the attention decoder
(JAX ``models/decoder.py``), ``fold_in(rng, t)`` for NIC (``models/nic.py``).

Tolerances: ``filtered_logits``' kept set equal and its values within 1e-6;
tokens integer-equal (the CPU is deterministic and the seeds fixed);
alphas within 2e-5 (f32 sums in another order).
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
from depth_image_captioning_pub_tpu.models.nic import (
    NICDecoder as JaxNICDecoder)
from depth_image_captioning_pub_tpu.ops import decode as jdecode
from depth_image_captioning_pub_torch import cli
from depth_image_captioning_pub_torch.engine.evaluate import make_caption_fn
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.models.decoder import AttentionDecoder
from depth_image_captioning_pub_torch.models.nic import NICDecoder
from depth_image_captioning_pub_torch.ops import decode as tdecode
from depth_image_captioning_pub_torch.ops.image_ops import (
    imagenet_normalize, to_unit_float)
from depth_image_captioning_pub_torch.ops.kernels import (
    decode_seq, decode_step)
from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
from depth_image_captioning_pub_torch.utils.jax_bridge import params_from_jax
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

VOCAB, K, D, DIM = 37, 12, 16, 8
START = 1
L = 9
NIC_E, NIC_H = 24, 16


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _tie_logits(seed):
    """[6, 40] logits with many exact ties: half-integers, so the k-th
    value and the nucleus boundary often fall inside a run of equal
    values; one row of distinct values."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-6, 6, (6, 40)).astype(np.float32) * 0.5
    x[0] = rng.standard_normal(40).astype(np.float32) * 2.0
    return x


@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.3])
@pytest.mark.parametrize("top_k", [0, 1, 5])
@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_filtered_logits_matches_jax(temperature, top_k, top_p):
    x = _tie_logits(int(temperature * 4) + 7 * top_k + int(top_p * 10))
    want = np.asarray(jdecode.filtered_logits(
        jnp.asarray(x), temperature=temperature, top_k=top_k, top_p=top_p))
    got = tdecode.filtered_logits(torch.from_numpy(x),
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p)
    assert got.dtype == torch.float32
    got = got.numpy()
    kept = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), kept)
    assert np.all(got[~kept] == -np.inf)
    np.testing.assert_allclose(got[kept], want[kept], rtol=0, atol=1e-6)
    assert kept.any(axis=1).all()          # the argmax is always kept
    if top_k and top_p == 1.0:
        # ties at the k-th value are all kept: some row keeps more than k
        counts = kept.sum(axis=1)
        assert counts.min() >= top_k and counts.max() > top_k


def test_filtered_logits_floors_the_temperature():
    x = _tie_logits(3)
    want = np.asarray(jdecode.filtered_logits(jnp.asarray(x),
                                              temperature=0.0))
    got = tdecode.filtered_logits(torch.from_numpy(x), temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gumbel_argmax_is_jax_categorical(seed):
    """argmax(filt + gumbel(k)) == jax.random.categorical(k, filt), the
    lowest index on ties."""
    x = _tie_logits(seed)
    filt = jdecode.filtered_logits(jnp.asarray(x), top_p=0.9)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.categorical(key, filt))
    noise = np.array(jax.random.gumbel(key, x.shape))
    got = tdecode.gumbel_argmax(torch.from_numpy(np.array(filt)),
                                torch.from_numpy(noise))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    tied = torch.zeros(2, 5)
    assert tdecode.gumbel_argmax(tied, torch.zeros(2, 5)).tolist() == [0, 0]


def test_gumbel_noise_from_generator():
    gen = torch.Generator().manual_seed(5)
    z = tdecode.gumbel_noise((4000, 50), gen)
    assert z.dtype == torch.float32 and tuple(z.shape) == (4000, 50)
    assert bool(torch.isfinite(z).all())
    assert abs(z.mean().item() - 0.5772) < 0.01       # Euler's gamma
    again = tdecode.gumbel_noise((4000, 50), torch.Generator().manual_seed(5))
    assert torch.equal(z, again)
    assert not torch.equal(tdecode.gumbel_noise((4000, 50), gen), z)


# ---- the decoders on the JAX package's noise --------------------------------


def _jax_attention(fusion="none", seed=0):
    dec = JaxAttentionDecoder(vocab_size=VOCAB, dim_attention=DIM,
                              dim_embedding=DIM, dim_encoder=D,
                              dim_decoder=DIM, fusion=fusion)
    feats = jnp.zeros((1, K, D))
    dep = feats if fusion != "none" else None
    params = dec.init(jax.random.PRNGKey(seed), feats,
                      jnp.zeros((1, 5), jnp.int32), dep)["params"]
    return dec, _np_tree(params)


def _port_attention(params, fusion="none"):
    dec = AttentionDecoder(VOCAB, dim_attention=DIM, dim_embedding=DIM,
                           dim_encoder=D, dim_decoder=DIM, fusion=fusion,
                           device="cpu")
    dec.load_state_dict({k: torch.tensor(v) for k, v in params.items()},
                        strict=True)
    return dec


def _attention_noise(rng, steps, shape):
    """The draws of JAX ``AttentionDecoder.stochastic_sample``'s scan."""
    return [np.array(jax.random.gumbel(
        jax.random.split(jax.random.fold_in(rng, t))[1], shape))
        for t in range(steps)]


def _replay(noise):
    return lambda t: torch.from_numpy(noise[t])


@pytest.mark.parametrize("fusion", ["none", "add"])
@pytest.mark.parametrize("settings", [
    dict(temperature=1.0, top_k=0, top_p=1.0),
    dict(temperature=0.7, top_k=5, top_p=0.9),
    dict(temperature=2.0, top_k=0, top_p=0.3),
])
def test_attention_stochastic_sample_matches_jax(fusion, settings):
    jdec, params = _jax_attention(fusion, seed=3)
    params["out_w"] = params["out_w"] * 20.0    # a peaked distribution
    rng = np.random.default_rng(4)
    bsz = 5
    feats = rng.standard_normal((bsz, K, D)).astype(np.float32)
    dep = (rng.standard_normal((bsz, K, D)).astype(np.float32)
           if fusion == "add" else None)
    key = jax.random.PRNGKey(11)
    want_tok, want_alpha = jdec.apply(
        {"params": params}, jnp.asarray(feats), START, key,
        None if dep is None else jnp.asarray(dep), max_length=L,
        method=JaxAttentionDecoder.stochastic_sample, **settings)
    before = decode_step.LAUNCHES
    got_tok, got_alpha = _port_attention(params, fusion).stochastic_sample(
        torch.from_numpy(feats), START, None,
        None if dep is None else torch.from_numpy(dep), max_length=L,
        noise=_replay(_attention_noise(key, L, (bsz, VOCAB))), **settings)
    assert decode_step.LAUNCHES == before    # CPU: the plain step
    want_tok = np.asarray(want_tok)
    assert got_tok.dtype == torch.int32 and got_alpha.dtype == torch.float32
    assert tuple(got_alpha.shape) == (bsz, L, K)
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)
    np.testing.assert_allclose(got_alpha.numpy(), np.asarray(want_alpha),
                               rtol=0, atol=2e-5)
    assert len({tuple(r) for r in want_tok}) > 1


def _jax_nic(seed=0):
    dec = JaxNICDecoder(vocab_size=VOCAB, dim_embedding=NIC_E,
                        dim_hidden=NIC_H)
    feats = np.random.default_rng(seed).standard_normal(
        (6, NIC_E)).astype(np.float32)
    params = dec.init(jax.random.PRNGKey(seed), jnp.asarray(feats),
                      jnp.zeros((6, 5), jnp.int32))["params"]
    return dec, _np_tree(params), feats


def _port_nic(params):
    dec = NICDecoder(VOCAB, dim_embedding=NIC_E, dim_hidden=NIC_H,
                     device="cpu")
    dec.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()},
                        strict=True)
    return dec


@pytest.mark.parametrize("settings", [
    dict(temperature=1.0, top_k=0, top_p=1.0),
    dict(temperature=0.5, top_k=5, top_p=0.9),
])
def test_nic_stochastic_sample_matches_jax(settings):
    jdec, params, feats = _jax_nic(seed=2)
    params = dict(params, out_w=params["out_w"] * 8.0)
    key = jax.random.PRNGKey(13)
    want = np.asarray(jdec.apply(
        {"params": params}, jnp.asarray(feats), key, max_length=L,
        method=JaxNICDecoder.stochastic_sample, **settings))
    noise = [np.array(jax.random.gumbel(jax.random.fold_in(key, t),
                                          (len(feats), VOCAB)))
             for t in range(L)]
    got = _port_nic(params).stochastic_sample(
        torch.from_numpy(feats), None, max_length=L, noise=_replay(noise),
        **settings)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len({tuple(r) for r in want}) > 1


def test_top_k_one_is_greedy():
    """top_k=1 keeps the argmax alone (and its ties): whatever the noise,
    the draw is greedy decode without <end>."""
    _, params = _jax_attention(seed=6)
    dec = _port_attention(params)
    feats = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, K, D)).astype(np.float32))
    greedy = dec.greedy_sample(feats, START, max_length=L, end_id=None)
    got, _ = dec.stochastic_sample(feats, START,
                                   torch.Generator().manual_seed(0),
                                   max_length=L, top_k=1)
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())
    _, nparams, nfeats = _jax_nic(seed=6)
    nic = _port_nic(nparams)
    x = torch.from_numpy(nfeats)
    np.testing.assert_array_equal(
        nic.stochastic_sample(x, torch.Generator().manual_seed(1),
                              max_length=L, top_k=1).numpy(),
        nic.greedy_sample(x, max_length=L).numpy())


# ---- the whole base-soft slice, and the pipeline ----------------------------

LAYERS = (1, 1, 1, 1)
HW = 64
MAX_LEN = 8


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
def slice_models(vocab):
    w2i, _ = vocab
    cfg = ConfigTrain()
    jcap = jax_build_captioner("base-soft", len(w2i), cfg,
                               encoder_dtype=jnp.float32,
                               resnet_layers=LAYERS)
    params, frozen, stats = jcap.init(jax.random.PRNGKey(0),
                                      image_hw=(HW, HW))
    trainable = jax.tree_util.tree_map(np.asarray, dict(params))
    frozen = {"encoder": _scale_kernels(frozen["encoder"], 3.0)}
    tcap = build_captioner("base-soft", len(w2i), cfg,
                           encoder_dtype=torch.float32, resnet_layers=LAYERS,
                           device="cpu")
    params_from_jax(tcap, trainable, frozen)
    return jcap, tcap, trainable, frozen, stats


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(3).integers(0, 256, (6, HW, HW, 3),
                                             dtype=np.uint8)


def test_base_soft_slice_samples_match_jax(vocab, slice_models, images):
    """JAX ``make_caption_fn(sampling=...)`` on uint8 images == the port's
    encoder and ``stochastic_sample`` on the JAX package's noise."""
    w2i, _ = vocab
    jcap, tcap, trainable, frozen, stats = slice_models
    sampling = {"temperature": 0.8, "top_k": 0, "top_p": 0.9}
    fn = jax_make_caption_fn(jcap, w2i[SPECIAL.start], max_length=MAX_LEN,
                             end_id=w2i[SPECIAL.end], sampling=sampling)
    key = jax.random.PRNGKey(21)
    want = np.asarray(fn(jax.tree_util.tree_map(jnp.asarray, frozen),
                         jax.tree_util.tree_map(jnp.asarray, trainable),
                         stats, jnp.asarray(images), key))
    with torch.inference_mode():
        x = torch.from_numpy(images)
        feats = tcap.encoder(imagenet_normalize(to_unit_float(x)))
        got, _ = tcap.decoder.stochastic_sample(
            feats, w2i[SPECIAL.start], None, max_length=MAX_LEN,
            noise=_replay(_attention_noise(key, MAX_LEN,
                                           (len(images), len(w2i)))),
            **sampling)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len({tuple(r) for r in want}) > 1


def _pipe(vocab, cap, **kw):
    w2i, i2w = vocab
    return CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                           batch_buckets=(2, 4), image_hw=(HW, HW), **kw)


def test_pipeline_sampling_is_seeded(vocab, slice_models, images):
    """One seed gives one sequence of captions; each call draws fresh
    ones; greedy ignores the seed. The CPU launches no kernel."""
    cap = slice_models[1]
    before = (decode_step.LAUNCHES, decode_seq.LAUNCHES)
    first = _pipe(vocab, cap, sample=True, seed=3)
    again = _pipe(vocab, cap, sample=True, seed=3)
    a = first.caption_tokens(images)
    np.testing.assert_array_equal(again.caption_tokens(images), a)
    b = first.caption_tokens(images)
    assert a.shape == b.shape == (len(images), MAX_LEN)
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(again.caption_tokens(images), b)
    other = _pipe(vocab, cap, sample=True, seed=4).caption_tokens(images)
    assert not np.array_equal(other, a)
    greedy = [_pipe(vocab, cap, seed=s).caption_tokens(images)
              for s in (0, 1)]
    np.testing.assert_array_equal(greedy[0], greedy[1])
    assert first.generator is not None and _pipe(vocab, cap).generator is None
    assert (decode_step.LAUNCHES, decode_seq.LAUNCHES) == before


def test_sampling_with_beam_search_raises(vocab, slice_models):
    w2i, _ = vocab
    cap = slice_models[1]
    with pytest.raises(ValueError, match="no beam"):
        _pipe(vocab, cap, sample=True, beam_size=3)
    with pytest.raises(ValueError, match="generator"):
        make_caption_fn(cap, w2i[SPECIAL.start], sampling={})


def test_nic_caption_fn_samples(vocab, images):
    """``make_caption_fn(sampling=...)`` on a NIC captioner draws from the
    generator: the same generator state, the same tokens; top_k=1 is the
    greedy caption."""
    w2i, _ = vocab
    cap = build_captioner("nic", len(w2i), ConfigTrain(),
                          encoder_dtype=torch.float32, resnet_layers=LAYERS,
                          device="cpu")
    cap.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(images)
    draws = [make_caption_fn(cap, w2i[SPECIAL.start], MAX_LEN,
                             sampling={"top_p": 0.9},
                             generator=torch.Generator().manual_seed(7))(x)
             for _ in range(2)]
    assert draws[0].shape == (len(images), MAX_LEN)
    np.testing.assert_array_equal(draws[0].numpy(), draws[1].numpy())
    top1 = make_caption_fn(cap, w2i[SPECIAL.start], MAX_LEN,
                           sampling={"top_k": 1},
                           generator=torch.Generator().manual_seed(7))(x)
    greedy = make_caption_fn(cap, w2i[SPECIAL.start], MAX_LEN)(x)
    np.testing.assert_array_equal(top1.numpy(), greedy.numpy())


def test_cli_sample(capsys):
    args = ["caption", "--random", "3", "--device", "cpu", "--vocab-size",
            "30", "--resnet-layers", "1,1,1,1", "--image-size", "64",
            "--max-length", "5", "--batch-buckets", "2", "--sample",
            "--top-p", "0.9", "--temperature", "1.5"]
    capsys.readouterr()
    cli.main(args)
    first = capsys.readouterr().out.splitlines()
    cli.main(args)
    assert capsys.readouterr().out.splitlines() == first
    assert len(first) == 3
    cli.main(args[:-5] + ["--seed", "1"] + args[-5:])
    assert capsys.readouterr().out.splitlines() != first
