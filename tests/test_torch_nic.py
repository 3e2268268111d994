"""The NIC slice: the port == the JAX package, on the CPU.

Module by module (the stacked LSTM step, the NIC greedy kernel's plain
version against the Pallas kernel in interpret mode, ``NICDecoder``'s
greedy and beam decode), then the whole slice: one JAX
``build_captioner("nic")`` (ResNet blocks 1,1,1,1 at 64x64, f32 encoder)
is initialized, its trees are loaded into the port with
``params_from_jax``, and the same seeded uint8 images go through the JAX
``make_caption_fn`` and through the port's ``make_caption_fn``,
``CaptionPipeline`` and CLI.

Tolerances: the LSTM step atol 1e-5 (f32 sums in another order); tokens
integer-equal (the CPU is deterministic and the seeds fixed); beam scores
atol 1e-5.
"""

import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from depth_image_captioning_pub_tpu.config import ConfigTrain
from depth_image_captioning_pub_tpu.data.tokenizer import (
    SPECIAL, ids_to_caption)
from depth_image_captioning_pub_tpu.engine.evaluate import (
    make_caption_fn as jax_make_caption_fn)
from depth_image_captioning_pub_tpu.models.captioner import (
    build_captioner as jax_build_captioner)
from depth_image_captioning_pub_tpu.models.nic import (
    NICDecoder as JaxNICDecoder)
from depth_image_captioning_pub_tpu.ops import lstm as jlstm
from depth_image_captioning_pub_tpu.ops.pallas import nic_seq as jnic_seq
from depth_image_captioning_pub_torch import cli
from depth_image_captioning_pub_torch.engine.evaluate import make_caption_fn
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.models.nic import NICDecoder
from depth_image_captioning_pub_torch.ops import lstm as tlstm
from depth_image_captioning_pub_torch.ops.kernels import decode_seq, nic_seq
from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    params_from_jax, save_npz)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

B, E, H, V, T = 10, 24, 16, 40, 9
END = 7
LAYERS = (1, 1, 1, 1)
HW = 64
MAX_LEN = 8
N_IMAGES = 6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@pytest.fixture(scope="module")
def jax_nic():
    """A JAX NICDecoder, its params (numpy) and seeded image embeddings."""
    dec = JaxNICDecoder(vocab_size=V, dim_embedding=E, dim_hidden=H)
    feats = np.random.default_rng(3).standard_normal((B, E)).astype(
        np.float32)
    params = dec.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                      jnp.zeros((B, 5), jnp.int32))["params"]
    return dec, _np_tree(params), feats


def _port_decoder(params):
    dec = NICDecoder(V, dim_embedding=E, dim_hidden=H, device="cpu")
    dec.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()},
                        strict=True)
    return dec


def test_stacked_lstm_step_matches_jax():
    rng = np.random.default_rng(1)
    layers, bsz = 2, 4
    cells = []
    for li in range(layers):
        d_in = E if li == 0 else H
        cells.append([rng.standard_normal(s).astype(np.float32) * 0.3
                      for s in ((d_in, 4 * H), (H, 4 * H), (4 * H,),
                                (4 * H,))])
    x = rng.standard_normal((bsz, E)).astype(np.float32)
    hs, cs = (rng.standard_normal((layers, bsz, H)).astype(np.float32)
              for _ in range(2))
    want = jlstm.stacked_lstm_step(
        jlstm.StackedLSTMParams(tuple(jlstm.LSTMCellParams(
            *map(jnp.asarray, c)) for c in cells)),
        jnp.asarray(x), jnp.asarray(hs), jnp.asarray(cs))
    got = tlstm.stacked_lstm_step(
        tlstm.StackedLSTMParams(tuple(tlstm.LSTMCellParams(
            *map(torch.from_numpy, c)) for c in cells)),
        torch.from_numpy(x), torch.from_numpy(hs), torch.from_numpy(cs))
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_plain_kernel_matches_pallas_kernel(jax_nic):
    """The plain version at B=10 as it is; the Pallas kernel (interpret
    mode) takes B padded to 16."""
    _, params, feats = jax_nic
    jlayers = tuple(jlstm.LSTMCellParams(
        *(jnp.asarray(params[f"lstm{li}_{n}"])
          for n in ("w_ih", "w_hh", "b_ih", "b_hh"))) for li in range(2))
    jw = jnic_seq.pack_nic_weights(
        jlstm.StackedLSTMParams(jlayers), jnp.asarray(params["out_w"]),
        jnp.asarray(params["out_b"]), jnp.asarray(params["embed"]))
    padded = np.concatenate([feats, feats[:16 - B]])
    want = np.asarray(jnic_seq.fused_nic_greedy_decode(
        jnp.asarray(padded), jw, max_length=T, interpret=True))[:B]
    dec = _port_decoder(params)
    before = nic_seq.LAUNCHES
    got = nic_seq.fused_nic_greedy_decode(torch.from_numpy(feats),
                                          dec.seq_weights(), max_length=T)
    assert nic_seq.LAUNCHES == before   # the CPU runs the plain version
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, T)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len({tuple(r) for r in want}) > 1


def test_kernel_wrapper_checks_shapes(jax_nic):
    _, params, feats = jax_nic
    w = _port_decoder(params).seq_weights()
    with pytest.raises(ValueError, match="w_ih_0"):
        nic_seq.fused_nic_greedy_decode(torch.zeros(B, E + 1), w)
    with pytest.raises(ValueError, match="layers"):
        nic_seq.fused_nic_greedy_decode(
            torch.from_numpy(feats), w._replace(layer_mats=w.layer_mats[:2]))
    with pytest.raises(TypeError, match="float32"):
        nic_seq.fused_nic_greedy_decode(torch.from_numpy(feats).double(), w)


def test_decoder_greedy_sample_matches_jax(jax_nic):
    dec, params, feats = jax_nic
    want = np.asarray(dec.apply({"params": params}, jnp.asarray(feats),
                                max_length=T, method=dec.greedy_sample))
    got = _port_decoder(params).greedy_sample(torch.from_numpy(feats),
                                              max_length=T)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("beam,length_penalty,early_exit",
                         [(3, 0.0, False), (4, 0.7, True)])
def test_decoder_beam_sample_matches_jax(jax_nic, beam, length_penalty,
                                         early_exit):
    dec, params, feats = jax_nic
    # a sharper head: some images' best beam ends, others' never does
    params = dict(params, out_w=params["out_w"] * 8.0)
    want_tok, want_score = dec.apply(
        {"params": params}, jnp.asarray(feats), END, beam_size=beam,
        max_length=T, length_penalty=length_penalty, early_exit=early_exit,
        method=dec.beam_sample)
    got_tok, got_score = _port_decoder(params).beam_sample(
        torch.from_numpy(feats), END, beam_size=beam, max_length=T,
        length_penalty=length_penalty, early_exit=early_exit)
    want_tok = np.asarray(want_tok)
    assert (want_tok == END).any() and (want_tok != END).any()
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)
    np.testing.assert_allclose(got_score.numpy(), np.asarray(want_score),
                               rtol=0, atol=1e-5)


# ---- the whole NIC slice ---------------------------------------------------


def _scale_kernels(tree, factor):
    """Random torch-default conv inits shrink activations layer by layer,
    which would give every image the same caption; scaling the kernels
    keeps the features image-dependent."""
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
def slice_trees(vocab):
    w2i, _ = vocab
    jcap = jax_build_captioner("nic", len(w2i), ConfigTrain(),
                               encoder_dtype=jnp.float32,
                               resnet_layers=LAYERS)
    params, frozen, stats = jcap.init(jax.random.PRNGKey(0),
                                      image_hw=(HW, HW))
    trainable = _np_tree(params)
    frozen = {"encoder": _scale_kernels(_np_tree(frozen)["encoder"], 3.0)}
    return jcap, trainable, frozen, stats


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(4).integers(0, 256, (N_IMAGES, HW, HW, 3),
                                             dtype=np.uint8)


def _jax_tokens(vocab, slice_trees, images, **kw):
    w2i, _ = vocab
    jcap, trainable, frozen, stats = slice_trees
    fn = jax_make_caption_fn(jcap, w2i[SPECIAL.start], max_length=MAX_LEN,
                             end_id=w2i[SPECIAL.end], **kw)
    return np.asarray(fn(jax.tree_util.tree_map(jnp.asarray, frozen),
                         jax.tree_util.tree_map(jnp.asarray, trainable),
                         stats, jnp.asarray(images), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_tokens(vocab, slice_trees, images):
    toks = _jax_tokens(vocab, slice_trees, images)
    assert len({tuple(r) for r in toks}) > 1   # the case is informative
    return toks


@pytest.fixture(scope="module")
def port_cap(vocab, slice_trees):
    w2i, _ = vocab
    _, trainable, frozen, _ = slice_trees
    cap = build_captioner("nic", len(w2i), ConfigTrain(),
                          encoder_dtype=torch.float32, resnet_layers=LAYERS,
                          device="cpu")
    params_from_jax(cap, trainable, frozen)
    return cap


def test_caption_fn_tokens_equal(vocab, port_cap, images, jax_tokens):
    w2i, _ = vocab
    fn = make_caption_fn(port_cap, w2i[SPECIAL.start], max_length=MAX_LEN,
                         end_id=w2i[SPECIAL.end])
    got = fn(torch.from_numpy(images))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jax_tokens)


def test_caption_fn_beam_tokens_equal(vocab, slice_trees, port_cap, images):
    w2i, _ = vocab
    want = _jax_tokens(vocab, slice_trees, images, beam_size=3,
                       length_penalty=0.7)
    fn = make_caption_fn(port_cap, w2i[SPECIAL.start], max_length=MAX_LEN,
                         end_id=w2i[SPECIAL.end], beam_size=3,
                         length_penalty=0.7)
    np.testing.assert_array_equal(fn(torch.from_numpy(images)).numpy(),
                                  want)


def test_pipeline_two_buckets_equal(vocab, port_cap, images, jax_tokens):
    w2i, i2w = vocab
    before = (nic_seq.LAUNCHES, decode_seq.LAUNCHES)
    pipe = CaptionPipeline(port_cap, w2i, i2w, max_length=MAX_LEN,
                           batch_buckets=(2, 4), image_hw=(HW, HW))
    np.testing.assert_array_equal(pipe.caption_tokens(images), jax_tokens)
    np.testing.assert_array_equal(pipe.caption_tokens(images[:3]),
                                  jax_tokens[:3])
    caps = pipe(list(images))
    # step 0 predicts from the image embedding; <start> is skipped
    assert caps == [ids_to_caption(r, i2w) for r in jax_tokens]
    assert (nic_seq.LAUNCHES, decode_seq.LAUNCHES) == before


def test_cli_from_npz(vocab, slice_trees, images, tmp_path, capsys):
    """``cli caption --kind nic`` (bf16 encoder, its default) on an .npz of
    the JAX trees == the port's pipeline on the same trees in memory."""
    w2i, i2w = vocab
    _, trainable, frozen, _ = slice_trees
    save_npz(str(tmp_path / "params.npz"), trainable, frozen)
    np.save(tmp_path / "images.npy", images)
    with open(tmp_path / "w2i.pkl", "wb") as f:
        pickle.dump(w2i, f)
    capsys.readouterr()
    cli.main(["caption", "--kind", "nic",
              "--images", str(tmp_path / "images.npy"),
              "--weights", str(tmp_path / "params.npz"),
              "--vocab", str(tmp_path / "w2i.pkl"), "--device", "cpu",
              "--resnet-layers", "1,1,1,1", "--image-size", str(HW),
              "--max-length", str(MAX_LEN), "--batch-buckets", "4"])
    lines = capsys.readouterr().out.splitlines()
    cap = build_captioner("nic", len(w2i), ConfigTrain(),
                          resnet_layers=LAYERS, device="cpu")
    assert cap.backbone.conv1.weight.dtype == torch.bfloat16
    params_from_jax(cap, trainable, frozen)
    pipe = CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                           batch_buckets=(4,), image_hw=(HW, HW))
    assert lines == pipe(list(images)) and len(lines) == N_IMAGES


def test_params_from_jax_is_strict(vocab, slice_trees):
    w2i, _ = vocab
    _, trainable, frozen, _ = slice_trees
    cap = build_captioner("nic", len(w2i), ConfigTrain(),
                          resnet_layers=LAYERS, device="cpu")
    with pytest.raises(KeyError, match="depth_encoder"):
        params_from_jax(cap, dict(trainable, depth_encoder={}), frozen)
    dec = {k: v for k, v in trainable["decoder"].items() if k != "out_b"}
    with pytest.raises(RuntimeError, match="out_b"):
        params_from_jax(cap, dict(trainable, decoder=dec), frozen)
