"""The whole depth-soft greedy slice: the port == the JAX package.

One JAX ``build_captioner("depth-soft")`` (ResNet blocks 1,1,1,1 at 64x64,
f32 encoders, default decoder widths) and the JAX tests' tiny DPT (3 ViT
blocks, width 64, at 64x64) are initialized; their trees are loaded into
the port with ``params_from_jax`` and ``dpt_params_from_jax``, and the same
seeded uint8 images go through the JAX ``make_caption_fn(depth_fn=...,
use_pallas=True)`` (the Pallas decode kernel in interpret mode) and through
the port's ``make_caption_fn``, ``CaptionPipeline`` and CLI. The CPU is
deterministic and the seed fixed: token IDs must be equal.

``DepthCNNEncoder`` alone: f32 atol 1e-4 (convs of 49-4,608 terms summed in
another order); bf16 max abs error <= 5e-2 * max|feat|, as for the RGB
encoder, because bf16 rounds at different places in the two frameworks'
convs."""

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
from depth_image_captioning_pub_tpu.models import dpt as jdpt
from depth_image_captioning_pub_tpu.models.captioner import (
    build_captioner as jax_build_captioner)
from depth_image_captioning_pub_tpu.models.depth_encoders import (
    DepthCNNEncoder as JaxDepthCNNEncoder)
from depth_image_captioning_pub_torch import cli
from depth_image_captioning_pub_torch.engine.evaluate import make_caption_fn
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.models.depth_encoders import (
    DepthCNNEncoder)
from depth_image_captioning_pub_torch.models.dpt import (
    TINY_DPT, DPTDepthEstimator)
from depth_image_captioning_pub_torch.ops.image_ops import (
    imagenet_normalize, to_unit_float)
from depth_image_captioning_pub_torch.ops.kernels import (
    decode_seq, vit_attention)
from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    dpt_params_from_jax, flax_state_dict, params_from_jax, save_npz)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

LAYERS = (1, 1, 1, 1)
HW = 64
MAX_LEN = 8
N_IMAGES = 6


def _tree(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _scale_kernels(tree, factor):
    """Random torch-default conv inits shrink activations layer by layer,
    which would give every image the same caption; scaling the kernels
    keeps the features image-dependent."""
    return {k: (_scale_kernels(v, factor) if isinstance(v, dict)
                else np.asarray(v) * (factor if k == "kernel" else 1.0))
            for k, v in tree.items()}


def _random_stats(stats, rng):
    """BN running statistics other than flax's mean 0 / var 1."""
    return {name: {"mean": rng.normal(0.0, 0.1, s["mean"].shape)
                   .astype(np.float32),
                   "var": rng.uniform(0.5, 1.5, s["var"].shape)
                   .astype(np.float32)}
            for name, s in stats.items()}


@pytest.fixture(scope="module")
def vocab():
    words = ["a", "dog", "runs", "in", "park", "cat", "sits", "on", "mat",
             "man", "rides", "bike", "red", "blue"]
    words += [SPECIAL.start, SPECIAL.end, SPECIAL.unk, SPECIAL.null]
    w2i = {w: i for i, w in enumerate(words)}
    return w2i, {i: w for w, i in w2i.items()}


@pytest.fixture(scope="module")
def trees(vocab):
    """(trainable, frozen incl. "dpt", batch_stats) of one JAX depth-soft
    captioner and tiny DPT, as numpy trees."""
    w2i, _ = vocab
    jcap = jax_build_captioner("depth-soft", len(w2i), ConfigTrain(),
                               encoder_dtype=jnp.float32,
                               resnet_layers=LAYERS)
    params, frozen, stats = jcap.init(jax.random.PRNGKey(0),
                                      image_hw=(HW, HW))
    trainable = _tree(params)
    # kernel scales that put RGB and depth features at the same magnitude
    # (~1e2), so both branches move the tokens
    trainable["depth_encoder"] = _scale_kernels(trainable["depth_encoder"],
                                                6.0)
    out_b = trainable["decoder"]["out_b"].copy()
    out_b[w2i[SPECIAL.end]] += 1.0     # some captions end before MAX_LEN
    trainable["decoder"] = dict(trainable["decoder"], out_b=out_b)
    dpt = jdpt.DPTDepthModel(**TINY_DPT)
    dpt_vars = jax.jit(dpt.init)(jax.random.PRNGKey(1),
                                 jnp.zeros((1, HW, HW, 3)))
    frozen = {"encoder": _scale_kernels(_tree(frozen)["encoder"], 1.5),
              "dpt": _tree(dpt_vars)}
    stats = _random_stats(_tree(stats), np.random.default_rng(4))
    return jcap, trainable, frozen, stats


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(3).integers(0, 256, (N_IMAGES, HW, HW, 3),
                                             dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_tokens(vocab, trees, images):
    w2i, _ = vocab
    jcap, trainable, frozen, stats = trees
    est = jdpt.DPTDepthEstimator(dtype=jnp.float32, image_size=HW)
    est.model = jdpt.DPTDepthModel(**TINY_DPT)
    fn = jax_make_caption_fn(jcap, w2i[SPECIAL.start], max_length=MAX_LEN,
                             depth_fn=est.depth_fn(), end_id=w2i[SPECIAL.end],
                             use_pallas=True)
    toks = np.asarray(fn(jax.tree_util.tree_map(jnp.asarray, frozen),
                         jax.tree_util.tree_map(jnp.asarray, trainable),
                         jax.tree_util.tree_map(jnp.asarray, stats),
                         jnp.asarray(images), jax.random.PRNGKey(0)))
    # the case is informative: captions differ and some end early
    assert len({tuple(r) for r in toks}) > 1
    assert (toks == w2i[SPECIAL.end]).any()
    return toks


def _port(vocab, trees, dtype=torch.float32):
    """The port's captioner and DPT depth function on the JAX trees."""
    w2i, _ = vocab
    _, trainable, frozen, stats = trees
    cap = build_captioner("depth-soft", len(w2i), ConfigTrain(),
                          encoder_dtype=dtype, resnet_layers=LAYERS,
                          device="cpu")
    params_from_jax(cap, trainable, frozen, stats)
    est = DPTDepthEstimator(dtype=dtype, image_size=HW, device="cpu",
                            **TINY_DPT)
    dpt_params_from_jax(est, frozen["dpt"])
    return cap, est.depth_fn()


@pytest.fixture(scope="module")
def port(vocab, trees):
    return _port(vocab, trees)


def test_caption_fn_tokens_equal(vocab, port, images, jax_tokens):
    w2i, _ = vocab
    cap, depth_fn = port
    fn = make_caption_fn(cap, w2i[SPECIAL.start], max_length=MAX_LEN,
                         depth_fn=depth_fn, end_id=w2i[SPECIAL.end])
    got = fn(torch.from_numpy(images))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jax_tokens)


def test_depth_branch_changes_tokens(vocab, port, images, jax_tokens):
    """The same decoder without the depth features captions otherwise, so
    the parity above rests on the depth branch too."""
    w2i, _ = vocab
    cap, _ = port
    with torch.inference_mode():
        x = to_unit_float(torch.from_numpy(images))
        feats = cap.encoder(imagenet_normalize(x))
        rgb_only = cap.decoder.greedy_sample(
            feats, w2i[SPECIAL.start], max_length=MAX_LEN,
            end_id=w2i[SPECIAL.end])
    assert not np.array_equal(rgb_only.numpy(), jax_tokens)


def test_pipeline_two_buckets_equal(vocab, port, images, jax_tokens):
    w2i, i2w = vocab
    cap, depth_fn = port
    before = (decode_seq.LAUNCHES, vit_attention.LAUNCHES)
    pipe = CaptionPipeline(cap, w2i, i2w, depth_fn=depth_fn,
                           max_length=MAX_LEN, batch_buckets=(2, 4),
                           image_hw=(HW, HW))
    # 6 images: one chunk of 4, one of 2; then 3 images padded to 4
    np.testing.assert_array_equal(pipe.caption_tokens(images), jax_tokens)
    np.testing.assert_array_equal(pipe.caption_tokens(images[:3]),
                                  jax_tokens[:3])
    assert pipe(list(images)) == [ids_to_caption(r, i2w)
                                  for r in jax_tokens]
    # the CPU path runs the plain versions and launches no kernel
    assert (decode_seq.LAUNCHES, vit_attention.LAUNCHES) == before


def test_depth_kind_needs_depth_fn(vocab, port):
    w2i, i2w = vocab
    cap, _ = port
    with pytest.raises(ValueError, match="depth_fn"):
        CaptionPipeline(cap, w2i, i2w)
    with pytest.raises(ValueError, match="depth_fn"):
        make_caption_fn(cap, w2i[SPECIAL.start])


def test_cli_from_npz(vocab, trees, images, tmp_path, capsys):
    """The CLI (bf16 encoders and DPT, its default) on an .npz holding the
    captioner, its BN statistics and the DPT == the port's pipeline on the
    same trees loaded in memory."""
    w2i, i2w = vocab
    _, trainable, frozen, stats = trees
    save_npz(str(tmp_path / "params.npz"), trainable, frozen, stats)
    np.save(tmp_path / "images.npy", images)
    with open(tmp_path / "w2i.pkl", "wb") as f:
        pickle.dump(w2i, f)
    capsys.readouterr()
    cli.main(["caption", "--kind", "depth-soft", "--tiny-dpt",
              "--images", str(tmp_path / "images.npy"),
              "--weights", str(tmp_path / "params.npz"),
              "--vocab", str(tmp_path / "w2i.pkl"), "--device", "cpu",
              "--resnet-layers", "1,1,1,1", "--image-size", str(HW),
              "--max-length", str(MAX_LEN), "--batch-buckets", "4"])
    out = capsys.readouterr()
    assert "WARNING" not in out.err       # the DPT came from the file
    cap, depth_fn = _port(vocab, trees, dtype=torch.bfloat16)
    # f32 parameters, as the JAX module's; the convs compute in bf16
    assert cap.depth_module.conv1.weight.dtype == torch.float32
    assert cap.depth_module.dtype == torch.bfloat16
    pipe = CaptionPipeline(cap, w2i, i2w, depth_fn=depth_fn,
                           max_length=MAX_LEN, batch_buckets=(4,),
                           image_hw=(HW, HW))
    assert out.out.splitlines() == pipe(list(images))


def test_params_from_jax_is_strict(vocab, trees):
    w2i, _ = vocab
    _, trainable, frozen, stats = trees
    cap = build_captioner("depth-soft", len(w2i), ConfigTrain(),
                          resnet_layers=LAYERS, device="cpu")
    no_bn_stats = {k: v for k, v in stats.items() if k != "bn2"}
    with pytest.raises(RuntimeError, match="bn2.running_mean"):
        params_from_jax(cap, trainable, frozen, no_bn_stats)
    base = build_captioner("base-soft", len(w2i), ConfigTrain(),
                           resnet_layers=LAYERS, device="cpu")
    with pytest.raises(KeyError, match="depth_encoder"):
        params_from_jax(base, trainable, frozen)


@pytest.fixture(scope="module")
def depth_encoder_vars():
    enc = JaxDepthCNNEncoder(dtype=jnp.float32)
    variables = _tree(jax.jit(enc.init)(jax.random.PRNGKey(5),
                                        jnp.zeros((1, 224, 224, 1))))
    rng = np.random.default_rng(6)
    params = {k: dict(v, bias=rng.normal(0.0, 0.1, v["bias"].shape)
                      .astype(np.float32))
              for k, v in variables["params"].items()}
    return {"params": params,
            "batch_stats": _random_stats(variables["batch_stats"], rng)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depth_cnn_encoder_matches_jax(depth_encoder_vars, dtype):
    depth = np.random.default_rng(7).random((2, 224, 224, 1)).astype(
        np.float32)
    want = np.asarray(JaxDepthCNNEncoder(dtype=getattr(jnp, dtype)).apply(
        depth_encoder_vars, jnp.asarray(depth)), np.float32)
    enc = DepthCNNEncoder(14, dtype=getattr(torch, dtype))
    enc.load_state_dict(
        {k: torch.tensor(v) for k, v in flax_state_dict(
            depth_encoder_vars["params"],
            depth_encoder_vars["batch_stats"]).items()}, strict=True)
    with torch.inference_mode():
        got = enc(torch.from_numpy(depth))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape == (2, 196, 2048)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        err = np.abs(got - want).max()
        assert err <= 5e-2 * np.abs(want).max(), (err, np.abs(want).max())
