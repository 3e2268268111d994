"""The whole base-soft greedy slice: the port == the JAX package.

One JAX ``build_captioner("base-soft")`` (ResNet blocks 1,1,1,1 at 64x64,
f32 encoder, default decoder widths) is initialized, its parameter trees
are loaded into the port with ``params_from_jax``, and the same seeded
uint8 images go through the JAX ``make_caption_fn(use_pallas=True)`` (the
Pallas kernel in interpret mode) and through the port's
``make_caption_fn``, ``CaptionPipeline``, ``generate_captions`` and CLI.
The CPU is deterministic and the seed fixed: token IDs must be equal."""

import os
import pickle
import subprocess
import sys

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
from depth_image_captioning_pub_torch import cli
from depth_image_captioning_pub_torch.engine.evaluate import (
    generate_captions, make_caption_fn)
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.ops.kernels import (
    decode_seq, decode_step)
from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    params_from_jax, save_npz)

LAYERS = (1, 1, 1, 1)
HW = 64
MAX_LEN = 8
N_IMAGES = 6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def models(vocab):
    w2i, _ = vocab
    cfg = ConfigTrain()
    jcap = jax_build_captioner("base-soft", len(w2i), cfg,
                               encoder_dtype=jnp.float32,
                               resnet_layers=LAYERS)
    params, frozen, stats = jcap.init(jax.random.PRNGKey(0),
                                      image_hw=(HW, HW))
    trainable = jax.tree_util.tree_map(np.asarray, dict(params))
    frozen = {"encoder": _scale_kernels(frozen["encoder"], 3.0)}
    out_b = trainable["decoder"]["out_b"].copy()
    out_b[w2i[SPECIAL.end]] += 1.0     # some captions end before MAX_LEN
    trainable["decoder"] = dict(trainable["decoder"], out_b=out_b)
    tcap = build_captioner("base-soft", len(w2i), cfg,
                           encoder_dtype=torch.float32, resnet_layers=LAYERS)
    params_from_jax(tcap, trainable, frozen)
    return jcap, tcap, trainable, frozen, stats


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(3).integers(0, 256, (N_IMAGES, HW, HW, 3),
                                             dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_tokens(vocab, models, images):
    w2i, _ = vocab
    jcap, _, trainable, frozen, stats = models
    fn = jax_make_caption_fn(jcap, w2i[SPECIAL.start], max_length=MAX_LEN,
                             end_id=w2i[SPECIAL.end], use_pallas=True)
    jfrozen = jax.tree_util.tree_map(jnp.asarray, frozen)
    jparams = jax.tree_util.tree_map(jnp.asarray, trainable)
    toks = fn(jfrozen, jparams, stats, jnp.asarray(images),
              jax.random.PRNGKey(0))
    toks = np.asarray(toks)
    # the case is informative: captions differ and some end early
    assert len({tuple(r) for r in toks}) > 1
    assert (toks == w2i[SPECIAL.end]).any()
    return toks


def test_caption_fn_tokens_equal(vocab, models, images, jax_tokens):
    w2i, _ = vocab
    tcap = models[1]
    fn = make_caption_fn(tcap, w2i[SPECIAL.start], max_length=MAX_LEN,
                         end_id=w2i[SPECIAL.end])
    got = fn(torch.from_numpy(images))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jax_tokens)


def test_pipeline_two_buckets_equal(vocab, models, images, jax_tokens):
    w2i, i2w = vocab
    before = (decode_seq.LAUNCHES, decode_step.LAUNCHES)
    pipe = CaptionPipeline(models[1], w2i, i2w, max_length=MAX_LEN,
                           batch_buckets=(2, 4), image_hw=(HW, HW))
    # 6 images: one chunk of 4, one of 2; then 3 images padded to 4
    np.testing.assert_array_equal(pipe.caption_tokens(images), jax_tokens)
    np.testing.assert_array_equal(pipe.caption_tokens(images[:3]),
                                  jax_tokens[:3])
    caps = pipe(list(images))
    assert caps == [ids_to_caption(r, i2w) for r in jax_tokens]
    assert pipe(images[0]) == caps[0]
    assert pipe.caption_tokens(images[:0]).shape == (0, MAX_LEN)
    # the CPU path runs the plain versions and launches no kernel
    assert (decode_seq.LAUNCHES, decode_step.LAUNCHES) == before


def test_pipeline_rejects_wrong_images(vocab, models):
    w2i, i2w = vocab
    pipe = CaptionPipeline(models[1], w2i, i2w, image_hw=(HW, HW))
    with pytest.raises(ValueError):
        pipe.caption_tokens(np.zeros((1, HW, HW, 3), np.float32))
    with pytest.raises(TypeError):
        pipe(["dog.jpg"])


class _Dataset:
    def __init__(self, images):
        self.images = images

    def __len__(self):
        return len(self.images)

    def load_image(self, i):
        return self.images[i]

    def captions(self, i):
        return ["a dog runs in park", "a red bike"]


def test_generate_captions_equal(vocab, models, images, jax_tokens):
    w2i, i2w = vocab
    fn = make_caption_fn(models[1], w2i[SPECIAL.start], max_length=MAX_LEN,
                         end_id=w2i[SPECIAL.end])
    hypos, refs = generate_captions(fn, _Dataset(images), w2i, i2w,
                                    batch_size=4, device="cpu")
    assert hypos == [ids_to_caption(r, i2w) for r in jax_tokens]
    assert refs == [["a dog runs in park", "a red bike"]] * N_IMAGES


def test_cli_from_npz(vocab, models, images, tmp_path, capsys):
    """The CLI (bf16 encoder, its default) on an .npz of the JAX trees ==
    the port's pipeline on the same trees loaded in memory."""
    w2i, i2w = vocab
    _, _, trainable, frozen, _ = models
    save_npz(str(tmp_path / "params.npz"), trainable, frozen)
    np.save(tmp_path / "images.npy", images)
    with open(tmp_path / "w2i.pkl", "wb") as f:
        pickle.dump(w2i, f)
    capsys.readouterr()
    cli.main(["caption", "--images", str(tmp_path / "images.npy"),
              "--weights", str(tmp_path / "params.npz"),
              "--vocab", str(tmp_path / "w2i.pkl"), "--device", "cpu",
              "--resnet-layers", "1,1,1,1", "--image-size", str(HW),
              "--max-length", str(MAX_LEN), "--batch-buckets", "4"])
    lines = capsys.readouterr().out.splitlines()
    cap = build_captioner("base-soft", len(w2i), ConfigTrain(),
                          resnet_layers=LAYERS)
    assert cap.encoder.backbone.conv1.weight.dtype == torch.bfloat16
    params_from_jax(cap, trainable, frozen)
    pipe = CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                           batch_buckets=(4,), image_hw=(HW, HW))
    assert lines == pipe(list(images))


def test_other_kinds_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_captioner("depth-soft", 20, resnet_layers=LAYERS)


_NO_JAX = r"""
import importlib, pkgutil, sys
import depth_image_captioning_pub_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from depth_image_captioning_pub_torch import cli
from depth_image_captioning_pub_torch.ops.kernels import decode_seq
cli.main(["caption", "--random", "3", "--device", "cpu", "--vocab-size",
          "30", "--resnet-layers", "1,1,1,1", "--image-size", "64",
          "--max-length", "5", "--batch-buckets", "2"])
assert decode_seq.LAUNCHES == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "PIL"))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "NO_JAX_OK" and len(lines) == 4
