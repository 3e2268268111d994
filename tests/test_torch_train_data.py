"""The training slice's data and records: the port == the JAX package.

* ``train_batches`` yields the JAX package's batches, array for array,
  over 3 seeds x 2 epochs, shuffled, with and without ``pad_to`` (and
  captions cut to ``max_len``); ``make_train_batch``, ``pad_captions``,
  ``generate_subset``, ``batched_indices`` and ``tokenize_caption`` too;
* ``data/synthetic.py``: the same seed writes the JAX package's files, and
  ``SyntheticCaptions`` draws the same captions in memory;
* a depth-map cache written by either package reads identically in the
  other (the f16 ``.npy`` + ``.json`` layout), and the online provider's
  maps are ordinary tensors that autograd may read;
* the CSV and JSONL rows are the JAX package's.
"""

import json
import random

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from depth_image_captioning_pub_tpu.data import pipeline as jpipeline
from depth_image_captioning_pub_tpu.data import synthetic as jsynthetic
from depth_image_captioning_pub_tpu.data import tokenizer as jtokenizer
from depth_image_captioning_pub_tpu.engine import depth_cache as jcache
from depth_image_captioning_pub_tpu.utils import logging as jlogging
from depth_image_captioning_pub_torch.data import pipeline as tpipeline
from depth_image_captioning_pub_torch.data import synthetic as tsynthetic
from depth_image_captioning_pub_torch.data import tokenizer as ttokenizer
from depth_image_captioning_pub_torch.engine import depth_cache as tcache
from depth_image_captioning_pub_torch.utils import logging as tlogging


@pytest.fixture(scope="module")
def dataset():
    ds = tsynthetic.SyntheticCaptions(11, image_hw=(8, 8), seed=3)
    words = tsynthetic.synthetic_words()[:20]     # the rest are <unk>
    words += ["<start>", "<end>", "<unk>", "<null>"]
    return ds, {w: i for i, w in enumerate(words)}


@pytest.mark.parametrize("pad_to", [None, 8])
@pytest.mark.parametrize("seed", [0, 1, 123])
def test_train_batches_equal_jax(dataset, seed, pad_to):
    ds, w2i = dataset
    for epoch in (0, 1):
        for shuffle in (True, False):
            kw = dict(shuffle=shuffle, seed=seed, epoch=epoch, pad_to=pad_to)
            got = list(tpipeline.train_batches(ds, w2i, 4, 7, **kw))
            want = list(jpipeline.train_batches(ds, w2i, 4, 7, **kw))
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                assert g._fields == w._fields
                for name in w._fields:
                    a, b = getattr(g, name), getattr(w, name)
                    assert a.dtype == b.dtype, name
                    np.testing.assert_array_equal(a, b, err_msg=name)
    # the epoch moves the order, the seed moves the order
    first = [b.indices.tolist() for b in tpipeline.train_batches(
        ds, w2i, 4, 7, shuffle=True, seed=seed, epoch=0)]
    again = [b.indices.tolist() for b in tpipeline.train_batches(
        ds, w2i, 4, 7, shuffle=True, seed=seed, epoch=1)]
    assert first != again


def test_batch_helpers_equal_jax(dataset):
    ds, w2i = dataset
    toks = [list(range(12)), [1, 2], list(range(5))]
    for max_len in (4, 12):
        for g, w in zip(tpipeline.pad_captions(toks, 23, max_len),
                        jpipeline.pad_captions(toks, 23, max_len)):
            np.testing.assert_array_equal(g, w)
    imgs = [ds.load_image(i) for i in (4, 2, 9)]
    caps = [ds.captions(i) for i in (4, 2, 9)]
    got = tpipeline.make_train_batch(imgs, caps, w2i, 6, random.Random(5),
                                     batch_size=5, indices=[4, 2, 9])
    want = jpipeline.make_train_batch(imgs, caps, w2i, 6, random.Random(5),
                                      batch_size=5, indices=[4, 2, 9])
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert got.pad_mask.tolist() == [True] * 3 + [False] * 2
    assert tpipeline.generate_subset(ds, 0.3, 7) == \
        jpipeline.generate_subset(ds, 0.3, 7)
    assert tpipeline.batched_indices(11, 4, True, random.Random(2)) == \
        jpipeline.batched_indices(11, 4, True, random.Random(2))
    assert tpipeline.batched_indices(11, 4) == \
        jpipeline.batched_indices(11, 4, False)
    for cap in ("A dog. , runs, in the PARK.", "zebra", ""):
        assert ttokenizer.tokenize_caption(cap, w2i) == \
            jtokenizer.tokenize_caption(cap, w2i)


def test_synthetic_copy_equals_jax(tmp_path):
    for pkg, mod in (("t", tsynthetic), ("j", jsynthetic)):
        mod.make_synthetic_coco(str(tmp_path / pkg), num_images=3,
                                image_hw=(16, 24), seed=4, split="val2014")
    names = sorted(p.name for p in (tmp_path / "j" / "val2014").iterdir())
    assert names == sorted(p.name for p in
                           (tmp_path / "t" / "val2014").iterdir())
    for rel in ["captions_val2014.json"] + [f"val2014/{n}" for n in names]:
        assert (tmp_path / "t" / rel).read_bytes() == \
            (tmp_path / "j" / rel).read_bytes(), rel
    np.testing.assert_array_equal(
        tsynthetic.synthetic_image_batch(2, (5, 6), seed=1),
        jsynthetic.synthetic_image_batch(2, (5, 6), seed=1))
    ann = json.loads((tmp_path / "j" / "captions_val2014.json").read_text())
    ds = tsynthetic.SyntheticCaptions(3, image_hw=(16, 24), seed=4)
    want = [a["caption"] for a in ann["annotations"]]
    assert [c for i in range(len(ds)) for c in ds.captions(i)] == want
    assert ds.load_image(2).shape == (16, 24, 3)
    assert ds.load_image(2).dtype == np.uint8


class _Images:
    """A dataset of seeded uint8 images (the caches read load_image)."""

    def __init__(self, n):
        self.images = np.random.default_rng(0).integers(
            0, 256, (n, 12, 12, 3), dtype=np.uint8)

    def __len__(self):
        return len(self.images)

    def load_image(self, i):
        return self.images[i]


def _maps(images, xp=np):
    """A made-up depth function of uint8 images: [B, 224, 224, 1], in
    numpy or (``xp=jnp``) traceable by the JAX cache's ``jax.jit``."""
    x = images.astype(xp.float32).mean(axis=(1, 2, 3)) / 255.0
    grid = xp.linspace(0.0, 1.0, 224, dtype=xp.float32)
    return (x[:, None, None] * grid[None, :, None]
            + grid[None, None, :] / 3.0)[..., None]


def test_depth_cache_reads_across_packages(tmp_path):
    ds = _Images(7)
    want = _maps(ds.images).astype(np.float16).astype(np.float32)
    tpath, jpath = str(tmp_path / "t.npy"), str(tmp_path / "j.npy")
    port = tcache.DepthMapCache(tpath, len(ds))
    assert not port.exists()
    seconds = port.build(ds, lambda x: torch.from_numpy(_maps(x.numpy())),
                         "cpu", batch_size=3, quiet=True)
    assert seconds >= 0.0
    jax_cache = jcache.DepthMapCache(jpath, len(ds))
    jax_cache.build(ds, lambda v, x: _maps(x, jnp),
                    None, batch_size=3, quiet=True)
    idx = np.array([6, 0, 3, 3])
    for path in (tpath, jpath):
        assert tcache.DepthMapCache(path, len(ds)).exists()
        assert jcache.DepthMapCache(path, len(ds)).exists()
        assert not tcache.DepthMapCache(path, len(ds) + 1).exists()
        got = tcache.cached_depth_provider(
            tcache.DepthMapCache(path, len(ds)))(None, idx)
        other = jcache.cached_depth_provider(
            jcache.DepthMapCache(path, len(ds)))(None, idx)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, other)
        # XLA rounds a few of the made-up maps to the next f16
        np.testing.assert_allclose(got, want[idx], rtol=2 ** -10, atol=0)
    np.testing.assert_array_equal(np.load(tpath), want.astype(np.float16))
    assert open(tpath + ".json").read() == open(jpath + ".json").read()


def test_online_depth_provider_gives_trainable_input():
    """The maps come out of inference mode, so a train step's depth
    encoder may save them for its backward."""
    def depth_fn(images):
        with torch.inference_mode():
            return images.float().mean(dim=-1, keepdim=True) / 255.0
    provider = tcache.online_depth_provider(depth_fn, "cpu")
    images = np.random.default_rng(1).integers(0, 256, (2, 4, 4, 3),
                                               dtype=np.uint8)
    maps = provider(images, None)
    assert not maps.is_inference()
    w = torch.ones((), requires_grad=True)
    (maps * w).sum().backward()
    assert w.grad is not None


def test_logs_equal_jax(tmp_path):
    rows = [(0, 3.25), (1, 2.5000001), (2, float("nan"))]
    for pkg, mod in (("t", tlogging), ("j", jlogging)):
        csv = mod.CsvLossLog(str(tmp_path / pkg / "sub" / "loss.csv"))
        jl = mod.JsonlLog(str(tmp_path / pkg / "m.jsonl"))
        for epoch, loss in rows:
            csv.append(epoch, loss)
            jl.append({"epoch": epoch, "train_loss": loss, "val_loss": 1.0,
                       "epoch_seconds": 0.5, "temp": 1.0})
    assert (tmp_path / "t" / "sub" / "loss.csv").read_text() == \
        (tmp_path / "j" / "sub" / "loss.csv").read_text() == \
        "0, 3.25\n1, 2.5000001\n2, nan\n"
    got = [json.loads(x) for x in
           (tmp_path / "t" / "m.jsonl").read_text().splitlines()]
    want = [json.loads(x) for x in
            (tmp_path / "j" / "m.jsonl").read_text().splitlines()]
    assert [sorted(g) for g in got] == [sorted(w) for w in want]
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "time"} == \
            {k: v for k, v in w.items() if k != "time"}
    meter = tlogging.ProgressMeter(window=2, quiet=True)
    for loss in (1.0, 2.0, 4.0):
        meter.update(loss)
    assert meter.moving_avg == 3.0 and meter.count == 3
