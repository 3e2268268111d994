"""The train-time feature cache (``engine/feature_cache.py``) against the
JAX package's (``engine/feature_cache.py``), and cached training against
online training in the port.

* Format: fed the same features (the JAX encoder's, f32), the port's
  memmap is byte-for-byte the JAX ``FeatureCache``'s file, and the
  sidecars hold the same shape, dtype name and ``complete``; with each
  package's own f32 encoder on bridged weights the rows agree within
  1e-4 (the f32 encoders' bound, ``tests/test_torch_resnet.py``), read
  through the JAX reader.
* Staleness: a changed parameter, dtype or feature shape gives another
  digest and a rebuild; an incomplete, missing or damaged sidecar is a
  miss; a complete one is opened without a build.
* bf16: the grid round-trips bit for bit (2-byte words, tag
  ``"bfloat16"``), for the attention grid and NIC's pooled features.
* A step fed from the cache gets the cache's rows (bit-equal to the
  encoder's output on the batch's images at the build's batch size) in
  place of the images, which ``train.device_batch`` then leaves on the
  host.
* Cached training == online training in the port, bit for bit: ``train``
  of base-soft and nic (f32 encoders, dropout on, one intra-op thread)
  writes the same CSV rows and the same best-val files either way.
"""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from depth_image_captioning_pub_tpu.data.coco import CocoCaptions
from depth_image_captioning_pub_tpu.data.synthetic import make_synthetic_coco
from depth_image_captioning_pub_tpu.data.vocab import (
    build_vocab, captions_from_coco_json)
from depth_image_captioning_pub_tpu.engine import feature_cache as jfc
from depth_image_captioning_pub_tpu.models.captioner import (
    build_captioner as jax_build_captioner)
from depth_image_captioning_pub_torch.config import ConfigTrain
from depth_image_captioning_pub_torch.data.pipeline import train_batches
from depth_image_captioning_pub_torch.engine import feature_cache as tfc
from depth_image_captioning_pub_torch.engine import steps as tsteps
from depth_image_captioning_pub_torch.engine import train as ttrain
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.utils.jax_bridge import params_from_jax

LAYERS, HW, V, N = (1, 1, 1, 1), 64, 24, 7
ENC_TOL = 1e-4
GRID = (196, 2048)          # enc_img_size 14 at any input side


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    out = tmp_path_factory.mktemp("coco")
    img_dir, ann = make_synthetic_coco(str(out), num_images=N,
                                       image_hw=(HW, HW), seed=5)
    w2i, _ = build_vocab(captions_from_coco_json(ann), [], min_count=1)
    return CocoCaptions(img_dir, ann, image_size=(HW, HW)), w2i


@pytest.fixture(scope="module")
def caps():
    """(JAX captioner, its init, the port captioner on it), base-soft, f32
    encoders."""
    jcap = jax_build_captioner("base-soft", V, encoder_dtype=jnp.float32,
                               resnet_layers=LAYERS)
    init = jax.tree_util.tree_map(
        np.asarray, jcap.init(jax.random.PRNGKey(0), image_hw=(HW, HW)))
    cap = build_captioner("base-soft", V, encoder_dtype=torch.float32,
                          resnet_layers=LAYERS, device="cpu")
    params_from_jax(cap, *init)
    return jcap, init, cap


def _jax_cache(ds, jcap, init, root):
    enc = init[1]["encoder"]
    fn = jcap.cache_encode_fn()
    probe = jax.eval_shape(fn, enc, jnp.zeros((1, HW, HW, 3), jnp.uint8))
    jfc.build_or_open(root, "train", ds, fn, enc, probe.shape[1:],
                      probe.dtype, batch_size=4, quiet=True)
    digest = jfc.frozen_digest(enc, probe.dtype, probe.shape[1:])
    path = os.path.join(root, f"feat_train_{digest[:16]}.bin")
    return jfc.FeatureCache(path, len(ds), probe.shape[1:], probe.dtype,
                            digest)


def _port_cache(ds, cap, encode, root, dtype=torch.float32, shape=None):
    shape = shape or GRID
    tfc.build_or_open(root, "train", ds, encode, cap.encoder, shape, dtype,
                      "cpu", batch_size=4, quiet=True)
    digest = tfc.frozen_digest(cap.encoder, dtype, shape)
    return tfc.FeatureCache(os.path.join(root, f"feat_train_{digest[:16]}"
                                               f".bin"), len(ds), shape,
                            dtype, digest)


def test_bytes_match_jax_feature_cache(coco, caps, tmp_path):
    ds, _ = coco
    jcap, init, cap = caps
    jc = _jax_cache(ds, jcap, init, str(tmp_path / "jax"))
    jfn = jax.jit(jcap.cache_encode_fn())

    def jax_encode(images):     # the JAX encoder's features, as tensors
        return torch.from_numpy(np.array(jfn(init[1]["encoder"],
                                               jnp.asarray(images.numpy()))))
    same = _port_cache(ds, cap, jax_encode, str(tmp_path / "same"))
    with open(jc.path, "rb") as f, open(same.path, "rb") as g:
        assert f.read() == g.read()
    with open(jc.meta_path) as f, open(same.meta_path) as g:
        jmeta, tmeta = json.load(f), json.load(g)
    assert set(jmeta) == set(tmeta)
    for key in ("shape", "dtype", "complete"):
        assert jmeta[key] == tmeta[key], key
    own = _port_cache(ds, cap, lambda im: tsteps.frozen_features(cap, im),
                      str(tmp_path / "own"))
    read = jfc.FeatureCache(own.path, N, GRID, np.float32,
                            "").open()
    np.testing.assert_allclose(np.asarray(read), np.asarray(jc.open()),
                               rtol=0, atol=ENC_TOL)


def test_stale_or_incomplete_cache_rebuilds(coco, caps, tmp_path):
    ds, _ = coco
    _, _, cap = caps
    calls = []

    def encode(images):
        calls.append(len(images))
        return tsteps.frozen_features(cap, images)
    root = str(tmp_path)
    first = _port_cache(ds, cap, encode, root)
    assert calls == [4, 4] and first.exists()
    _port_cache(ds, cap, encode, root)
    assert len(calls) == 2                  # complete: opened, not built
    digests = {first.digest}
    weight = next(cap.encoder.parameters())
    saved = weight.detach().clone()
    with torch.no_grad():
        weight[(0,) * weight.dim()] += 1.0
    try:
        changed = _port_cache(ds, cap, encode, root)
    finally:
        with torch.no_grad():
            weight.copy_(saved)
    assert len(calls) == 4 and changed.path != first.path
    digests.add(changed.digest)
    digests.add(tfc.frozen_digest(cap.encoder, torch.bfloat16, GRID))
    digests.add(tfc.frozen_digest(cap.encoder, torch.float32, (1, 2048)))
    assert len(digests) == 4
    assert tfc.frozen_digest(cap.encoder, torch.float32, GRID) == \
        first.digest
    meta = json.load(open(first.meta_path))
    for bad in (dict(meta, complete=False), None, "{not json"):
        if bad is None:
            os.remove(first.meta_path)
        else:
            with open(first.meta_path, "w") as f:
                f.write(bad if isinstance(bad, str) else json.dumps(bad))
        assert not first.exists()
    _port_cache(ds, cap, encode, root)
    assert len(calls) == 6 and first.exists()


@pytest.mark.parametrize("kind", ["base-soft", "nic"])
def test_bf16_round_trip(coco, tmp_path, kind):
    ds, _ = coco
    cap = build_captioner(kind, V, resnet_layers=LAYERS, device="cpu")
    cap.init(torch.Generator().manual_seed(1))
    frozen = cap.backbone if kind == "nic" else cap.encoder
    want = tsteps.frozen_features(cap, torch.from_numpy(np.stack(
        [ds.load_image(i) for i in range(N)])))
    assert want.dtype == torch.bfloat16
    provider = tfc.build_or_open(
        str(tmp_path), "train", ds,
        lambda im: tsteps.frozen_features(cap, im), frozen,
        tuple(want.shape[1:]), torch.bfloat16, "cpu", batch_size=N,
        quiet=True)
    got = provider(np.array([3, 0, 6, 3]))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16),
                       want[[3, 0, 6, 3]].view(torch.int16))
    meta = json.load(open(next(
        os.path.join(tmp_path, f) for f in os.listdir(tmp_path)
        if f.endswith(".json"))))
    assert meta["dtype"] == "bfloat16"


def _train(kind, coco, root, feature_cache):
    ds, w2i = coco
    cfg = ConfigTrain()
    cfg.batch_size, cfg.max_caption_len, cfg.lr = 3, 10, 1e-3
    for field in ("save_directory_soft", "save_directory_nic"):
        setattr(cfg, field, os.path.join(root, field))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ttrain.train(kind, 0, cfg=cfg, datasets=(ds, ds), word_to_id=w2i,
                     num_epochs=2, quiet=True, resnet_layers=LAYERS,
                     device="cpu", feature_cache=feature_cache)
    finally:
        torch.set_num_threads(threads)
    out = cfg.save_dir(ttrain._save_dir_kind(kind), False)
    files = {}
    for name in sorted(os.listdir(out)):
        path = os.path.join(out, name)
        if name.endswith((".csv", ".msgpack")):
            with open(path, "rb") as f:
                files[name] = f.read()
    return files, out


def test_device_batch_sends_features_in_place_of_images(coco, caps,
                                                        tmp_path):
    ds, w2i = coco
    cap = caps[2]
    provider = tfc.build_or_open(
        str(tmp_path), "train", ds,
        lambda images: tsteps.frozen_features(cap, images), cap.encoder,
        GRID, torch.float32, "cpu", batch_size=4, quiet=True)
    batch = next(train_batches(ds, w2i, 4, 10, shuffle=False, seed=0))
    online, none = ttrain.device_batch(cap, batch)
    cached, feats = ttrain.device_batch(cap, batch,
                                        feature_provider=provider)
    assert none is None and "images" in online
    assert sorted(cached) == sorted(set(online) - {"images"})
    for name, t in cached.items():
        assert torch.equal(t, online[name]), name
    assert torch.equal(feats, tsteps.frozen_features(cap, online["images"]))


@pytest.mark.parametrize("kind", ["base-soft", "nic"])
def test_cached_training_equals_online_bit_for_bit(coco, tmp_path, kind):
    online, _ = _train(kind, coco, str(tmp_path / "online"), False)
    cached, out = _train(kind, coco, str(tmp_path / "cached"), True)
    assert sorted(online) == sorted(cached)
    assert any(n.endswith(".msgpack") for n in online)
    for name in online:
        assert cached[name] == online[name], name
    built = sorted(os.listdir(os.path.join(out, "feat_cache")))
    assert [n.split("_")[1] for n in built if n.endswith(".bin")] == \
        ["train", "val"]
