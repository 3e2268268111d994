"""Cached training in both packages: the port's ``train(feature_cache=
True)`` == the JAX package's ``train(feature_cache=True)`` on base-soft,
at the set-up and bounds of ``tests/test_torch_train_loop.py``
(8 synthetic 64x64 images, batch 4, 2 epochs, dropout 0, one JAX init, f32
encoders, the JAX mesh cut to one device): the CSV losses within 1e-5,
the best-val files' leaves within the step bounds, the frozen encoder
bit for bit. Each package trains from its own cache of its own encoder's
features (the f32 encoders agree within 1e-4), under
``<save dir>/feat_cache`` for the train and the val split.
"""

import functools
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from depth_image_captioning_pub_tpu.engine import train as jtrain
from depth_image_captioning_pub_tpu.models.captioner import (
    build_captioner as jax_build_captioner)
from depth_image_captioning_pub_tpu.parallel.mesh import make_mesh
from depth_image_captioning_pub_torch.engine import train as ttrain
from depth_image_captioning_pub_torch.models.captioner import build_captioner

from test_torch_train_loop import (
    EPOCHS, LAYERS, STEPS_PER_EPOCH, StepSpy, check_run, coco, configs)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

__all__ = ["coco"]      # the module-scoped dataset fixture


@pytest.mark.parametrize("kind", ["base-soft"])
def test_cached_training_matches_jax(kind, coco, tmp_path, monkeypatch):
    ds, w2i = coco
    jcfg, tcfg = configs(str(tmp_path))
    monkeypatch.setattr(jtrain, "make_mesh",
                        lambda: make_mesh(jax.devices()[:1]))
    monkeypatch.setattr(jtrain, "build_captioner", functools.partial(
        jax_build_captioner, encoder_dtype=jnp.float32))
    monkeypatch.setattr(ttrain, "build_captioner", functools.partial(
        build_captioner, encoder_dtype=torch.float32))
    spy = StepSpy(monkeypatch)
    kw = dict(ext=0, use_data="coco", datasets=(ds, ds), word_to_id=w2i,
              num_epochs=EPOCHS, quiet=True, resnet_layers=LAYERS,
              feature_cache=True)
    jtrain.train(kind, cfg=jcfg, **kw)
    jcap = jax_build_captioner(kind, len(w2i), jcfg,
                               encoder_dtype=jnp.float32,
                               resnet_layers=LAYERS)
    initial = jax.tree_util.tree_map(
        np.asarray, jcap.init(jax.random.PRNGKey(jcfg.seed)))
    ttrain.train(kind, cfg=tcfg, device="cpu", initial=initial, **kw)
    assert spy.steps == EPOCHS * STEPS_PER_EPOCH
    tdir = check_run(kind, jcfg, tcfg, spy)
    built = sorted(n for n in os.listdir(os.path.join(tdir, "feat_cache"))
                   if n.endswith(".bin"))
    assert [n.split("_")[1] for n in built] == ["train", "val"]
