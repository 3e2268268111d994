"""The trainer end to end: the port's ``engine/train.train`` == the JAX
package's ``train`` on base-soft (``tests/test_torch_train_loop_depth.py``:
depth-soft), and the hard kinds' seeding.

``make_synthetic_coco`` writes 8 images (64x64) with five captions each;
both trainers read them through one ``CocoCaptions`` for 2 epochs of 2
steps (batch 4) and a validation pass each, with ``dropout=0`` and soft
attention, so no noise enters (the two packages' generators differ). Both
start from one JAX init (``initial=``), with f32 encoders (the JAX
trainer's ``build_captioner`` is given ``encoder_dtype=float32``, and so
is the port's) on one device (the JAX mesh is cut to one CPU device, so
neither pads its batches). Held: the per-epoch train and val losses of
the CSV files within 1e-5; the same best-val file names; every leaf of
the port's best-val files within the bounds of ``tests/
test_torch_train_steps.py`` of the JAX files' (its small-gradient room
counted over the run's steps); the port's set read back by both
packages' ``load_eval_components``.
"""

import functools
import glob
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from depth_image_captioning_pub_tpu import cli as jcli
from depth_image_captioning_pub_tpu.config import ConfigEval as JaxConfigEval
from depth_image_captioning_pub_tpu.config import ConfigTrain as JaxConfig
from depth_image_captioning_pub_tpu.data.coco import CocoCaptions
from depth_image_captioning_pub_tpu.data.synthetic import make_synthetic_coco
from depth_image_captioning_pub_tpu.data.vocab import (
    build_vocab, captions_from_coco_json)
from depth_image_captioning_pub_tpu.engine import train as jtrain
from depth_image_captioning_pub_tpu.models.captioner import (
    build_captioner as jax_build_captioner)
from depth_image_captioning_pub_tpu.parallel.mesh import make_mesh
from depth_image_captioning_pub_torch import cli as tcli
from depth_image_captioning_pub_torch.config import ConfigEval, ConfigTrain
from depth_image_captioning_pub_torch.engine import steps as tsteps
from depth_image_captioning_pub_torch.engine import train as ttrain
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.utils.checkpoint import load_component
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    flatten_tree, params_to_jax)

from test_torch_train_steps import SMALL_GRAD

LAYERS, HW, LR = (1, 1, 1, 1), 64, 1e-3
EPOCHS, STEPS_PER_EPOCH = 2, 2
LOSS_TOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-3, 2e-5


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    out = tmp_path_factory.mktemp("coco")
    img_dir, ann = make_synthetic_coco(str(out), num_images=8,
                                       image_hw=(HW, HW), seed=2)
    w2i, _ = build_vocab(captions_from_coco_json(ann), [], min_count=1)
    return CocoCaptions(img_dir, ann, image_size=(HW, HW)), w2i


def configs(root, dropout=0.0):
    """(JAX, port) ConfigTrain with one training set-up and save dirs of
    their own under ``root``."""
    out = []
    for cls, sub in ((JaxConfig, "jax"), (ConfigTrain, "port")):
        cfg = cls()
        cfg.batch_size, cfg.max_caption_len, cfg.dropout = 4, 10, dropout
        cfg.lr, cfg.moving_avg = LR, 10
        for field in ("save_directory_soft", "save_directory_hard",
                      "save_directory_Cdep_soft", "save_directory_Cdep_hard",
                      "save_directory_nic"):
            setattr(cfg, field, os.path.join(root, sub, field))
        out.append(cfg)
    return out


def read_csv(path):
    with open(path) as f:
        rows = [line.split(", ") for line in f.read().splitlines()]
    return [(int(e), float(v)) for e, v in rows]


class StepSpy:
    """Wraps the port's attention train step: counts, per element, the
    steps with a gradient below ``SMALL_GRAD`` (the step tests' room)."""

    def __init__(self, monkeypatch):
        self.counts, self.steps = None, 0
        real = tsteps.attention_train_step

        def spy(cap, opt, batch, **kw):
            out = real(cap, opt, batch, **kw)
            params = cap.trainable_parameters()
            self.counts = self.counts or [torch.zeros_like(p)
                                          for p in params]
            for c, p in zip(self.counts, params):
                c += (p.grad.abs() < SMALL_GRAD).float()
            self.cap, self.steps = cap, self.steps + 1
            return out
        monkeypatch.setattr(ttrain, "attention_train_step", spy)

    def room(self):
        """The counts as the JAX trees' flat leaves."""
        holder = build_captioner(self.cap.spec.kind, self.cap.decoder
                                 .vocab_size, resnet_layers=LAYERS,
                                 device="cpu")
        with torch.no_grad():
            for h, c in zip(holder.trainable_parameters(), self.counts):
                h.copy_(c)
        return flatten_tree(params_to_jax(holder)[0])


def run_both(kind, coco, tmp_path, monkeypatch, depth_provider=None):
    """Train ``kind`` with both packages; returns (jax cfg, port cfg,
    jax captioner, spy)."""
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
              depth_provider=depth_provider)
    jtrain.train(kind, cfg=jcfg, **kw)
    jcap = jax_build_captioner(kind, len(w2i), jcfg,
                               encoder_dtype=jnp.float32,
                               resnet_layers=LAYERS)
    initial = jax.tree_util.tree_map(
        np.asarray, jcap.init(jax.random.PRNGKey(jcfg.seed)))
    ttrain.train(kind, cfg=tcfg, device="cpu", initial=initial, **kw)
    assert spy.steps == EPOCHS * STEPS_PER_EPOCH
    return jcfg, tcfg, jcap, spy


def check_run(kind, jcfg, tcfg, spy, within_steps=None, loss_tol=LOSS_TOL):
    """CSV losses (rtol/atol ``loss_tol``), file names, and the best-val
    leaves (``within_steps``: (every leaf within 2 * lr * steps,
    statistics rtol) instead of the step bounds)."""
    sub = ttrain._save_dir_kind(kind)
    jdir, tdir = jcfg.save_dir(sub, False), tcfg.save_dir(sub, False)
    prefix = ttrain._KIND_PREFIX[kind]
    for split in ("train", "val"):
        name = f"{prefix}_{split}_loss_coco0.csv"
        got, want = (read_csv(os.path.join(d, name)) for d in (tdir, jdir))
        assert [e for e, _ in got] == [e for e, _ in want] == [0, 1]
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in want], rtol=loss_tol,
                                   atol=loss_tol, err_msg=split)
    names = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(jdir, "*.msgpack")))
    assert names == sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(tdir, "*.msgpack")))
    assert f"{prefix}_decoder_best_coco0.pth.msgpack" in names
    room = spy.room()
    for name in names:
        got = flatten_tree(load_component(os.path.join(tdir, name)))
        want = flatten_tree(load_component(os.path.join(jdir, name)))
        assert set(got) == set(want), name
        component = name.split("_best")[0][len(prefix) + 1:]
        for leaf, w in want.items():
            g = got[leaf]
            if component == "encoder":           # frozen: bit for bit
                np.testing.assert_array_equal(g, w)
                continue
            if within_steps is not None:
                stats = leaf.startswith("batch_stats")
                bound = (within_steps[1] * np.abs(w).max() if stats
                         else 2 * LR * spy.steps)
                assert np.abs(g - w).max() <= bound, (name, leaf)
                continue
            if leaf.startswith("batch_stats/"):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
                continue
            key = {"decoder": f"decoder/{leaf}",
                   "enc_linear": f"enc_linear/{leaf}",
                   "D_encoder": "depth_encoder/" + leaf.split("/", 1)[-1]}
            tol = (PARAM_ATOL + PARAM_RTOL * np.abs(w)
                   + 2 * LR * room[key[component]])
            assert (np.abs(g - w) <= tol).all(), (name, leaf)
    return tdir


def check_loaders(kind, tdir, jcfg, jcap, w2i):
    """Both packages' ``load_eval_components`` read the port's set 1."""
    tcfg = ConfigEval()
    depth = kind.startswith("depth")
    _, tables = tcli.eval_tables(tcfg, kind.split("-")[1], False, depth)
    files = tables[1]
    cap = build_captioner(kind, len(w2i), resnet_layers=LAYERS,
                          device="cpu")
    enc, params, stats = tcli.load_eval_components(tdir, files, cap)
    jenc, jparams, jstats = jcli.load_eval_components(
        tdir, files, jcap, image_hw=(HW, HW))
    for a, b in ((enc, jenc), (params, jparams), (stats, jstats)):
        fa, fb = flatten_tree(a), flatten_tree(_np(b))
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(np.asarray(fa[k], np.float32),
                                          np.asarray(fb[k], np.float32))
    assert JaxConfigEval().depth_soft_parameter_files == \
        tcfg.depth_soft_parameter_files


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_train_base_soft_matches_jax(coco, tmp_path, monkeypatch):
    jcfg, tcfg, jcap, spy = run_both("base-soft", coco, tmp_path,
                                     monkeypatch)
    tdir = check_run("base-soft", jcfg, tcfg, spy)
    check_loaders("base-soft", tdir, jcfg, jcap, coco[1])
    jsonl = os.path.join(tdir, "base_soft_metrics_coco0.jsonl")
    with open(jsonl) as f:
        rows = [json.loads(x) for x in f]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert set(rows[0]) == {"epoch", "train_loss", "val_loss",
                            "epoch_seconds", "temp", "time"}


@pytest.mark.parametrize("kind", ["base-hard", "mdepth-hard"])
def test_hard_kinds_repeat_per_seed(kind, coco, tmp_path):
    """The port alone (JAX's Gumbel draws cannot be reproduced): the same
    seed writes the same CSV losses, another seed (``cfg.seed``) other
    ones, and the JSONL records the temperature schedule."""
    ds, w2i = coco
    depth = None
    if kind.startswith("mdepth"):
        def depth(images, indices):
            rng = np.random.default_rng(np.asarray(indices))
            return rng.random((len(indices), 224, 224, 1), np.float32)

    def run(seed, tag):
        _, cfg = configs(str(tmp_path / tag))
        cfg.seed, cfg.temp_sch = seed, 1
        ttrain.train(kind, 0, cfg=cfg, datasets=(ds, ds), word_to_id=w2i,
                     num_epochs=2, quiet=True, resnet_layers=LAYERS,
                     device="cpu", depth_provider=depth)
        d = cfg.save_dir(ttrain._save_dir_kind(kind), False)
        prefix = ttrain._KIND_PREFIX[kind]
        rows = [read_csv(os.path.join(d, f"{prefix}_{s}_loss_coco0.csv"))
                for s in ("train", "val")]
        with open(os.path.join(d, f"{prefix}_metrics_coco0.jsonl")) as f:
            temps = [json.loads(x)["temp"] for x in f]
        return rows, temps
    a, temps = run(5, "a")
    assert run(5, "b")[0] == a
    assert run(6, "c")[0] != a
    assert temps == [1.0, float(np.float32(ttrain.gumbel_temperature(1, 1)))]
    assert temps[1] < 1.0


def test_gumbel_temperature_and_names_equal_jax():
    for epoch in (0, 9, 10, 15, 200, 350):
        for sch in (1, 10):
            assert ttrain.gumbel_temperature(epoch, sch) == \
                jtrain.gumbel_temperature(epoch, sch)
    for kind in ttrain._KIND_PREFIX:
        assert ttrain._save_dir_kind(kind) == jtrain._save_dir_kind(kind)
        assert ttrain._KIND_PREFIX[kind] == jtrain._KIND_PREFIX[kind]


def test_train_refuses_unported_options(coco):
    ds, w2i = coco
    kw = dict(datasets=(ds, ds), word_to_id=w2i, num_epochs=1, quiet=True,
              resnet_layers=LAYERS, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 7.2"):
        ttrain.train("base-soft", 0, **kw, feature_cache=True)
    for field, value, item in (("grad_accum", 2, "7.3"),
                               ("decoder_dtype", "bfloat16", "7.4"),
                               ("profile_dir", "x", "7.5")):
        cfg = ConfigTrain()
        setattr(cfg, field, value)
        with pytest.raises(NotImplementedError,
                           match=f"Queue A item {item}"):
            ttrain.train("base-soft", 0, cfg=cfg, **kw)
    with pytest.raises(ValueError, match="depth_provider"):
        ttrain.train("depth-soft", 0, **kw)
