"""Data-parallel training (``parallel/`` behind ``engine/train.train``), on
the CPU with gloo ranks (``tests/torch_parallel_child.py``):

* two ranks against the JAX ``train`` on its 8 virtual devices: base-soft
  and depth-soft, 16 synthetic COCO images at batch 8 (8 rows on 8
  devices and on 2 ranks: no pad row), dropout 0, one JAX init, f32
  encoders, 2 epochs; the CSV losses and the best-val files within the
  bounds of ``tests/test_torch_train_loop.py`` and ``tests/
  test_torch_train_loop_depth.py``;
* two ranks against one: base-soft and depth-soft (the depth CNN's
  BatchNorms on the global batch's statistics), with 1 and 2 microbatches
  a step, and base-hard (its Gumbel-softmax region noise), dropout 0.5
  (each rank keeps its rows of the global draws), 2 epochs of 2 steps at
  batch 4 (ResNet blocks 1,1,1,1 at 64x64, f32 encoders): every step's
  global loss within 1e-5; the BN running statistics after the first step
  within 1e-6 (later steps average batch means of conv kernels that
  rounding parted by up to lr, as ``tests/test_torch_train_loop_depth.py``
  bounds them: 5e-2 of their largest value); after step 1, every trained
  element within 2 * lr where the two runs' gradients differ in sign or
  either is below 1e-6, else 1e-5; at the end, within the AdamW rule of
  ``tests/test_torch_train_steps.py`` (2 * lr for each step at which an
  element's summed gradient was below 1e-6, else 1e-5), except the
  depth-soft tensors of ``DEPTH_SPREAD``, within 2 * lr a step; both
  ranks' parameters equal;
* one rank in a process group is bit-equal to the plain trainer (losses,
  parameters, BN statistics) at 1 and 2 microbatches;
* two ranks preempted after step 3 (the event set on rank 1 alone) and
  resumed: the CSV rows and the final state equal the straight two-rank
  run's, and rank 1 wrote no file.
"""

import csv
import glob
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from depth_image_captioning_pub_tpu.data.synthetic import make_synthetic_coco
from depth_image_captioning_pub_tpu.data.vocab import (
    build_vocab, captions_from_coco_json)
from depth_image_captioning_pub_tpu.engine import train as jtrain
from depth_image_captioning_pub_tpu.models.captioner import (
    build_captioner as jax_build_captioner)
from depth_image_captioning_pub_torch.models.captioner import build_captioner

import torch_parallel_child as child
from test_torch_train_loop import StepSpy, check_run, configs
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

CASES = [["base-soft", 1], ["base-soft", 2], ["base-hard", 1],
         ["depth-soft", 1], ["depth-soft", 2]]
LR = 1e-3
# Trained tensors of depth-soft that part from one rank by more than the
# step rule after step 1 (measured on a CPU: the depth CNN's, up to 3.1e-3
# over 4 steps, and the decoder's that read its features, up to 1.1e-3):
# an element of the depth CNN that rounding sends lr the other way at one
# step changes the features that every later gradient reads. At the end
# they are held within 2 * lr a step, the bound of
# ``tests/test_torch_train_loop_depth.py``; after step 1 by the rule.
DEPTH_SPREAD = ("depth_module.", "decoder.att_w_enc", "decoder.att_b_enc",
                "decoder.att_w_dec", "decoder.att_b_dec",
                "decoder.lstm_w_ih", "decoder.init_w")
# the JAX parity runs: batch 8 pads to 8 rows on the JAX package's 8
# virtual devices and on 2 ranks alike, so no pad row enters BatchNorm
JAX_KINDS, JAX_BATCH, JAX_IMAGES = ("base-soft", "depth-soft"), 8, 16


def _step_room(g, w):
    """The AdamW rule of ``tests/test_torch_train_steps.py`` for one step
    from equal parameters: 2 * lr where the two runs' gradients differ in
    sign or either is below ``SMALL_GRAD`` (AdamW's first step moves an
    element by lr in its gradient's sign), else 1e-5."""
    small = ((g.abs() < child.SMALL_GRAD) | (w.abs() < child.SMALL_GRAD)
             | (torch.sign(g) != torch.sign(w)))
    return torch.where(small, 2 * LR, 1e-5)


def _check_close(got, want, key):
    steps = len(want["losses"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=1e-5, err_msg=key)
    for name, w in want["bn"][0].items():
        torch.testing.assert_close(got["bn"][0][name], w, rtol=0, atol=1e-6,
                                   msg=f"{key} {name} after step 1")
    for name, w in want["state"].items():
        g = got["state"][name]
        if "running" in name:
            assert (g - w).abs().max() <= 5e-2 * w.abs().max(), (key, name)
    trained = [n for n in want["state"] if "running" not in n]
    assert len(trained) == len(want["small"]) == len(want["grad1"])
    for name, small, g1, w1 in zip(trained, want["small"], got["grad1"],
                                   want["grad1"]):
        # after step 1, from equal parameters
        over = ((got["state1"][name] - want["state1"][name]).abs()
                - _step_room(g1, w1)).max()
        assert over <= 0, (key, name, "step 1", float(over))
        g, w = got["state"][name], want["state"][name]
        if key.startswith("depth") and name.startswith(DEPTH_SPREAD):
            room = torch.full_like(w, 2 * LR * steps)
        else:
            room = torch.where(small > 0, 2 * LR * small.float(), 1e-5)
        over = ((g - w).abs() - room).max()
        assert over <= 0, (key, name, float(over))


GROUPED = [["base-soft", 1], ["depth-soft", 2]]


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """A synthetic COCO of 16 64x64 images, and its vocabulary."""
    out = tmp_path_factory.mktemp("coco")
    img_dir, ann = make_synthetic_coco(str(out), num_images=JAX_IMAGES,
                                       image_hw=(child.HW, child.HW), seed=2)
    w2i, _ = build_vocab(captions_from_coco_json(ann), [], min_count=1)
    return img_dir, ann, w2i


def _jax_cases(tmp, coco):
    """The two-rank port runs held to the JAX ``train``: one a kind, from
    the JAX init, with their configs (JAX, port)."""
    img_dir, ann, w2i = coco
    cases, cfgs = [], {}
    for kind in JAX_KINDS:
        jcfg, tcfg = configs(str(tmp / "jax" / kind))
        for cfg in (jcfg, tcfg):
            cfg.batch_size = JAX_BATCH
        jcap = jax_build_captioner(kind, len(w2i), jcfg,
                                   encoder_dtype=jnp.float32,
                                   resnet_layers=child.LAYERS)
        initial = str(tmp / f"init_{kind}.pt")
        torch.save(jax.tree_util.tree_map(
            np.asarray, jcap.init(jax.random.PRNGKey(jcfg.seed))), initial)
        cases.append([kind, 1, {
            "name": f"jax/{kind}", "root": str(tmp / "jax" / kind / "port"),
            "coco": {"images": img_dir, "annotations": ann, "words": w2i},
            "initial": initial, "batch": JAX_BATCH, "dropout": 0.0,
            "max_len": tcfg.max_caption_len}])
        cfgs[kind] = jcfg, tcfg
    return cases, cfgs


def _jax_train(kind, jcfg, coco):
    """The JAX ``train`` over its 8 virtual devices, f32 encoders."""
    from depth_image_captioning_pub_tpu.data.coco import CocoCaptions
    img_dir, ann, w2i = coco
    ds = CocoCaptions(img_dir, ann, image_size=(child.HW, child.HW))
    real = jtrain.build_captioner
    jtrain.build_captioner = lambda *a, **k: real(
        *a, **dict(k, encoder_dtype=jnp.float32))
    try:
        jtrain.train(kind, ext=0, use_data="coco", cfg=jcfg,
                     datasets=(ds, ds), word_to_id=w2i, num_epochs=2,
                     quiet=True, resnet_layers=child.LAYERS,
                     depth_provider=(child.gray_depth
                                     if kind.startswith("depth") else None))
    finally:
        jtrain.build_captioner = real


@pytest.fixture(scope="module")
def runs(tmp_path_factory, coco):
    """Every run of this file, started together: the two-rank cases, the
    two-rank runs held to JAX, a one-rank group on two of them, the
    two-rank resume, the plain trainer in a process of its own; the JAX
    trainer in this process meanwhile."""
    tmp = tmp_path_factory.mktemp("ranks")
    groups = {
        "two": child.start_ranks(tmp, 2, "train", root=str(tmp / "two"),
                                 cases=CASES),
        "grouped": child.start_ranks(tmp, 1, "train",
                                     root=str(tmp / "grouped"),
                                     cases=GROUPED),
        "resume": child.start_ranks(tmp, 2, "resume",
                                    root=str(tmp / "resume"),
                                    kind="depth-soft", preempt_at=3),
        "plain": child.start_ranks(tmp, 1, "train", plain=True,
                                   root=str(tmp / "plain"), cases=CASES)}
    jax_cases, cfgs = _jax_cases(tmp, coco)
    groups["two_jax"] = child.start_ranks(tmp, 2, "train",
                                          root=str(tmp / "two"),
                                          cases=jax_cases)
    for kind, (jcfg, _) in cfgs.items():
        _jax_train(kind, jcfg, coco)
    out = {name: child.wait_ranks(g) for name, g in groups.items()}
    out.update(plain=out["plain"][0], root=tmp, jax=cfgs)
    return out


def test_two_ranks_equal_one(runs):
    plain, two, grouped = runs["plain"], runs["two"], runs["grouped"][0]
    for key, want in plain.items():
        assert len(want["losses"]) == 4, key
        assert np.all(np.isfinite(want["losses"]))
        _check_close(two[0][key], want, key)
        for name, t in two[0][key]["state"].items():
            assert torch.equal(t, two[1][key]["state"][name]), (key, name)
        assert two[0][key]["losses"] == two[1][key]["losses"]
        assert two[0][key]["summary"]["train_rows"] == 16
    # a group of one rank runs its collectives and changes nothing
    for key, got in grouped.items():
        assert got["losses"] == plain[key]["losses"], key
        for name, t in plain[key]["state"].items():
            assert torch.equal(got["state"][name], t), (key, name)
    # the depth CNN's statistics moved, and dropout drew noise: the two
    # microbatch counts part
    assert plain["depth-soft/1"]["bn"][0]
    assert plain["base-soft/1"]["losses"] != plain["base-soft/2"]["losses"]


def test_two_ranks_equal_jax(runs, coco):
    """Two ranks' ``train`` == the JAX ``train`` on its 8 virtual devices,
    from one JAX init, dropout 0 (no noise enters): the bounds of
    ``tests/test_torch_train_loop.py`` (base-soft) and ``tests/
    test_torch_train_loop_depth.py`` (depth-soft) on the CSV losses and
    the best-val files."""
    for kind in JAX_KINDS:
        got = runs["two_jax"][0][f"jax/{kind}"]
        assert len(got["losses"]) == 2 * JAX_IMAGES // JAX_BATCH, kind
        jcfg, tcfg = runs["jax"][kind]
        spy = SimpleNamespace(
            counts=[c.float() for c in got["small"]], steps=len(
                got["losses"]), cap=build_captioner(
                    kind, len(coco[2]), resnet_layers=child.LAYERS,
                    device="cpu"))
        spy.room = lambda spy=spy: StepSpy.room(spy)
        if kind == "depth-soft":
            check_run(kind, jcfg, tcfg, spy, within_steps=(None, 5e-2),
                      loss_tol=2e-5)
        else:
            check_run(kind, jcfg, tcfg, spy)
    shutil.rmtree(runs["root"] / "jax", ignore_errors=True)


def _csv_rows(root):
    rows = {}
    for path in sorted(glob.glob(f"{root}/**/*.csv", recursive=True)):
        with open(path) as f:
            rows[os.path.basename(path)] = list(csv.reader(f))
    return rows


def test_two_ranks_resume(runs):
    root = runs["root"] / "resume"
    r0, r1 = runs["resume"]
    straight, first, resumed = (r0[k] for k in ("straight", "first",
                                                "resumed"))
    assert first["summary"].get("preempted") == 1.0
    assert first["losses"] == straight["losses"][:3]
    assert resumed["losses"] == straight["losses"][3:]
    for name, t in straight["state"].items():
        assert torch.equal(resumed["state"][name], t), name
    want, got = _csv_rows(root / "straight"), _csv_rows(root / "resumed")
    assert want and got == want
    assert r1["writes"] == []
    written = {os.path.basename(p) for p in r0["writes"]}
    assert any(n.startswith("state_") for n in written)
    assert any(n.endswith("_train_loss_coco0.csv") for n in written)
