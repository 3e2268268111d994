"""The training CLI (``python -m depth_image_captioning_pub_torch.training``,
the counterpart of ``base_main.py`` / ``depth_main.py``): its grammar, the
flags that once exited 2 as not ported (``--grad-accum``,
``--decoder-dtype``, ``--feature-cache``, ``--profile*``; now each reaches
``train``), the checkpoint flags, and runs on the CPU over a synthetic COCO in the
reference's layout (through the config's cwd-relative paths, ResNet
blocks 1,1,1,1 and the tests' tiny DPT from $DCAP_RESNET_LAYERS and
$DCAP_TINY_DPT):

* ``training depth soft cnn coco --device cpu --epochs 1 --exp-time 1``:
  the depth cache is built first (complete, the DPT's maps of every train
  image), then the run writes its CSV and JSONL rows and its best-val set,
  which ``evaluation depth soft score coco --device cpu --num-sets 1``
  scores;
* ``training base nic --resnet-weights <that run's encoder file>``: NIC's
  frozen backbone is the file's, bit for bit;
* ``training base soft coco --resnet-weights resnet.pth``: a torchvision
  ResNet state dict (the JAX tests' ``TorchTinyResNet``) through the
  bridge is the run's frozen encoder, bit for bit;
* a child ``training base soft coco --checkpoint-every 1`` killed with
  SIGTERM in its second epoch exits 0 with a checkpoint, and a child with
  ``--resume`` then writes the CSV rows of a straight child run.
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from depth_image_captioning_pub_tpu.data.vocab import (
    build_vocab, captions_from_coco_json, save_vocab)
from depth_image_captioning_pub_torch import evaluation, training
from depth_image_captioning_pub_torch.config import ConfigTrain
from depth_image_captioning_pub_torch.data.synthetic import (
    make_synthetic_coco)
from depth_image_captioning_pub_torch.engine import train as ttrain
from depth_image_captioning_pub_torch.utils.checkpoint import load_component
from depth_image_captioning_pub_torch.utils.jax_bridge import flatten_tree
from depth_image_captioning_pub_torch.utils.torch_bridge import (
    encoder_to_flax)

from test_bridge_numeric import TorchTinyResNet, _randomize_bn_stats
from torch_threads import one_thread  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("words", [[], ["base"], ["base", "soft"],
                                   ["base", "soft", "xyz"],
                                   ["base", "nic", "coco"],
                                   ["depth", "soft", "cnn"],
                                   ["depth", "soft", "vit", "coco"],
                                   ["nic"]])
def test_grammar_errors(words, capsys):
    if not words:
        with pytest.raises(SystemExit):
            training.main(words)
        return
    assert training.main(words) == 1
    assert "input training base" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--grad-accum", "2"],
                                   ["--decoder-dtype", "bfloat16"],
                                   ["--feature-cache"],
                                   ["--profile", "prof"],
                                   ["--profile-start", "1"],
                                   ["--profile-stop", "3"]])
def test_unported_flags_exit_2(flags, capsys, monkeypatch):
    """The flags that exited 2 before they were ported now reach ``train``
    (``cfg`` and ``feature_cache``) and the run exits 0."""
    seen = []

    def train(kind, **kw):
        cfg = kw["cfg"]
        seen.append({"--grad-accum": cfg.grad_accum,
                     "--decoder-dtype": cfg.decoder_dtype,
                     "--feature-cache": kw["feature_cache"],
                     "--profile": cfg.profile_dir,
                     "--profile-start": cfg.profile_start,
                     "--profile-stop": cfg.profile_stop})
        return {}
    monkeypatch.setattr(ttrain, "train", train)
    assert training.main(["base", "soft", "coco", "--exp-time", "1"]
                         + flags) == 0
    want = {"--grad-accum": 1, "--decoder-dtype": "float32",
            "--feature-cache": False, "--profile": None,
            "--profile-start": ConfigTrain.profile_start,
            "--profile-stop": ConfigTrain.profile_stop}
    want[flags[0]] = (True if len(flags) == 1 else
                      int(flags[1]) if flags[1].isdigit() else flags[1])
    assert seen == [want]
    assert "not ported" not in capsys.readouterr().err


@pytest.mark.parametrize("flags,want", [
    (["--checkpoint-every", "1"], {"checkpoint_every": 1, "resume": False,
                                   "keep": 0}),
    (["--checkpoint-keep", "2"], {"checkpoint_every": 0, "resume": False,
                                  "keep": 2}),
    (["--resume"], {"checkpoint_every": 0, "resume": True, "keep": 0})])
def test_checkpoint_flags_reach_train(flags, want, monkeypatch):
    seen = []

    def train(kind, **kw):
        seen.append({"checkpoint_every": kw["checkpoint_every"],
                     "resume": kw["resume"],
                     "keep": kw["cfg"].checkpoint_keep})
        return {}
    monkeypatch.setattr(ttrain, "train", train)
    assert training.main(["base", "soft", "coco", "--exp-time", "2"]
                         + flags) == 0
    assert seen == [want, want]


def test_preempted_run_stops_the_runs(monkeypatch):
    calls = []
    monkeypatch.setattr(ttrain, "train", lambda kind, **kw: calls.append(
        kw["ext"]) or {"preempted": 1.0})
    assert training.main(["base", "nic", "--exp-time", "3",
                          "--checkpoint-every", "1"]) == 0
    assert calls == [0]


def test_device_defaults_to_cuda():
    assert training.build_parser().parse_args(["base", "nic"]).device == \
        "cuda"


class SmallConfig(ConfigTrain):
    """``ConfigTrain`` at the tests' size: batches of 3, 12 tokens."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.batch_size, self.max_caption_len = 3, 12


@pytest.fixture()
def coco_cwd(tmp_path, monkeypatch):
    """A working directory in the reference's layout: 6 train and 4 val
    synthetic images, the vocabulary pickles, the eval subset index; the
    CLI's ``ConfigTrain`` at the tests' batch size."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(training, "ConfigTrain", SmallConfig)
    monkeypatch.setenv("DCAP_RESNET_LAYERS", "1,1,1,1")
    monkeypatch.setenv("DCAP_TINY_DPT", "1")
    monkeypatch.delenv("RESNET152_WEIGHTS", raising=False)
    monkeypatch.delenv("DPT_WEIGHTS", raising=False)
    root = tmp_path / "dataset" / "coco2014"
    _, tann = make_synthetic_coco(str(root), num_images=6,
                                  image_hw=(48, 64), seed=7)
    _, vann = make_synthetic_coco(str(root), num_images=4,
                                  image_hw=(48, 64), seed=8, split="val2014")
    w2i, i2w = build_vocab(captions_from_coco_json(tann),
                           captions_from_coco_json(vann), min_count=1)
    save_vocab(w2i, i2w, str(root / "word_to_id.pkl"),
               str(root / "id_to_word.pkl"))
    (tmp_path / "data_index").mkdir()
    np.save(tmp_path / "data_index" / "np_val_index.npy",
            np.array([0, 1, 3], np.int64))
    return tmp_path


def test_depth_run_then_score_then_nic(coco_cwd, capsys):
    assert training.main(["depth", "soft", "cnn", "coco", "--device", "cpu",
                          "--epochs", "1", "--exp-time", "1"]) == 0
    out = capsys.readouterr()
    assert "WARNING: no DPT weights" in out.err
    assert "WARNING: no ResNet-152 weights" in out.err
    d = coco_cwd / "exp_result" / "CNN_depth_soft"
    with open(d / "depth_cache_coco.npy.json") as f:
        assert json.load(f) == {"shape": [6, 224, 224, 1], "complete": True}
    maps = np.load(d / "depth_cache_coco.npy")
    assert maps.dtype == np.float16 and np.isfinite(maps).all()
    assert maps.min() >= 0.0 and maps.max() <= 1.0 and maps.std() > 0
    rows = (d / "depth_soft_train_loss_coco0.csv").read_text().splitlines()
    assert len(rows) == 1 and rows[0].startswith("0, ")
    assert np.isfinite(float(rows[0].split(", ")[1]))
    for comp in ("encoder", "decoder", "D_encoder"):
        assert (d / f"depth_soft_{comp}_best_coco0.pth.msgpack").exists()
    with open(d / "depth_soft_metrics_coco0.jsonl") as f:
        assert json.loads(f.readline())["epoch"] == 0

    assert evaluation.main(["depth", "soft", "score", "coco", "--device",
                            "cpu", "--num-sets", "1", "--batch-size",
                            "3"]) == 0
    with open(d / "coco_scores.pkl", "rb") as f:
        scores = pickle.load(f)
    assert len(scores) == 7
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in scores.values())

    enc_file = d / "depth_soft_encoder_best_coco0.pth.msgpack"
    assert training.main(["base", "nic", "--device", "cpu", "--epochs", "1",
                          "--exp-time", "1", "--resnet-weights",
                          str(enc_file)]) == 0
    nic = flatten_tree(load_component(str(
        coco_cwd / "exp_result" / "NIC" / "nic_encoder_best0.pth.msgpack")))
    src = load_component(str(enc_file))
    want = flatten_tree({"params": src["params"]["backbone"],
                         "batch_stats": src["batch_stats"]["backbone"]})
    assert set(nic) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(nic[k], v)


def test_pth_resnet_weights_start_the_backbone(coco_cwd, capsys):
    """A torchvision ResNet ``.pth`` (no msgpack twin) is bridged into the
    frozen encoder: the run's encoder file holds its weights (the conv
    kernels rounded to the bf16 encoder's dtype)."""
    torch.manual_seed(0)
    net = TorchTinyResNet().eval()
    _randomize_bn_stats(net, np.random.default_rng(0))
    pth = coco_cwd / "resnet152-tiny.pth"
    torch.save(net.state_dict(), pth)
    assert training.main(["base", "soft", "coco", "--device", "cpu",
                          "--epochs", "1", "--exp-time", "1",
                          "--resnet-weights", str(pth)]) == 0
    assert "WARNING: no ResNet-152 weights" not in capsys.readouterr().err
    got = flatten_tree(load_component(str(
        coco_cwd / "exp_result" / "base_soft"
        / "base_soft_encoder_best_coco0.pth.msgpack")))
    sd = {k: v.detach().numpy() for k, v in net.state_dict().items()}
    want = flatten_tree(encoder_to_flax(sd, (1, 1, 1, 1)))
    assert set(got) == set(want)
    for k, v in want.items():
        if v.ndim == 4:
            v = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got[k], v)


def _child(cwd, *flags):
    # one thread each: the children run beside each other and the suite
    env = dict(os.environ, DCAP_RESNET_LAYERS="1,1,1,1", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(sys.path))
    return subprocess.Popen(
        [sys.executable, "-m", "depth_image_captioning_pub_torch.training",
         "base", "soft", "coco", "--device", "cpu", "--epochs", "2",
         "--exp-time", "1", *flags], cwd=cwd, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def test_sigterm_child_resumes_to_the_straight_run(tmp_path):
    """The CLI's own ``ConfigTrain`` (batch 30): 45 train images, two
    steps an epoch. SIGTERM goes to the child once its end-of-epoch-0
    checkpoint is on disk, so it lands in epoch 1."""
    data = tmp_path / "data"
    root = data / "dataset" / "coco2014"
    _, tann = make_synthetic_coco(str(root), num_images=45,
                                  image_hw=(32, 32), seed=7)
    _, vann = make_synthetic_coco(str(root), num_images=3,
                                  image_hw=(32, 32), seed=8, split="val2014")
    w2i, i2w = build_vocab(captions_from_coco_json(tann),
                           captions_from_coco_json(vann), min_count=1)
    save_vocab(w2i, i2w, str(root / "word_to_id.pkl"),
               str(root / "id_to_word.pkl"))
    runs = {}
    for name in ("straight", "preempted"):
        runs[name] = tmp_path / name
        runs[name].mkdir()
        (runs[name] / "dataset").symlink_to(data / "dataset")
    d = "exp_result/base_soft"
    straight = _child(runs["straight"])
    child = _child(runs["preempted"], "--checkpoint-every", "1")
    first = runs["preempted"] / d / "full_state_base_soft_coco0/state_0.pt"
    deadline = time.time() + 300
    while not first.exists() and child.poll() is None \
            and time.time() < deadline:
        time.sleep(0.01)
    child.send_signal(signal.SIGTERM)
    out, err = child.communicate(timeout=300)
    assert child.returncode == 0, err
    assert "preempted: checkpoint saved at" in out
    resumed = _child(runs["preempted"], "--checkpoint-every", "1",
                     "--resume")
    out, err = resumed.communicate(timeout=300)
    assert resumed.returncode == 0, err
    assert "resumed" in out
    straight.communicate(timeout=300)
    assert straight.returncode == 0
    for split in ("train", "val"):
        name = f"{d}/base_soft_{split}_loss_coco0.csv"
        rows = (runs["straight"] / name).read_text().splitlines()
        assert len(rows) == 2
        assert (runs["preempted"] / name).read_text().splitlines() == rows
