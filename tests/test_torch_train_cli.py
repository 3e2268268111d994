"""The training CLI (``python -m depth_image_captioning_pub_torch.training``,
the counterpart of ``base_main.py`` / ``depth_main.py``): its grammar, the
flags that are not ported yet (exit 2, naming ROADMAP.md's item), and two
runs on the CPU over a synthetic COCO in the reference's layout (through
the config's cwd-relative paths, ResNet blocks 1,1,1,1 and the tests'
tiny DPT from $DCAP_RESNET_LAYERS and $DCAP_TINY_DPT):

* ``training depth soft cnn coco --device cpu --epochs 1 --exp-time 1``:
  the depth cache is built first (complete, the DPT's maps of every train
  image), then the run writes its CSV and JSONL rows and its best-val set,
  which ``evaluation depth soft score coco --device cpu --num-sets 1``
  scores;
* ``training base nic --resnet-weights <that run's encoder file>``: NIC's
  frozen backbone is the file's, bit for bit.
"""

import json
import pickle

import numpy as np
import pytest

from depth_image_captioning_pub_tpu.data.vocab import (
    build_vocab, captions_from_coco_json, save_vocab)
from depth_image_captioning_pub_torch import evaluation, training
from depth_image_captioning_pub_torch.config import ConfigTrain
from depth_image_captioning_pub_torch.data.synthetic import (
    make_synthetic_coco)
from depth_image_captioning_pub_torch.engine import train as ttrain
from depth_image_captioning_pub_torch.utils.checkpoint import load_component
from depth_image_captioning_pub_torch.utils.jax_bridge import flatten_tree


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
                                   ["--checkpoint-every", "1"],
                                   ["--checkpoint-keep", "2"], ["--resume"],
                                   ["--feature-cache"],
                                   ["--profile", "prof"],
                                   ["--profile-start", "1"],
                                   ["--profile-stop", "3"]])
def test_unported_flags_exit_2(flags, capsys, monkeypatch):
    monkeypatch.setattr(ttrain, "train", lambda *a, **k: pytest.fail(
        "train ran"))
    assert training.main(["base", "soft", "coco"] + flags) == 2
    err = capsys.readouterr().err
    assert "Queue A item 7" in err and flags[0] in err


def test_pth_resnet_weights_exit_2(tmp_path, capsys):
    pth = tmp_path / "resnet152.pth"
    pth.write_bytes(b"not read")
    assert training.main(["base", "soft", "coco", "--resnet-weights",
                          str(pth)]) == 2
    assert "Queue A item 3" in capsys.readouterr().err


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
