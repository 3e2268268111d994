"""The port's caption CLI (``depth_image_captioning_pub_torch/caption.py``)
on the CPU: each test of ``tests/test_caption_cli.py`` on the port, and
its output held equal to the JAX ``caption.main`` on a working directory
that the JAX trainer (``base_main.py``, one epoch, ResNet blocks 1,1,1,1)
trained in: the same lines for the val JPEGs (the two packages' native
decoders give the same bytes) and for PNG copies of them (the port's PNG
reader against the JAX loader's Pillow fallback), and JSON output. Both
packages build f32 encoders there (bf16 convs round differently in the
two frameworks).
"""

import functools
import json
import os
import shutil

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from PIL import Image

from depth_image_captioning_pub_tpu import caption as jcaption
from depth_image_captioning_pub_tpu.models import captioner as jcaptioner
from depth_image_captioning_pub_torch import caption as caption_cli
from depth_image_captioning_pub_torch.models import captioner as tcaptioner
from torch_threads import one_thread  # noqa: F401 (autouse fixture)


def test_expand_paths(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    for name in ("b.jpg", "a.png", "notes.txt", "c.jpeg", "D.BMP"):
        (d / name).write_bytes(b"x")
    single = tmp_path / "top.jpg"
    single.write_bytes(b"x")
    got = caption_cli.expand_paths([str(single), str(d)])
    assert got == [str(single), str(d / "D.BMP"), str(d / "a.png"),
                   str(d / "b.jpg"), str(d / "c.jpeg")]
    assert got == jcaption.expand_paths([str(single), str(d)])


def test_missing_path_errors(tmp_path, capsys):
    assert caption_cli.main([str(tmp_path / "nope.jpg")]) == 1
    assert "not found" in capsys.readouterr().err
    empty = tmp_path / "empty"
    empty.mkdir()
    assert caption_cli.main([str(empty)]) == 1
    assert "no images found" in capsys.readouterr().err


def test_export_dir_is_not_ported(tmp_path, capsys):
    """``--export-dir`` is ported: a directory without an artifact's
    meta.json is an error (exit 1) that names it, before any model is
    built (the round trip: ``tests/test_torch_export.py``)."""
    img = tmp_path / "x.png"
    img.write_bytes(b"x")
    assert caption_cli.main([str(img), "--export-dir",
                             str(tmp_path / "art")]) == 1
    assert "meta.json missing" in capsys.readouterr().err


def test_flags_thread_to_pipeline(monkeypatch, tmp_path):
    img = tmp_path / "x.png"
    Image.fromarray(np.full((32, 32, 3), 100, np.uint8)).save(str(img))
    seen = {}

    class FakePipe:
        image_hw = (224, 224)

        def __call__(self, images):
            return ["a cat"] * len(images)

    def fake_from_experiment(kind, use_data, **kw):
        seen.update(kind=kind, use_data=use_data, **kw)
        return FakePipe()

    monkeypatch.setattr(
        "depth_image_captioning_pub_torch.pipeline.CaptionPipeline."
        "from_experiment", staticmethod(fake_from_experiment))
    rc = caption_cli.main([str(img), "--kind", "depth-soft", "--beam", "3",
                           "--set-idx", "2", "--sample",
                           "--temperature", "0.8", "--top-k", "5",
                           "--seed", "7", "--gelu", "tanh",
                           "--batch-size", "4"])
    assert rc == 0
    assert seen["kind"] == "depth-soft" and seen["beam_size"] == 3
    assert seen["set_idx"] == 2 and seen["sample"] is True
    assert seen["temperature"] == 0.8 and seen["top_k"] == 5
    assert seen["seed"] == 7 and seen["batch_size"] == 4
    assert seen["cfg"] is not None and seen["cfg"].dpt_gelu == "tanh"
    assert seen["device"] == "cuda"      # the card unless asked otherwise


@pytest.fixture(scope="module")
def trained_cwd(tmp_path_factory, request):
    """A cwd with a 1-epoch tiny base-soft experiment that the JAX trainer
    trained in it."""
    from depth_image_captioning_pub_tpu.data.synthetic import (
        make_synthetic_coco)
    from depth_image_captioning_pub_tpu.data.vocab import (
        build_vocab, captions_from_coco_json, save_vocab)
    import base_main

    root = tmp_path_factory.mktemp("capcwd")
    ddir = root / "dataset" / "coco2014"
    ddir.mkdir(parents=True)
    _, tann = make_synthetic_coco(str(ddir), num_images=6, seed=11,
                                  split="train2014")
    _, vann = make_synthetic_coco(str(ddir), num_images=5, seed=12,
                                  split="val2014")
    os.rename(tann, ddir / "captions_train2014.json")
    os.rename(vann, ddir / "captions_val2014.json")
    w2i, i2w = build_vocab(
        captions_from_coco_json(str(ddir / "captions_train2014.json")),
        captions_from_coco_json(str(ddir / "captions_val2014.json")),
        min_count=1)
    save_vocab(w2i, i2w, str(ddir / "word_to_id.pkl"),
               str(ddir / "id_to_word.pkl"))
    saved_env = os.environ.get("DCAP_RESNET_LAYERS")
    os.environ["DCAP_RESNET_LAYERS"] = "1,1,1,1"
    old = os.getcwd()
    os.chdir(root)
    try:
        assert base_main.main(["soft", "coco", "--epochs", "1",
                               "--exp-time", "1"]) == 0
    finally:
        os.chdir(old)
        if saved_env is None:
            os.environ.pop("DCAP_RESNET_LAYERS", None)
        else:
            os.environ["DCAP_RESNET_LAYERS"] = saved_env
    return root


@pytest.fixture
def cwd(trained_cwd, monkeypatch):
    """In the trained cwd, both packages' ``build_captioner`` making f32
    encoders at ResNet blocks 1,1,1,1, the port on the CPU."""
    monkeypatch.setenv("DCAP_RESNET_LAYERS", "1,1,1,1")
    monkeypatch.chdir(trained_cwd)
    monkeypatch.setattr(jcaptioner, "build_captioner", functools.partial(
        jcaptioner.build_captioner, encoder_dtype=jnp.float32))
    monkeypatch.setattr(tcaptioner, "build_captioner", functools.partial(
        tcaptioner.build_captioner, encoder_dtype=torch.float32))
    return trained_cwd


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def _val_images(root):
    return sorted(str(p) for p in (root / "dataset" / "coco2014"
                                   / "val2014").iterdir())


def test_end_to_end_equals_jax(cwd, capsys):
    imgs = _val_images(cwd)[:3]
    assert jcaption.main(imgs + ["--kind", "base-soft"]) == 0
    want = _lines(capsys)
    rc = caption_cli.main(imgs + ["--kind", "base-soft", "--device", "cpu"])
    assert rc == 0
    lines = _lines(capsys)
    assert lines == want and len(lines) == 3
    for path, line in zip(imgs, lines):
        got_path, cap = line.split("\t")
        assert got_path == path and isinstance(cap, str)

    val_dir = cwd / "dataset" / "coco2014" / "val2014"
    out = cwd / "caps.json"
    rc = caption_cli.main([str(val_dir), "--kind", "base-soft", "--json",
                           "--output", str(out), "--device", "cpu"])
    assert rc == 0
    data = json.loads(out.read_text())
    assert len(data) == 5 and all({"path", "caption"} <= set(d)
                                  for d in data)
    assert jcaption.main([str(val_dir), "--kind", "base-soft", "--json",
                          "--output", str(cwd / "jax.json")]) == 0
    assert data == json.loads((cwd / "jax.json").read_text())
    by_path = {d["path"]: d["caption"] for d in data}
    for path, line in zip(imgs, lines):
        assert by_path[path] == line.split("\t")[1]


def test_png_directory_equals_jax(cwd, capsys, tmp_path):
    """PNG copies of the val images, resized off the model's size: the
    port's PNG reader and resize against the JAX loader's Pillow."""
    d = tmp_path / "pngs"
    d.mkdir()
    for p in _val_images(cwd):
        img = Image.open(p).convert("RGB")
        img.resize((img.width + 37, img.height - 11)).save(
            d / (os.path.basename(p) + ".png"))
    assert jcaption.main([str(d), "--kind", "base-soft"]) == 0
    want = _lines(capsys)
    assert caption_cli.main([str(d), "--kind", "base-soft", "--device",
                             "cpu"]) == 0
    assert _lines(capsys) == want and len(want) == 5


def test_paths_through_the_pipeline_equal_the_cli(cwd, capsys):
    """The pipeline called on paths decodes as the CLI does."""
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    imgs = _val_images(cwd)
    assert caption_cli.main(imgs + ["--device", "cpu"]) == 0
    want = [ln.split("\t")[1] for ln in _lines(capsys)]
    pipe = CaptionPipeline.from_experiment("base-soft", device="cpu",
                                           batch_size=4)
    assert pipe(imgs) == want
    assert pipe(imgs[2]) == want[2]


def test_corrupt_file_does_not_kill_the_batch(cwd, capsys, tmp_path):
    """One truncated JPEG in a directory run: warned on stderr, captioned
    '<decode failed>', the other files' captions unchanged."""
    good = _val_images(cwd)[:2]
    assert caption_cli.main(good + ["--device", "cpu"]) == 0
    clean = dict(ln.split("\t") for ln in _lines(capsys))

    d = tmp_path / "mixed"
    d.mkdir()
    for p in good:
        shutil.copy(p, d / os.path.basename(p))
    bad = d / "a_truncated.jpg"   # sorts first; JPEG magic, then garbage
    bad.write_bytes(b"\xff\xd8\xff\xe0" + b"\x00" * 64)

    assert caption_cli.main([str(d), "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert "decode failed" in captured.err and "a_truncated.jpg" in \
        captured.err
    got = dict(ln.split("\t") for ln in captured.out.strip().splitlines())
    assert got[str(bad)] == "<decode failed>"
    for p in good:
        assert got[str(d / os.path.basename(p))] == clean[p]

    d2 = tmp_path / "allbad"
    d2.mkdir()
    (d2 / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0junk")
    assert caption_cli.main([str(d2), "--device", "cpu"]) == 1
    assert "no decodable images" in capsys.readouterr().err
