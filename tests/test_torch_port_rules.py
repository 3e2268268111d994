"""Rules the port keeps, checked on the CPU.

* No module of ``depth_image_captioning_pub_torch`` and not
  ``chip_smoke.py`` imports ``jax``, ``flax``, ``msgpack``, ``ml_dtypes``
  or ``depth_image_captioning_pub_tpu`` (an AST walk over every import),
  and Pillow is imported only inside functions (the card's machine has
  none).
* The port's own copies of the JAX package's framework-free code behave as
  the originals: ``ConfigTrain``/``ConfigEval`` field by field, the
  detokenizer, the vocabulary loader and the evaluation batches; the
  caption metrics are the JAX package's files with only the import paths
  rewritten.
* The entry points run on the CUDA card unless the caller asks for the
  CPU: their default device is ``"cuda"``, and without a card a default
  call raises instead of running on the CPU.
"""

import ast
import dataclasses
import inspect
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from depth_image_captioning_pub_tpu import config as jconfig
from depth_image_captioning_pub_tpu.data import pipeline as jpipeline
from depth_image_captioning_pub_tpu.data import tokenizer as jtokenizer
from depth_image_captioning_pub_tpu.data import vocab as jvocab
from depth_image_captioning_pub_torch import (
    caption, cli, evaluation, serve)
from depth_image_captioning_pub_torch import config as tconfig
from depth_image_captioning_pub_torch.data import pipeline as tpipeline
from depth_image_captioning_pub_torch.data import tokenizer as ttokenizer
from depth_image_captioning_pub_torch.data import vocab as tvocab
from depth_image_captioning_pub_torch.models import captioner, dpt
from depth_image_captioning_pub_torch.pipeline import CaptionPipeline

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "ml_dtypes",
             "depth_image_captioning_pub_tpu")


def _port_sources():
    files = sorted((REPO / "depth_image_captioning_pub_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_and_chip_smoke_import_no_jax():
    files = _port_sources()
    assert len(files) > 20
    bad = [f"{p.relative_to(REPO)}:{line} imports {root}"
           for p in files for root, line in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad


def _module_level_imports(tree):
    """Import nodes outside every function body."""
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        elif not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield from _module_level_imports(node)


def _names(node):
    if isinstance(node, ast.Import):
        return [a.name.split(".")[0] for a in node.names]
    return [node.module.split(".")[0]] if node.level == 0 else []


def test_pillow_imported_only_in_functions():
    bad = [f"{p.relative_to(REPO)}:{node.lineno}"
           for p in _port_sources()
           for node in _module_level_imports(ast.parse(p.read_text()))
           if "PIL" in _names(node)]
    assert not bad, bad
    src = ast.parse("import PIL\nclass A:\n    from PIL import Image\n"
                    "def f():\n    import PIL.Image\n")
    assert [n.lineno for n in _module_level_imports(src)
            if "PIL" in _names(n)] == [1, 3]


def test_metrics_copies_equal_jax():
    jdir = REPO / "depth_image_captioning_pub_tpu" / "metrics"
    tdir = REPO / "depth_image_captioning_pub_torch" / "metrics"
    names = sorted(p.name for p in jdir.glob("*.py"))
    assert names == sorted(p.name for p in tdir.glob("*.py"))
    assert {"bleu.py", "cider.py", "meteor.py", "porter.py", "rouge.py",
            "scorer.py", "__init__.py"} <= set(names)
    for name in names:
        want = (jdir / name).read_text().replace(
            "depth_image_captioning_pub_tpu", "depth_image_captioning_pub_torch")
        assert (tdir / name).read_text() == want, name


def test_import_guard_sees_imports(tmp_path):
    """The walk finds imports in functions and in every import form."""
    src = tmp_path / "m.py"
    src.write_text("def f():\n    from depth_image_captioning_pub_tpu.x "
                   "import y\nimport flax.linen as nn\nimport os, jax\n")
    assert sorted(r for r, _ in _imported_roots(src)) == [
        "depth_image_captioning_pub_tpu", "flax", "jax", "os"]


@pytest.mark.parametrize("name", ["ConfigTrain", "ConfigEval"])
def test_config_copies_equal_jax(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)          # paths default relative to the cwd
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    jfields = [(f.name, f.type) for f in dataclasses.fields(jcls)]
    tfields = [(f.name, f.type) for f in dataclasses.fields(tcls)]
    assert tfields == jfields
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())
    assert tcls().save_dir("nic", False) == jcls().save_dir("nic", False)


def test_tokenizer_copy_equals_jax():
    assert ttokenizer.SPECIAL == ttokenizer.SpecialTokens()
    assert dataclasses.asdict(ttokenizer.SPECIAL) == dataclasses.asdict(
        jtokenizer.SPECIAL)
    i2w = {0: "a", 1: "dog", 2: "<start>", 3: "<end>", 4: "<unk>"}
    w2i = {w: i for i, w in i2w.items()}
    for ids in ([2, 0, 1, 3, 1], [0, 0, 1], [3, 0], [2, 2, 4, 1]):
        assert ttokenizer.ids_to_caption(ids, i2w) == \
            jtokenizer.ids_to_caption(ids, i2w)
    for cap in ("A dog. , runs,", "a cat sat on the mat.", " . "):
        assert ttokenizer.untokenize_caption(cap, w2i) == \
            jtokenizer.untokenize_caption(cap, w2i)


def test_vocab_and_eval_batches_copies_equal_jax(tmp_path):
    w2i = {"a": 0, "dog": 1, "<start>": 2, "<end>": 3, "<unk>": 4}
    path = tmp_path / "w2i.pkl"
    with open(path, "wb") as f:
        pickle.dump(w2i, f)
    assert tvocab.load_vocab(str(path)) == jvocab.load_vocab(str(path))

    class Dataset:
        images = np.arange(5 * 2 * 2 * 3, dtype=np.uint8).reshape(5, 2, 2, 3)

        def __len__(self):
            return 5

        def load_image(self, i):
            return self.images[i]

        def captions(self, i):
            return [f"A dog {i}.", "a cat"]

    got = list(tpipeline.Prefetcher(tpipeline.eval_batches(
        Dataset(), w2i, batch_size=2)))
    want = list(jpipeline.eval_batches(Dataset(), w2i, batch_size=2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.pad_mask, w.pad_mask)
        assert g.references == w.references


def test_entry_points_default_to_cuda():
    defaults = {
        "build_captioner": inspect.signature(
            captioner.build_captioner).parameters["device"].default,
        "Captioner": inspect.signature(
            captioner.Captioner).parameters["device"].default,
        "DPTDepthEstimator": inspect.signature(
            dpt.DPTDepthEstimator).parameters["device"].default,
        "make_depth_fn": inspect.signature(
            cli.make_depth_fn).parameters["device"].default,
    }
    defaults["from_experiment"] = inspect.signature(
        CaptionPipeline.from_experiment).parameters["device"].default
    defaults["eval_depth_fn"] = inspect.signature(
        cli.eval_depth_fn).parameters["device"].default
    assert set(defaults.values()) == {"cuda"}, defaults
    for module in (cli, evaluation):
        assert "is_available" not in inspect.getsource(module)
    if torch.cuda.is_available():
        return
    # without a card a default call raises from PyTorch, it does not fall
    # back to the CPU
    with pytest.raises((RuntimeError, AssertionError)):
        captioner.build_captioner("nic", 20, resnet_layers=(1, 1, 1, 1))
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["caption", "--random", "1", "--vocab-size", "20",
                  "--resnet-layers", "1,1,1,1", "--image-size", "64"])


def test_cli_device_default_is_cuda(monkeypatch):
    seen = {}

    def fake_caption(args):
        seen.update(vars(args))
        return []

    monkeypatch.setattr(cli, "caption", fake_caption)
    cli.main(["caption", "--random", "1", "--kind", "nic", "--beam", "3",
              "--length-penalty", "0.7"])
    assert seen["device"] == "cuda" and seen["kind"] == "nic"
    assert seen["beam"] == 3 and seen["length_penalty"] == 0.7


@pytest.mark.parametrize("words", [["base", "soft", "score", "coco"],
                                   ["depth", "soft", "score", "coco"],
                                   ["nic"]])
def test_evaluation_device_default_is_cuda(words, tmp_path, monkeypatch):
    """``evaluation.main`` captions on the card unless ``--device cpu``:
    without a card it raises where it builds the captioner."""
    seen = {}
    monkeypatch.setattr(evaluation, "score_mode",
                        lambda *a: seen.setdefault("device", a[-1]) and 0)
    monkeypatch.setattr(evaluation, "nic_mode",
                        lambda *a: seen.setdefault("device", a[-1]) and 0)
    assert evaluation.main(list(words)) == 0
    assert seen["device"] == "cuda"
    monkeypatch.undo()
    if torch.cuda.is_available():
        return
    # an empty evaluation set in the reference's layout
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DCAP_RESNET_LAYERS", "1,1,1,1")
    monkeypatch.setenv("DCAP_TINY_DPT", "1")
    coco = tmp_path / "dataset" / "coco2014"
    coco.mkdir(parents=True)
    with open(coco / "word_to_id.pkl", "wb") as f:
        pickle.dump({"a": 0, "<start>": 1, "<end>": 2, "<unk>": 3}, f)
    (coco / "captions_val2014.json").write_text(
        '{"images": [], "annotations": []}')
    (tmp_path / "data_index").mkdir()
    np.save(tmp_path / "data_index" / "np_val_index.npy",
            np.zeros((0,), np.int64))
    with pytest.raises((RuntimeError, AssertionError)):
        evaluation.main(list(words))


def test_serving_entry_points_default_to_cuda():
    """``serve`` and ``caption`` caption on the card unless ``--device
    cpu``; neither looks for a card to fall back from."""
    assert serve.build_parser().parse_args([]).device == "cuda"
    assert caption.build_parser().parse_args(["x.png"]).device == "cuda"
    for module in (serve, caption):
        assert "is_available" not in inspect.getsource(module)


def test_new_modules_are_guarded():
    """The serving modules and the image readers are among the sources
    the import guard walks; the native source ships as package data."""
    import tomllib
    names = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    pkg = "depth_image_captioning_pub_torch"
    assert {f"{pkg}/serve.py", f"{pkg}/caption.py",
            f"{pkg}/data/image_io.py", f"{pkg}/data/native_loader.py"} <= names
    with open(REPO / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert "native/fastimage.cpp" in data[pkg]
    assert (REPO / pkg / "native" / "fastimage.cpp").is_file()


def test_training_modules_are_guarded(tmp_path, monkeypatch):
    """The training slice's modules are among the sources the import guard
    and the Pillow rule walk; the trainer and its CLI train on the card
    unless asked for the CPU, and look for no card to fall back from."""
    from depth_image_captioning_pub_torch import training
    from depth_image_captioning_pub_torch.engine import train
    names = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    pkg = "depth_image_captioning_pub_torch"
    assert {f"{pkg}/training.py", f"{pkg}/engine/train.py",
            f"{pkg}/engine/steps.py", f"{pkg}/engine/losses.py",
            f"{pkg}/engine/depth_cache.py", f"{pkg}/utils/logging.py",
            f"{pkg}/data/synthetic.py"} <= names
    assert inspect.signature(train.train).parameters["device"].default == \
        "cuda"
    assert training.build_parser().parse_args(["base", "nic"]).device == \
        "cuda"
    for module in (train, training):
        assert "is_available" not in inspect.getsource(module)
    if torch.cuda.is_available():
        return
    monkeypatch.chdir(tmp_path)     # the default config's output paths
    with pytest.raises((RuntimeError, AssertionError)):
        train.train("nic", 0, datasets=([], []), word_to_id={"a": 0},
                    num_epochs=0, resnet_layers=(1, 1, 1, 1))


def test_parallel_modules_are_guarded():
    """The data-parallel modules are among the sources the import guard
    walks; joining a group defaults to the card (NCCL) and looks for no
    card to fall back from."""
    from depth_image_captioning_pub_torch.parallel import mesh, multihost
    names = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    pkg = "depth_image_captioning_pub_torch"
    assert {f"{pkg}/parallel/__init__.py", f"{pkg}/parallel/mesh.py",
            f"{pkg}/parallel/multihost.py"} <= names
    assert inspect.signature(multihost.initialize).parameters[
        "device"].default == "cuda"
    for module in (mesh, multihost):
        assert "is_available" not in inspect.getsource(module)
