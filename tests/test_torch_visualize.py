"""Sample mode's overlays (``depth_image_captioning_pub_torch/engine/
visualize.py``) against the JAX ``engine/visualize.py``, on the CPU:

* ``expand_alpha`` (scipy's x16 bilinear zoom and sigma-8 Gaussian) ==
  the JAX function to 1e-6;
* the ``jet`` table == ``matplotlib.colormaps["jet"]`` to 1e-6, and the
  heat's colours == what ``imshow`` looks up (its min-max ``Normalize``,
  the ``Colormap`` call's indexing);
* an overlay's pixels are the alpha-0.6 blend over the image, below a
  band with the word;
* ``sample_directory`` with one stub ``caption_one`` in both packages: the
  same file names, the same ``caption.txt`` bytes and the same
  ``input.png`` pixels (the JAX module renders its PNGs with matplotlib,
  the port with Pillow, so only the overlays' names are held equal).
"""

import os

import numpy as np
import pytest
from PIL import Image

from depth_image_captioning_pub_tpu.engine import visualize as jvis
from depth_image_captioning_pub_torch.engine import visualize as tvis

WORDS = {0: "<start>", 1: "<end>", 2: "a", 3: "dog", 4: "runs", 5: "<unk>"}


def test_expand_alpha_equals_jax():
    rng = np.random.default_rng(0)
    for alpha in (rng.random((14, 14)),
                  rng.dirichlet(np.ones(196)).reshape(14, 14)):
        got = tvis.expand_alpha(alpha)
        assert got.shape == (224, 224)
        np.testing.assert_allclose(got, jvis.expand_alpha(alpha), atol=1e-6,
                                   rtol=0)


def test_jet_table_equals_matplotlib():
    import matplotlib
    jet = matplotlib.colormaps["jet"]
    np.testing.assert_allclose(tvis.jet_table(), jet(np.arange(256))[:, :3],
                               atol=1e-6, rtol=0)
    rng = np.random.default_rng(1)
    heat = tvis.expand_alpha(rng.random((14, 14)))
    norm = matplotlib.colors.Normalize()(heat)
    np.testing.assert_allclose(tvis.heat_rgb(heat), jet(norm)[..., :3],
                               atol=1e-6, rtol=0)
    flat = tvis.heat_rgb(np.full((4, 4), 0.3))       # imshow's constant map
    np.testing.assert_allclose(flat, np.broadcast_to(jet(0)[:3], (4, 4, 3)),
                               atol=1e-6, rtol=0)


def test_overlay_blends_below_the_word():
    rng = np.random.default_rng(2)
    image = rng.random((224, 224, 3)).astype(np.float32)
    heat = tvis.expand_alpha(rng.random((14, 14)))
    out = np.asarray(tvis.overlay(image, heat, "dog"))
    assert out.shape == (224 + tvis.TITLE_PX, 224, 3)
    want = np.rint((0.4 * image + 0.6 * tvis.heat_rgb(heat)) * 255)
    np.testing.assert_array_equal(out[tvis.TITLE_PX:], want.astype(np.uint8))
    band = out[:tvis.TITLE_PX]
    assert (band == 255).mean() > 0.8 and (band < 128).any()   # the word


def _stub(alphas_seed):
    """caption_one: a fixed token row with <start> and <end> and softmax
    alphas drawn from the image's mean, the same in both packages."""
    def caption_one(arr):
        rng = np.random.default_rng(alphas_seed + int(arr.mean() * 1e4))
        alphas = rng.dirichlet(np.ones(196), size=6).astype(np.float32)
        return np.array([0, 2, 3, 5, 4, 1], np.int32), alphas
    return caption_one


def test_sample_directory_equals_jax(tmp_path):
    src = tmp_path / "pics"
    src.mkdir()
    rng = np.random.default_rng(3)
    Image.fromarray(rng.integers(0, 256, (90, 120, 3), np.uint8)).save(
        src / "b_cat.png")
    Image.fromarray(rng.integers(0, 256, (300, 200, 3), np.uint8)).save(
        src / "a_dog.jpg", quality=90)
    got = tvis.sample_directory(str(src), str(tmp_path / "port"), _stub(7),
                                WORDS)
    want = jvis.sample_directory(str(src), str(tmp_path / "jax"), _stub(7),
                                 WORDS)
    assert list(got.values()) == list(want.values()) == [
        "a dog <unk> runs"] * 2
    assert list(got) == list(want)

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, files in os.walk(root) for f in files)
    assert tree(tmp_path / "port") == tree(tmp_path / "jax") == sorted(
        ["caption.txt"] + [f"{stem}/{name}" for stem in ("a_dog", "b_cat")
                           for name in ("input.png", "00_a.png",
                                        "01_dog.png", "02_<unk>.png",
                                        "03_runs.png")])
    assert ((tmp_path / "port" / "caption.txt").read_bytes()
            == (tmp_path / "jax" / "caption.txt").read_bytes())
    for stem in ("a_dog", "b_cat"):
        a = np.asarray(Image.open(tmp_path / "port" / stem / "input.png"))
        b = np.asarray(Image.open(tmp_path / "jax" / stem / "input.png"))
        assert a.shape == (224, 224, 3)
        np.testing.assert_array_equal(a, b)
        overlay = Image.open(tmp_path / "port" / stem / "01_dog.png")
        assert overlay.size == (224, 224 + tvis.TITLE_PX)


@pytest.mark.parametrize("tokens", [[1, 2, 3], [0, 0]])
def test_sample_directory_without_words(tokens, tmp_path):
    """A caption that ends at once (or holds only <start>) writes
    input.png and an empty caption, and no overlay."""
    src = tmp_path / "pics"
    src.mkdir()
    Image.fromarray(np.full((30, 30, 3), 90, np.uint8)).save(src / "x.png")

    def caption_one(arr):
        return np.array(tokens), np.zeros((len(tokens), 196), np.float32)
    out = tmp_path / "out"
    assert tvis.sample_directory(str(src), str(out), caption_one, WORDS) \
        == {str(src / "x.png"): ""}
    assert sorted(os.listdir(out / "x")) == ["input.png"]
    assert (out / "caption.txt").read_text() == "x.png: \n"
