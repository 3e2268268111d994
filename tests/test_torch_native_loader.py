"""The port's native image library (``native/fastimage.cpp`` through
``data/native_loader.py``) against the JAX package's loader, on the CPU.

* It builds with g++ under ``build/dcap_torch_native/``, not beside the
  source, with libjpeg where the headers are (here) and without it where
  they are not (the card's machine): ``FASTIMAGE_NO_JPEG`` builds the
  latter here.
* ``decode_batch`` of JPEG files == the JAX ``decode_batch``, byte for
  byte (the same DCT-scaled decode and resize), at several target sizes
  and for a gray JPEG; PNG files in the batch == the JAX loader's Pillow
  fallback; ``on_error`` as in the JAX loader; ``CocoCaptions.
  load_images_batch`` == the JAX one.
* Without libjpeg in the library, JPEG files decode through Pillow at
  Pillow's bytes; without the library at all, PNGs go to Pillow and,
  without Pillow, raise naming g++.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from depth_image_captioning_pub_tpu.data import coco as jcoco
from depth_image_captioning_pub_tpu.data import native_loader as jloader
from depth_image_captioning_pub_tpu.serve import _decode_bytes
from depth_image_captioning_pub_torch.data import coco, native_loader
from depth_image_captioning_pub_torch.data.image_io import ImageDecodeError


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("jpegs")
    paths = []
    for i, hw in enumerate([(480, 640)] * 6 + [(375, 500), (640, 427),
                                               (224, 224), (100, 150)]):
        base = rng.integers(0, 255, (30, 40, 3)).astype(np.uint8)
        img = Image.fromarray(base).resize(hw[::-1], Image.BILINEAR)
        p = str(d / f"img{i}.jpg")
        img.save(p, quality=90)
        paths.append(p)
    gray = str(d / "gray.jpg")
    Image.open(paths[0]).convert("L").save(gray, quality=90)
    return paths + [gray]


@pytest.fixture(scope="module")
def png_paths(tmp_path_factory):
    rng = np.random.default_rng(1)
    d = tmp_path_factory.mktemp("pngs")
    paths = []
    for i, mode in enumerate(("RGB", "L", "RGBA", "P")):
        arr = rng.integers(0, 255, (120 + i, 90 + 2 * i, 3), dtype=np.uint8)
        img = Image.fromarray(arr)
        img = img.quantize(64) if mode == "P" else img.convert(mode)
        p = str(d / f"x{i}.png")
        img.save(p)
        paths.append(p)
    return paths


def test_builds_and_available():
    assert native_loader.available() and native_loader.has_jpeg()
    lib = native_loader.library_path()
    assert lib.is_file()
    assert lib.parent.parent.name == "dcap_torch_native"
    assert lib.parent.parent.parent.name == "build"
    native = os.path.dirname(native_loader.SRC)
    assert os.listdir(native) == ["fastimage.cpp"]   # nothing built beside


@pytest.mark.parametrize("hw", [(224, 224), (96, 96), (64, 80), (300, 500)])
def test_decode_batch_equals_jax(jpeg_dir, hw):
    got = native_loader.decode_batch(jpeg_dir, hw)
    want = jloader.decode_batch(jpeg_dir, hw)
    assert got.shape == (len(jpeg_dir), *hw, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_decode_batch_png_fallback_equals_jax(jpeg_dir, png_paths):
    paths = [jpeg_dir[0], *png_paths, jpeg_dir[1]]
    got = native_loader.decode_batch(paths, (224, 224))
    np.testing.assert_array_equal(got, jloader.decode_batch(paths,
                                                            (224, 224)))
    for i, p in enumerate(png_paths, 1):
        with open(p, "rb") as f:
            np.testing.assert_array_equal(got[i], _decode_bytes(
                f.read(), (224, 224)))


def test_on_error_zero_collects_failures(tmp_path, jpeg_dir):
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0" + b"\x00" * 32)  # JPEG magic, then junk
    with pytest.raises(Exception):
        native_loader.decode_batch([jpeg_dir[0], bad], (64, 64))
    failed = []
    out = native_loader.decode_batch([jpeg_dir[0], bad, jpeg_dir[1]],
                                     (64, 64), on_error="zero",
                                     failed=failed)
    assert failed == [1]
    assert not out[1].any()
    clean = native_loader.decode_batch([jpeg_dir[0], jpeg_dir[1]], (64, 64))
    np.testing.assert_array_equal(out[0], clean[0])
    np.testing.assert_array_equal(out[2], clean[1])
    jfailed = []
    jout = jloader.decode_batch([jpeg_dir[0], bad, jpeg_dir[1]], (64, 64),
                                on_error="zero", failed=jfailed)
    assert jfailed == failed
    np.testing.assert_array_equal(out, jout)
    with pytest.raises(ValueError, match="on_error"):
        native_loader.decode_batch([bad], (64, 64), on_error="skip")


def test_dataset_batch_path_equals_jax(jpeg_dir, tmp_path):
    images = [{"id": i, "file_name": os.path.basename(p)}
              for i, p in enumerate(jpeg_dir)]
    ann = {"images": images,
           "annotations": [{"id": i, "image_id": i, "caption": "a b c"}
                           for i in range(len(jpeg_dir))]}
    ann_path = str(tmp_path / "ann.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    root = os.path.dirname(jpeg_dir[0])
    got = coco.CocoCaptions(root, ann_path, image_size=(96, 96))
    want = jcoco.CocoCaptions(root, ann_path, image_size=(96, 96))
    batch = got.load_images_batch([0, 3, 5, 10])
    assert batch.shape == (4, 96, 96, 3) and batch.dtype == np.uint8
    np.testing.assert_array_equal(batch, want.load_images_batch([0, 3, 5,
                                                                10]))
    # no image size: the per-image Pillow path, as in the JAX package
    full = coco.CocoCaptions(root, ann_path, image_size=None)
    np.testing.assert_array_equal(
        full.load_images_batch([1]),
        jcoco.CocoCaptions(root, ann_path,
                           image_size=None).load_images_batch([1]))


@pytest.fixture
def no_jpeg_library(tmp_path, monkeypatch):
    """The library as the card's machine builds it (no jpeglib.h)."""
    out = tmp_path / "libfastimage_nojpeg.so"
    subprocess.run(["g++", *native_loader.CXX_FLAGS, "-DFASTIMAGE_NO_JPEG",
                    str(native_loader.SRC), "-o", str(out), "-lpthread"],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in native_loader._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    native_loader._load()
    monkeypatch.setattr(native_loader, "_lib", lib)
    return lib


def test_library_without_libjpeg(no_jpeg_library, jpeg_dir, png_paths,
                                 monkeypatch):
    assert native_loader.available() and not native_loader.has_jpeg()
    with open(jpeg_dir[0], "rb") as f:
        assert native_loader.jpeg_decode_mem(f.read()) is None
    got = native_loader.decode_batch(jpeg_dir[:3] + png_paths[:1],
                                     (224, 224))
    for row, p in zip(got, jpeg_dir[:3] + png_paths[:1]):
        with open(p, "rb") as f:     # Pillow's decode and resize
            np.testing.assert_array_equal(row, _decode_bytes(f.read(),
                                                             (224, 224)))
    pngs = jloader.decode_batch(png_paths, (64, 64))
    monkeypatch.setitem(sys.modules, "PIL", None)     # PNGs need no Pillow
    np.testing.assert_array_equal(
        native_loader.decode_batch(png_paths, (64, 64)), pngs)
    with pytest.raises(ImageDecodeError, match="without libjpeg"):
        native_loader.decode_batch(jpeg_dir[:1], (64, 64))


def test_without_the_library(png_paths, monkeypatch):
    """No g++: PNG files go to Pillow (its bytes); without Pillow the
    error names g++."""
    native_loader._load()
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_failed", True)
    assert not native_loader.available() and not native_loader.has_jpeg()
    assert native_loader.png_unfilter(np.zeros(4, np.uint8), 1, 3, 3) is None
    got = native_loader.decode_batch(png_paths, (64, 64))
    np.testing.assert_array_equal(got, jloader.decode_batch(png_paths,
                                                            (64, 64)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImageDecodeError, match="native library \\(g\\+\\+\\)"):
        native_loader.decode_batch(png_paths[:1], (64, 64))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_png_unfilter_matches_numpy(bpp):
    """The C unfilter against a numpy reference of the five filters,
    every filter type on rows of random bytes."""
    rng = np.random.default_rng(bpp)
    h, rb = 10, 7 * bpp
    raw = rng.integers(0, 256, (h, rb + 1), dtype=np.uint8)
    raw[:, 0] = np.arange(h) % 5
    want = np.zeros((h, rb), np.int64)
    for y in range(h):
        up = want[y - 1] if y else np.zeros(rb, np.int64)
        for x in range(rb):
            a = want[y, x - bpp] if x >= bpp else 0
            b = up[x]
            c = up[x - bpp] if x >= bpp else 0
            f = raw[y, 0]
            p = a + b - c
            pred = [0, a, b, (a + b) // 2,
                    a if abs(p - a) <= min(abs(p - b), abs(p - c))
                    else (b if abs(p - b) <= abs(p - c) else c)][f]
            want[y, x] = (int(raw[y, x + 1]) + pred) % 256
    got = native_loader.png_unfilter(raw.reshape(-1), h, rb, bpp)
    np.testing.assert_array_equal(got, want.astype(np.uint8))
    raw[3, 0] = 5
    with pytest.raises(ValueError, match="filter type"):
        native_loader.png_unfilter(raw.reshape(-1), h, rb, bpp)


def test_png_unfilter_refuses_bad_sizes():
    """Sizes that do not fit the stream are refused before the C call:
    a row of 2**31 bytes and more (past a C int), a negative height, a
    pixel wider than its row."""
    raw = np.zeros(64, np.uint8)
    for height, row_bytes, bpp in ((1, 2 ** 31 + 5, 3), (1, 2 ** 32 - 1, 3),
                                   (-1, 3, 3), (1, 2, 3), (1, 3, 0)):
        with pytest.raises(ValueError, match="png_unfilter"):
            native_loader.png_unfilter(raw, height, row_bytes, bpp)


@pytest.mark.parametrize("shapes", [((480, 640), (224, 224)),
                                    ((1, 1), (3, 2)), ((7, 300), (7, 2))])
def test_resample_bilinear_equals_pillow(shapes):
    (h, w), (oh, ow) = shapes
    arr = np.random.default_rng(h).integers(0, 256, (h, w, 3),
                                            dtype=np.uint8)
    want = np.asarray(Image.fromarray(arr).resize((ow, oh), Image.BILINEAR))
    np.testing.assert_array_equal(
        native_loader.resample_bilinear(arr, (oh, ow)), want)


def test_png_file_needs_no_pillow(png_paths, monkeypatch):
    want = native_loader.decode_batch(png_paths, (224, 224))
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(
        native_loader.decode_batch(png_paths, (224, 224)), want)


def test_library_that_does_not_load_is_rebuilt(tmp_path, monkeypatch):
    """A library file in the build directory that does not load (copied
    from a machine with a libjpeg this one lacks) is built again."""
    monkeypatch.setattr(native_loader, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_failed", False)
    out = native_loader.library_path()
    out.parent.mkdir(parents=True)
    out.write_bytes(b"not a shared library")
    assert native_loader.available() and native_loader.has_jpeg()
    assert out.read_bytes()[:4] == b"\x7fELF"
