"""The port's image bytes reader and resize (``data/image_io.py``) against
Pillow and the JAX server's decoder, byte for byte, on the CPU.

* PNG: the five 8-bit colour types (gray, RGB, palette, gray+alpha, RGBA)
  with each of the five scanline filters on every row, and with the
  filters mixed row by row, encoded here so that every filter is
  exercised (Pillow's writer picks its own), decode to the bytes of
  Pillow's ``convert("RGB")``; no Pillow is needed for them.
* ``resize_u8`` == ``Image.resize((w, h), BILINEAR)`` over up-scales,
  down-scales, non-integer ratios and 1-pixel edges.
* ``decode_image_bytes`` == the JAX ``serve._decode_bytes`` on PNG and
  JPEG bodies (RGB and gray, 4:2:0 and 4:4:4 chroma, two qualities).
* What the reader does not take (a 16-bit PNG, an interlaced one, a JPEG
  without libjpeg, another format) goes to Pillow, or, without Pillow,
  raises one error naming what is missing; corrupt PNGs raise.
* Decompression bombs: a PNG or JPEG whose header states more pixels than
  Pillow's limit is refused before anything is inflated or allocated, as
  Pillow refuses it; a PNG stream longer than its header's size is
  inflated no further than that size.
* Without the native library ``resize_u8`` is Pillow's own resize, and
  without Pillow too it raises.
"""

import io
import sys
import tracemalloc
import zlib

import numpy as np
import pytest
from PIL import Image

from depth_image_captioning_pub_tpu.serve import _decode_bytes
from depth_image_captioning_pub_torch.data import image_io, native_loader
from depth_image_captioning_pub_torch.data.image_io import (
    ImageDecodeError, decode_image, decode_image_bytes, resize_u8)

COLOR_TYPES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (len(body).to_bytes(4, "big") + ctype + body
            + zlib.crc32(ctype + body).to_bytes(4, "big"))


def _filtered(rows: np.ndarray, bpp: int, filters) -> bytes:
    """PNG scanlines of ``rows`` [H, row bytes], row y with filter
    ``filters[y % len(filters)]``."""
    rows = rows.astype(np.int16)
    out = []
    for y, x in enumerate(rows):
        f = filters[y % len(filters)]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int16), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int16), up[:-bpp]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - up),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        out.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes())
    return b"".join(out)


def _png(px: np.ndarray, color_type: int, filters=(0,), palette=None,
         depth=8, interlace=0) -> bytes:
    """Encode [H, W, C] uint8 samples as a PNG (two IDAT chunks)."""
    h, w, ch = px.shape
    header = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
              + bytes([depth, color_type, 0, 0, interlace]))
    data = zlib.compress(_filtered(px.reshape(h, w * ch), ch, filters))
    half = len(data) // 2
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    return (out + _chunk(b"IDAT", data[:half]) + _chunk(b"IDAT", data[half:])
            + _chunk(b"IEND", b""))


def _samples(color_type: int, hw=(23, 37), seed=0):
    """Pixels with a smooth half (small differences) and a noisy half, and
    a palette of 200 colours for colour type 3."""
    rng = np.random.default_rng(seed)
    h, w = hw
    ch = CHANNELS[color_type]
    px = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
    px[: h // 2] = (np.arange(w, dtype=np.int64)[None, :, None] * 7
                    + np.arange(h // 2)[:, None, None] * 3) % 256
    palette = None
    if color_type == 3:
        palette = rng.integers(0, 256, (200, 3), dtype=np.uint8)
        px = (px.astype(np.int64) % 200).astype(np.uint8)
    return px, palette


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _no_pillow(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
@pytest.mark.parametrize("color_type", sorted(COLOR_TYPES))
def test_png_equals_pillow(color_type, filters, monkeypatch):
    px, palette = _samples(color_type)
    data = _png(px, color_type, filters, palette)
    want = _pillow(data)
    assert Image.open(io.BytesIO(data)).mode == COLOR_TYPES[color_type]
    _no_pillow(monkeypatch)          # the port's reader needs none
    got = decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA"])
def test_png_written_by_pillow(mode):
    """Pillow's own files (its filter choice, one IDAT) at a camera's
    480x640."""
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    arr[:240] = np.linspace(0, 255, 640, dtype=np.uint8)[None, :, None]
    img = Image.fromarray(arr)
    img = img.quantize(100) if mode == "P" else img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    np.testing.assert_array_equal(decode_image(buf.getvalue()),
                                  _pillow(buf.getvalue()))


RESIZES = {
    "up": ((20, 30), (224, 224)),
    "down": ((480, 640), (224, 224)),
    "non_integer_down": ((101, 77), (33, 50)),
    "non_integer_up": ((33, 50), (101, 77)),
    "one_way_each": ((64, 200), (150, 90)),
    "width_only": ((40, 90), (40, 13)),
    "height_only": ((90, 40), (13, 40)),
    "same": ((5, 6), (5, 6)),
    "from_one_pixel": ((1, 1), (5, 7)),
    "from_one_row": ((1, 40), (224, 224)),
    "from_one_column": ((40, 1), (3, 3)),
    "to_one_pixel": ((224, 224), (1, 1)),
    "large_ratio": ((300, 2), (2, 300)),
}


@pytest.mark.parametrize("case", sorted(RESIZES))
def test_resize_equals_pillow(case):
    (h, w), (oh, ow) = RESIZES[case]
    arr = np.random.default_rng(h * 1000 + w).integers(
        0, 256, (h, w, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(arr).resize((ow, oh), Image.BILINEAR))
    got = resize_u8(arr, (oh, ow))
    assert got.shape == (oh, ow, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert got is not arr


@pytest.mark.parametrize("channels", [1, 2, 4])
def test_resize_other_channel_counts_per_band(channels):
    """Each channel is resampled as Pillow resamples an "L" band (no
    premultiplied alpha: the channels are independent)."""
    arr = np.random.default_rng(channels).integers(
        0, 256, (97, 61, channels), dtype=np.uint8)
    got = resize_u8(arr, (40, 150))
    for c in range(channels):
        want = np.asarray(Image.fromarray(arr[..., c]).resize(
            (150, 40), Image.BILINEAR))
        np.testing.assert_array_equal(got[..., c], want)


def test_resize_rejects_non_uint8():
    with pytest.raises(ValueError, match="uint8"):
        resize_u8(np.zeros((4, 4, 3), np.float32), (2, 2))
    with pytest.raises(ValueError, match="uint8"):
        resize_u8(np.zeros((0, 4, 3), np.uint8), (2, 2))


def test_resize_without_the_library(monkeypatch):
    """No g++: Pillow's own resize, the same bytes; without Pillow too,
    the error names both."""
    arr = np.random.default_rng(9).integers(0, 256, (480, 640, 3),
                                            dtype=np.uint8)
    want = resize_u8(arr, (224, 224))
    native_loader._load()
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_failed", True)
    np.testing.assert_array_equal(resize_u8(arr, (224, 224)), want)
    _no_pillow(monkeypatch)
    with pytest.raises(ImageDecodeError, match="native library.*Pillow"):
        resize_u8(arr, (224, 224))


def _jpeg(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _photo(seed, hw=(480, 640)):
    """Smooth content at a camera's size (JPEG's case)."""
    small = np.random.default_rng(seed).integers(0, 256, (30, 40, 3),
                                                 dtype=np.uint8)
    return np.asarray(Image.fromarray(small).resize(hw[::-1],
                                                    Image.BILINEAR))


JPEGS = {"q75": dict(quality=75), "q95": dict(quality=95),
         "444": dict(quality=90, subsampling=0),
         "gray": dict(quality=85, gray=True),
         "odd_size": dict(quality=85, hw=(201, 333))}


@pytest.mark.parametrize("case", sorted(JPEGS))
def test_jpeg_bytes_equal_jax_server(case):
    """Byte-equal: the native library's libjpeg and Pillow's decode a
    baseline JPEG to the same pixels (ISLOW DCT, fancy upsampling)."""
    assert native_loader.has_jpeg()
    kw = dict(JPEGS[case])
    arr = _photo(len(case), kw.pop("hw", (480, 640)))
    if kw.pop("gray", False):
        arr = arr[..., 0]
    data = _jpeg(arr, **kw)
    for hw in ((224, 224), (64, 96)):
        np.testing.assert_array_equal(decode_image_bytes(data, hw),
                                      _decode_bytes(data, hw))


@pytest.mark.parametrize("color_type", sorted(COLOR_TYPES))
def test_png_bytes_equal_jax_server(color_type):
    px, palette = _samples(color_type, hw=(120, 160), seed=color_type)
    data = _png(px, color_type, (0, 1, 2, 3, 4), palette)
    np.testing.assert_array_equal(decode_image_bytes(data, (224, 224)),
                                  _decode_bytes(data, (224, 224)))


def test_other_png_goes_to_pillow(monkeypatch):
    """A 16-bit PNG: Pillow's bytes; without Pillow, the error names the
    bit depth and Pillow. An interlaced one is refused the same way."""
    arr = (np.arange(12 * 9, dtype=np.uint16).reshape(12, 9) * 600)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    data = buf.getvalue()
    assert data[24] == 16                  # IHDR's bit depth
    np.testing.assert_array_equal(decode_image(data), _pillow(data))
    px, _ = _samples(2)
    interlaced = _png(px, 2, interlace=1)
    _no_pillow(monkeypatch)
    with pytest.raises(ImageDecodeError, match="16-bit PNG.*Pillow is not"):
        decode_image(data)
    with pytest.raises(ImageDecodeError, match="interlaced PNG.*Pillow"):
        decode_image(interlaced)


def test_jpeg_without_libjpeg(monkeypatch):
    """A library built without libjpeg (the card's machine has no
    jpeglib.h): JPEG bodies go to Pillow, the same bytes; without Pillow
    too, the error names both."""
    data = _jpeg(_photo(3), quality=90)
    monkeypatch.setattr(native_loader, "has_jpeg", lambda: False)
    monkeypatch.setattr(native_loader, "jpeg_decode_mem", lambda d: None)
    np.testing.assert_array_equal(decode_image_bytes(data, (224, 224)),
                                  _decode_bytes(data, (224, 224)))
    _no_pillow(monkeypatch)
    with pytest.raises(ImageDecodeError,
                       match="without libjpeg.*Pillow is not installed"):
        decode_image(data)


def test_other_formats(monkeypatch):
    buf = io.BytesIO()
    arr = np.random.default_rng(4).integers(0, 256, (20, 30, 3),
                                            dtype=np.uint8)
    Image.fromarray(arr).save(buf, format="BMP")
    np.testing.assert_array_equal(decode_image(buf.getvalue()), arr)
    _no_pillow(monkeypatch)
    with pytest.raises(ImageDecodeError, match="neither PNG nor JPEG"):
        decode_image(b"not an image")


def test_corrupt_png_raises():
    px, _ = _samples(2)
    data = bytearray(_png(px, 2, (1,)))
    good = bytes(data)
    data[40] ^= 0xFF                       # inside IDAT: its CRC fails
    with pytest.raises(ImageDecodeError, match="bad CRC"):
        decode_image(bytes(data))
    with pytest.raises(ImageDecodeError, match="truncated PNG"):
        decode_image(good[:-12])           # no IEND
    header_only = good[:33] + _chunk(b"IDAT", b"junk") + _chunk(b"IEND",
                                                                b"")
    with pytest.raises(ImageDecodeError, match="corrupt PNG"):
        decode_image(header_only)
    short = good[:33] + _chunk(b"IDAT", zlib.compress(b"\x00" * 10)) \
        + _chunk(b"IEND", b"")
    with pytest.raises(ImageDecodeError, match="ends early"):
        decode_image(short)
    bad_filter = good[:33] + _chunk(b"IDAT", zlib.compress(
        b"\x07" * (23 * (1 + 37 * 3)))) + _chunk(b"IEND", b"")
    with pytest.raises(ValueError, match="filter type"):
        decode_image(bad_filter)


def test_module_needs_no_pillow_at_import():
    src = image_io.__file__
    with open(src) as f:
        text = f.read()
    assert "\nfrom PIL" not in text and "\nimport PIL" not in text


def _header_png(w: int, h: int, stream: bytes, color_type: int = 2) -> bytes:
    header = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
              + bytes([8, color_type, 0, 0, 0]))
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", stream) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("wh", [(20000, 20000), (2 ** 30, 1), (1, 2 ** 31 - 1),
                                (2 ** 31 - 1, 2 ** 31 - 1)],
                         ids=["square", "one_wide_row", "one_tall_column",
                              "largest"])
def test_png_bomb_refused_from_its_header(wh, monkeypatch):
    """A header past Pillow's pixel limit over a stream of zeros (a few kB
    that would inflate to gigabytes): refused, as Pillow refuses it,
    before anything is inflated."""
    data = _header_png(*wh, zlib.compress(b"\x00" * (1 << 20), 9))
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    monkeypatch.setattr(zlib, "decompressobj", None)   # never reached
    with pytest.raises(ImageDecodeError, match="decompression bomb"):
        decode_image(data)
    with pytest.raises(ImageDecodeError, match="decompression bomb"):
        decode_image_bytes(data, (224, 224))


def test_png_of_no_pixels_refused():
    for wh in ((0, 5), (5, 0)):
        with pytest.raises(ImageDecodeError, match="size"):
            decode_image(_header_png(*wh, zlib.compress(b"\x00" * 6)))


def test_png_stream_inflated_no_further_than_its_header():
    """A 16x16 image whose stream goes on with 256 MB of zeros (about
    250 kB of deflate): decoded as Pillow decodes it (it ignores what
    follows the image) and never inflated past the 784 bytes the header
    states: the decode's peak of traced memory stays under 8 MB."""
    px, _ = _samples(2, hw=(16, 16), seed=5)
    rows = _filtered(px.reshape(16, 48), 3, (0, 1, 2, 3, 4))
    comp = zlib.compressobj(9)
    stream = comp.compress(rows)
    zeros = b"\x00" * (1 << 24)
    for _ in range(16):
        stream += comp.compress(zeros)
    stream += comp.flush()
    data = _header_png(16, 16, stream)
    assert len(data) < (1 << 20)
    tracemalloc.start()
    try:
        got = decode_image(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(got, _pillow(data))
    assert peak < (8 << 20), peak


def _sof_resized(data: bytes, h: int, w: int) -> bytes:
    """The JPEG with its frame header (SOF0) stating h x w."""
    at = data.index(b"\xff\xc0")
    return (data[:at + 5] + h.to_bytes(2, "big") + w.to_bytes(2, "big")
            + data[at + 9:])


def test_jpeg_bomb_refused_from_its_header(monkeypatch):
    """A JPEG whose frame header states 60000 x 60000 (10.8 GB of RGB):
    refused from the header, as Pillow refuses it, before the decode
    allocates its output."""
    data = _sof_resized(_jpeg(_photo(4, (32, 32)), quality=90), 60000,
                        60000)
    assert native_loader.jpeg_size(data) == (60000, 60000)
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    monkeypatch.setattr(native_loader, "jpeg_decode_mem", None)  # unreached
    with pytest.raises(ImageDecodeError, match="decompression bomb"):
        decode_image(data)
