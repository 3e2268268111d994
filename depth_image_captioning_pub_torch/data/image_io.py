"""Encoded image bytes to the model's uint8 input, with no Pillow needed
(the port's counterpart of the JAX ``serve._decode_bytes`` and of the
resize in ``CaptionPipeline._to_arrays``, which call Pillow).

* ``decode_image(data)``: PNG (8-bit gray, RGB, palette, gray+alpha and
  RGBA; not interlaced) is inflated with ``zlib``, unfiltered by the native
  library (``native_loader.png_unfilter``) and converted as Pillow's
  ``convert("RGB")`` converts it: gray replicated, palette looked up, alpha
  dropped. JPEG is decoded at full scale by the native library's libjpeg.
  Anything else, a PNG of another bit depth or an interlaced one, and a
  JPEG where the library has no libjpeg go to Pillow where Pillow is
  importable; otherwise ``ImageDecodeError`` names what is missing.
* Untrusted bytes are held to Pillow's decompression-bomb limit: an image
  of more than ``MAX_IMAGE_PIXELS`` pixels is refused from its header,
  before anything is inflated or allocated, and a PNG's stream is
  inflated to the size its header states and no further (what follows is
  ignored, as Pillow ignores it).
* ``resize_u8(arr, hw)``: Pillow's ``Image.resize((w, h), BILINEAR)`` byte
  for byte, in the native library (``native_loader.resample_bilinear``),
  else in Pillow.
* ``decode_image_bytes(data, hw)``: the two together, what the server does
  with a request's body.
"""

from __future__ import annotations

import zlib
from typing import Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples
# Pillow raises DecompressionBombError above twice Image.MAX_IMAGE_PIXELS
MAX_IMAGE_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


class ImageDecodeError(ValueError):
    """The bytes cannot be decoded here: the message says why."""


class _Unsupported(Exception):
    """A valid image this reader does not take (Pillow may)."""


def _png_chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            break
        if zlib.crc32(ctype + body) != int.from_bytes(crc, "big"):
            raise ImageDecodeError(f"corrupt PNG: bad CRC in chunk "
                                   f"{ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + n
    raise ImageDecodeError("truncated PNG: no IEND chunk")


def check_size(h: int, w: int) -> None:
    """Refuse an image of no pixels or of more than ``MAX_IMAGE_PIXELS``
    (a decompression bomb), from the size its header states."""
    if h < 1 or w < 1:
        raise ImageDecodeError(f"corrupt image: size {w}x{h}")
    if h * w > MAX_IMAGE_PIXELS:
        raise ImageDecodeError(f"image size ({h * w} pixels) exceeds limit "
                               f"of {MAX_IMAGE_PIXELS} pixels, could be "
                               f"decompression bomb")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8, as Pillow's ``convert("RGB")``."""
    from depth_image_captioning_pub_torch.data import native_loader
    header, palette, idat = None, None, []
    for ctype, body in _png_chunks(data):
        if ctype == b"IHDR":
            header = body
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None or len(header) != 13:
        raise ImageDecodeError("corrupt PNG: no IHDR chunk")
    w, h = int.from_bytes(header[:4], "big"), int.from_bytes(header[4:8],
                                                             "big")
    check_size(h, w)
    depth, ctype, interlace = header[8], header[9], header[12]
    if ctype not in PNG_CHANNELS:
        raise ImageDecodeError(f"corrupt PNG: colour type {ctype}")
    if depth != 8:
        raise _Unsupported(f"a {depth}-bit PNG")
    if interlace:
        raise _Unsupported("an interlaced PNG")
    if ctype == 3 and palette is None:
        raise ImageDecodeError("corrupt PNG: palette image without PLTE")
    ch = PNG_CHANNELS[ctype]
    size = h * (1 + w * ch)      # a filter byte before each row
    try:   # never more than the header's size, whatever the stream holds
        raw = zlib.decompressobj().decompress(b"".join(idat), size)
    except zlib.error as e:
        raise ImageDecodeError(f"corrupt PNG: {e}") from e
    if len(raw) < size:
        raise ImageDecodeError("truncated PNG: image data ends early")
    rows = native_loader.png_unfilter(np.frombuffer(raw, np.uint8), h,
                                      w * ch, ch)
    if rows is None:
        raise _Unsupported("a PNG without the native library (g++)")
    px = rows.reshape(h, w, ch)
    if ctype == 3:     # indices past the palette read as black
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    if ch <= 2:        # gray, gray+alpha
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _pillow_rgb(data: bytes, why: str) -> np.ndarray:
    try:
        import io

        from PIL import Image
    except ImportError:
        raise ImageDecodeError(f"cannot decode {why}: Pillow is not "
                               f"installed") from None
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def decode_image(data: bytes) -> np.ndarray:
    """Encoded bytes -> [H, W, 3] uint8 RGB at the image's own size."""
    from depth_image_captioning_pub_torch.data import native_loader
    data = bytes(data)
    if data.startswith(PNG_SIGNATURE):
        try:
            return decode_png(data)
        except _Unsupported as e:
            return _pillow_rgb(data, str(e))
    if data.startswith(JPEG_SIGNATURE):
        size = native_loader.jpeg_size(data)
        if size is not None:
            check_size(*size)
            arr = native_loader.jpeg_decode_mem(data)
            if arr is not None:
                return arr
        why = ("a JPEG libjpeg did not decode" if native_loader.has_jpeg()
               else "a JPEG without libjpeg in the native library")
        return _pillow_rgb(data, why)
    return _pillow_rgb(data, "an image that is neither PNG nor JPEG")


def resize_u8(arr: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """[H, W, C] uint8 -> [h, w, C] uint8, the bytes of Pillow's
    ``Image.fromarray(arr).resize((w, h), Image.BILINEAR)``, each channel
    resampled as Pillow resamples a band: by the native library, else by
    Pillow itself; without either it raises ``ImageDecodeError``."""
    from depth_image_captioning_pub_torch.data import native_loader
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or arr.ndim != 3 or 0 in arr.shape:
        raise ValueError(f"expected uint8 [H, W, C], got {arr.dtype} "
                         f"{arr.shape}")
    h, w = hw
    if (h, w) == arr.shape[:2]:
        return arr.copy()
    out = native_loader.resample_bilinear(arr, (h, w))
    if out is not None:
        return out
    try:
        from PIL import Image
    except ImportError:
        raise ImageDecodeError("cannot resize: neither the native library "
                               "(g++) nor Pillow is there") from None
    return np.stack([np.asarray(Image.fromarray(arr[..., c]).resize(
        (w, h), Image.BILINEAR)) for c in range(arr.shape[2])], axis=-1)


def decode_image_bytes(data: bytes, hw: Tuple[int, int]) -> np.ndarray:
    """Encoded PNG/JPEG bytes -> [h, w, 3] uint8 at ``hw``: what the JAX
    ``serve._decode_bytes`` computes with Pillow."""
    return resize_u8(decode_image(data), hw)
