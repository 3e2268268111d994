"""ctypes binding for the native image library
(``depth_image_captioning_pub_torch/native/fastimage.cpp``): the batch JPEG
file decoder of the JAX package's ``data/native_loader.py``, a JPEG decode
of bytes in memory, the PNG row unfilter and Pillow's bilinear resize.

The library is built with g++ at first use into
``build/dcap_torch_native/<hash of the source and flags>/`` at the root of
the checkout (no pybind11: the C ABI and ctypes keep the binding free of
dependencies), and built again where one found there does not load (a copy
from a machine with libjpeg on one without). Where libjpeg's headers or library are missing it is built
without its JPEG part (``has_jpeg()`` is False); where g++ is missing
there is no library (``available()`` is False). ``decode_batch`` then falls
back per file, as the JAX loader does: ``data/image_io.decode_image_bytes``
reads PNGs itself and hands what it does not read to Pillow where Pillow
is importable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SRC = PKG_DIR / "native" / "fastimage.cpp"
BUILD_ROOT = PKG_DIR.parent / "build" / "dcap_torch_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False

_U8P = ctypes.POINTER(ctypes.c_uint8)
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "fastimage_has_jpeg": [],
    "fastimage_decode_batch": [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                               _U8P, ctypes.c_int, ctypes.c_int, _U8P,
                               ctypes.c_int],
    "fastimage_jpeg_mem_info": [ctypes.c_char_p, ctypes.c_size_t, _IP, _IP],
    "fastimage_jpeg_mem_decode": [ctypes.c_char_p, ctypes.c_size_t, _U8P,
                                  ctypes.c_int, ctypes.c_int],
    "fastimage_png_unfilter": [_U8P, ctypes.c_size_t, ctypes.c_size_t,
                               ctypes.c_size_t, _U8P],
    "fastimage_resample_bilinear": [_U8P, ctypes.c_size_t, ctypes.c_size_t,
                                    ctypes.c_size_t, _U8P, ctypes.c_size_t,
                                    ctypes.c_size_t],
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libfastimage.so"


def _build(out: Path) -> bool:
    """g++ with libjpeg, else without its JPEG part; False when neither
    builds. The library is written under a temporary name and renamed, so
    a concurrent build sees all of it or none."""
    out.parent.mkdir(parents=True, exist_ok=True)
    attempts = (["-ljpeg", "-lpthread"], ["-DFASTIMAGE_NO_JPEG", "-lpthread"])
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = os.path.join(tmp, "lib.so")
        for extra in attempts:
            cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", lib, *extra]
            try:
                proc = subprocess.run(cmd, capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                return False
            if proc.returncode == 0:
                os.replace(lib, out)
                return True
    return False


def _open(out: Path) -> Optional[ctypes.CDLL]:
    try:
        return ctypes.CDLL(str(out))
    except OSError:
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        out = library_path()
        lib = _open(out) if out.is_file() else None
        # a library that does not load (built on another machine, against
        # a libjpeg this one lacks) is built again here
        if lib is None and _build(out):
            lib = _open(out)
        if lib is None:
            _failed = True
            return None
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library was built (g++ is there)."""
    return _load() is not None


def has_jpeg() -> bool:
    """Whether the library decodes JPEG (built against libjpeg)."""
    lib = _load()
    return lib is not None and bool(lib.fastimage_has_jpeg())


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


def jpeg_size(data: bytes) -> Optional[Tuple[int, int]]:
    """(height, width) of a JPEG held in memory, from its header alone,
    or None where the library cannot decode it."""
    if not has_jpeg():
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    if not _lib.fastimage_jpeg_mem_info(data, len(data), ctypes.byref(h),
                                        ctypes.byref(w)):
        return None
    return h.value, w.value


def jpeg_decode_mem(data: bytes) -> Optional[np.ndarray]:
    """A JPEG held in memory -> [H, W, 3] uint8 RGB at full scale (a gray
    JPEG replicated to three channels), or None where the library cannot
    decode it (no libjpeg, a corrupt stream, CMYK)."""
    size = jpeg_size(data)
    if size is None:
        return None
    out = np.empty((*size, 3), np.uint8)
    if not _lib.fastimage_jpeg_mem_decode(data, len(data), _u8(out), *size):
        return None
    return out


def png_unfilter(raw: np.ndarray, height: int, row_bytes: int,
                 bpp: int) -> Optional[np.ndarray]:
    """The PNG filters of ``height`` rows undone: ``raw`` is the inflated
    stream (a filter byte before each row of ``row_bytes``) -> [height,
    row_bytes] uint8, or None without the library. Raises on a filter type
    outside 0..4."""
    lib = _load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, np.uint8)
    if (height < 0 or not 1 <= bpp <= row_bytes
            or raw.size < height * (row_bytes + 1)):
        raise ValueError(f"png_unfilter: {raw.size} bytes for {height} rows "
                         f"of {row_bytes} (+1), bpp {bpp}")
    out = np.empty((height, row_bytes), np.uint8)
    if not lib.fastimage_png_unfilter(_u8(raw), height, row_bytes, bpp,
                                      _u8(out)):
        raise ValueError("corrupt PNG: a scanline filter type outside 0..4")
    return out


def resample_bilinear(arr: np.ndarray,
                      hw: Tuple[int, int]) -> Optional[np.ndarray]:
    """[H, W, C] uint8 -> [h, w, C] uint8, each channel as Pillow's
    ``Image.resize((w, h), BILINEAR)`` resamples a band, or None without
    the library."""
    lib = _load()
    if lib is None:
        return None
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = (int(v) for v in hw)
    out = np.empty((h, w, arr.shape[2]), np.uint8)
    if not lib.fastimage_resample_bilinear(_u8(arr), *arr.shape, _u8(out),
                                           h, w):
        raise ValueError(f"resample_bilinear: {arr.shape} -> {hw}")
    return out


def decode_batch(paths: Sequence[str], hw: Tuple[int, int],
                 threads: int = 4, on_error: str = "raise",
                 failed: Optional[list] = None) -> np.ndarray:
    """Decode+resize a batch of image files -> [N, H, W, 3] uint8.

    JPEGs go through the native loader (DCT-scaled decode + threaded), the
    same bytes as the JAX package's loader; a file it cannot handle (a PNG,
    a CMYK JPEG, any file where the library has no libjpeg) is read whole
    and decoded by ``image_io.decode_image_bytes`` (the port's PNG reader
    and Pillow's bilinear resize, else Pillow), as the JAX loader falls
    back to Pillow per file.

    ``on_error``: "raise" (default — a file neither decoder can read
    raises, matching the reference's eval behavior) or "zero" — the row
    stays zeros and the index is appended to ``failed`` (batch tools
    caption the rest instead of dying on one truncated file).
    """
    from depth_image_captioning_pub_torch.data.image_io import (
        decode_image_bytes)
    if on_error not in ("raise", "zero"):
        raise ValueError(f"on_error must be 'raise' or 'zero': {on_error}")
    n = len(paths)
    h, w = hw
    out = np.zeros((n, h, w, 3), dtype=np.uint8)
    ok = np.zeros((n,), dtype=np.uint8)
    if has_jpeg() and n:
        c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        _lib.fastimage_decode_batch(c_paths, n, _u8(out), h, w, _u8(ok),
                                    threads)
    for i in range(n):
        if ok[i]:
            continue
        try:
            with open(paths[i], "rb") as f:
                out[i] = decode_image_bytes(f.read(), hw)
        except Exception:
            if on_error == "raise":
                raise
            if failed is not None:
                failed.append(i)
    return out
