"""The msgpack format of the JAX package's checkpoint files, without the
``msgpack``, ``flax`` or ``ml_dtypes`` packages (the counterpart of the
part of ``flax.serialization`` that ``utils/checkpoint.py`` uses).

The files hold one msgpack map: nested maps with ``str`` keys whose leaves
are arrays. The wire format (https://github.com/msgpack/msgpack/blob/master
/spec.md) is read and written in full for the types flax writes: nil,
bool, every int and float width, str and bin 8/16/32, array and map
16/32, the fix forms and ext 8/16/32 with the fixext forms. Two ext codes
carry numpy data, as flax defines them:

* 1, an array: the payload is itself msgpack, ``[shape, dtype name,
  C-order bytes]``, decoded with ``np.frombuffer`` on the file's buffer
  (no copy, no per-element Python);
* 3, a numpy scalar: the same payload for a 0-d array.

Every other ext code raises ``ValueError``. A leaf larger than
``MAX_CHUNK_SIZE`` bytes is written, as flax writes it, as a map
``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...}, "chunks":
{"0": flat0, ...}}``, and read back as one array.

numpy has no bfloat16, so a ``"bfloat16"`` leaf is read as its uint16 bit
patterns in a ``BFloat16Bits`` array; ``bf16_tensor`` makes the
``torch.bfloat16`` tensor with the same bits, and ``packb`` writes a
``BFloat16Bits`` leaf back under the name ``"bfloat16"``.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30     # flax.serialization's chunking threshold
CHUNKED = "__msgpack_chunked_array__"


class BFloat16Bits(np.ndarray):
    """A uint16 array of bfloat16 bit patterns."""


def bf16_tensor(bits: np.ndarray):
    """The ``torch.bfloat16`` tensor whose bits are ``bits``."""
    import torch
    return torch.from_numpy(
        np.array(bits, dtype=np.uint16).view(np.int16)).view(torch.bfloat16)


# ---- decoding ---------------------------------------------------------------

_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
          0xca: ">f", 0xcb: ">d"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


def _length(view: memoryview, pos: int, width: int) -> Tuple[int, int]:
    return struct.unpack_from(_LEN[width], view, pos)[0], pos + width


def _decode(view: memoryview, pos: int, bin_view: bool = False
            ) -> Tuple[Any, int]:
    """(object, position after it). ``bin_view``: bin data stays a
    memoryview of ``view`` instead of being copied to ``bytes``."""
    b = view[pos]
    pos += 1
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f:
        return _map(view, pos, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return _array(view, pos, b & 0x0f)
    if 0xa0 <= b <= 0xbf:
        return _str(view, pos, b & 0x1f)
    if b == 0xc0:
        return None, pos
    if b in (0xc2, 0xc3):
        return b == 0xc3, pos
    if b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack_from(fmt, view, pos)[0], pos + struct.calcsize(
            fmt)
    if b in (0xc4, 0xc5, 0xc6):                       # bin 8/16/32
        n, pos = _length(view, pos, 1 << (b - 0xc4))
        data = view[pos:pos + n]
        return (data if bin_view else bytes(data)), pos + n
    if b in (0xd9, 0xda, 0xdb):                       # str 8/16/32
        n, pos = _length(view, pos, 1 << (b - 0xd9))
        return _str(view, pos, n)
    if b in (0xdc, 0xdd):                             # array 16/32
        n, pos = _length(view, pos, 2 << (b - 0xdc))
        return _array(view, pos, n)
    if b in (0xde, 0xdf):                             # map 16/32
        n, pos = _length(view, pos, 2 << (b - 0xde))
        return _map(view, pos, n)
    if 0xd4 <= b <= 0xd8:                             # fixext 1..16
        return _ext(view, pos + 1, view[pos], 1 << (b - 0xd4))
    if b in (0xc7, 0xc8, 0xc9):                       # ext 8/16/32
        n, pos = _length(view, pos, 1 << (b - 0xc7))
        return _ext(view, pos + 1, view[pos], n)
    raise ValueError(f"msgpack: byte 0x{b:02x} at {pos - 1} starts no "
                     f"object")


def _str(view, pos, n):
    return bytes(view[pos:pos + n]).decode("utf-8"), pos + n


def _array(view, pos, n):
    out = []
    for _ in range(n):
        item, pos = _decode(view, pos)
        out.append(item)
    return out, pos


def _map(view, pos, n):
    out = {}
    for _ in range(n):
        key, pos = _decode(view, pos)
        out[key], pos = _decode(view, pos)
    return out, pos


def _ext(view, pos, code, n):
    code = code - 0x100 if code >= 0x80 else code     # the type is int8
    end = pos + n
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"msgpack: ext type {code} is not an array (flax "
                         f"writes ext 1 and 3)")
    payload = view[pos:end]
    (shape, name, data), used = _decode(payload, 0, bin_view=True)
    if used != n:
        raise ValueError("msgpack: array payload longer than its header")
    if name == "bfloat16":
        arr = np.frombuffer(data, np.uint16).view(BFloat16Bits)
    else:
        arr = np.frombuffer(data, np.dtype(name))
    arr = arr.reshape(shape)
    return (arr if code == EXT_NDARRAY else arr[()]), end


def _unchunk(tree):
    """flax's chunked-array maps -> arrays, in the maps of ``tree``."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        flat = np.concatenate(chunks)
        if isinstance(chunks[0], BFloat16Bits):
            flat = flat.view(BFloat16Bits)
        return flat.reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data) -> Any:
    """Decode one msgpack object (``bytes`` or any buffer), flax's chunked
    arrays joined. Array leaves are read-only views of ``data``."""
    view = memoryview(data).cast("B")
    obj, pos = _decode(view, 0)
    if pos != len(view):
        raise ValueError(f"msgpack: {len(view) - pos} bytes after the "
                         f"object")
    return _unchunk(obj)


# ---- encoding ---------------------------------------------------------------

def _header(parts: List[bytes], n: int, fix: int, fix_max: int,
            codes: Tuple[int, ...], widths: Tuple[int, ...]) -> None:
    """The smallest form that holds the length ``n``, as msgpack-python
    picks it."""
    if fix_max and n <= fix_max:
        parts.append(bytes([fix | n]))
        return
    for code, width in zip(codes, widths):
        if n < 1 << (8 * width):
            parts.append(bytes([code]) + n.to_bytes(width, "big"))
            return
    raise ValueError(f"msgpack: length {n} is too large")


def _int(parts: List[bytes], x: int) -> None:
    if 0 <= x <= 0x7f or -0x20 <= x < 0:
        parts.append(struct.pack(">b" if x < 0 else ">B", x))
    elif x > 0:
        for code, fmt in ((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"),
                          (0xcf, ">Q")):
            if x < 1 << (8 * struct.calcsize(fmt)):
                parts.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"msgpack: int {x} is too large")
    else:
        for code, fmt in ((0xd0, ">b"), (0xd1, ">h"), (0xd2, ">i"),
                          (0xd3, ">q")):
            if x >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                parts.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"msgpack: int {x} is too small")


def _array_payload(arr: np.ndarray) -> bytes:
    name = "bfloat16" if isinstance(arr, BFloat16Bits) else arr.dtype.name
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"msgpack: cannot write a {arr.dtype} array")
    parts: List[bytes] = []
    _encode(parts, [list(arr.shape), name, arr.tobytes("C")])
    return b"".join(parts)


def _ext_out(parts: List[bytes], code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        parts.append(bytes([fixed[n], code]))
    else:
        _header(parts, n, 0, 0, (0xc7, 0xc8, 0xc9), (1, 2, 4))
        parts.append(bytes([code]))
    parts.append(payload)


def _chunk(arr: np.ndarray) -> dict:
    """flax's chunked form of a leaf over ``MAX_CHUNK_SIZE`` bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[lo:lo + size] for i, lo in
                       enumerate(range(0, flat.size, size))}}


def _encode(parts: List[bytes], x: Any, chunk: bool = False) -> None:
    if x is None:
        parts.append(b"\xc0")
    elif x is True or x is False:
        parts.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, np.ndarray):
        if chunk and x.size * x.dtype.itemsize > MAX_CHUNK_SIZE:
            _encode(parts, _chunk(x), chunk)
        else:
            _ext_out(parts, EXT_NDARRAY, _array_payload(x))
    elif isinstance(x, np.generic):
        _ext_out(parts, EXT_NPSCALAR, _array_payload(np.asarray(x)))
    elif isinstance(x, int):
        _int(parts, x)
    elif isinstance(x, float):
        parts.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _header(parts, len(data), 0xa0, 31, (0xd9, 0xda, 0xdb), (1, 2, 4))
        parts.append(data)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        data = bytes(x)
        _header(parts, len(data), 0, 0, (0xc4, 0xc5, 0xc6), (1, 2, 4))
        parts.append(data)
    elif isinstance(x, (list, tuple)):
        _header(parts, len(x), 0x90, 15, (0xdc, 0xdd), (2, 4))
        for item in x:
            _encode(parts, item, chunk)
    elif isinstance(x, dict):
        _header(parts, len(x), 0x80, 15, (0xde, 0xdf), (2, 4))
        for key, val in x.items():
            _encode(parts, key, chunk)
            _encode(parts, val, chunk)
    else:
        raise TypeError(f"msgpack: cannot write a {type(x).__name__}")


def packb(obj: Any) -> bytes:
    """Encode ``obj`` as flax's ``msgpack_serialize`` does: arrays as ext
    1, numpy scalars as ext 3, arrays over ``MAX_CHUNK_SIZE`` bytes in the
    chunked form."""
    parts: List[bytes] = []
    _encode(parts, obj, chunk=True)
    return b"".join(parts)
