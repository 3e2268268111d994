"""Build the package's CUDA kernels with nvcc and bind them through ctypes.

The sources under ``csrc/`` have a plain C interface, so one ``nvcc`` call
compiles them into a shared library in seconds (no PyTorch headers). The
library lands in ``build/dcap_torch_kernels/<hash of sources and flags>/``
at the root of the checkout, at first use, and is reused while the sources
are unchanged. Nothing is fetched; a missing ``nvcc`` or a failed build
raises (the CUDA path never falls back to the plain PyTorch versions).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
SOURCES = ("decode_step.cu", "decode_seq.cu")
HEADERS = ("decode_step.cuh",)
BUILD_ROOT = PKG_DIR.parent / "build" / "dcap_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argument lists of the C entry points, pointers and the stream as void*
# (a ctypes int would cut a 64-bit pointer)
_SIGNATURES = {
    "dcap_decode_step": [_P, _I] + [_P] * 17 + [_I] * 6 + [_P],
    "dcap_greedy_decode": [_P, _I] + [_P] * 17 + [_I] * 10 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_LOG = ""       # nvcc's output (ptxas register/spill report) of the build
BUILD_SECONDS = 0.0  # 0.0 when the library was already built


def nvcc_path() -> str:
    """The nvcc to build with: $CUDA_HOME/bin, /usr/local/cuda/bin, PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "libdcap_kernels.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; returns it."""
    global BUILD_LOG, BUILD_SECONDS
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *[str(CSRC / s) for s in SOURCES]]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_SECONDS = time.perf_counter() - t0
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{BUILD_LOG}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with argtypes declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.dcap_error_string.argtypes = [ctypes.c_int]
            lib.dcap_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check_launch(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        what = load().dcap_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({what})")
