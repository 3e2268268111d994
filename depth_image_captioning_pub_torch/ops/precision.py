"""Full float32 arithmetic for the port's f32 work.

PyTorch leaves cuDNN's TF32 on by default (``torch.backends.cudnn.
allow_tf32``), and a caller may turn cuBLAS's on (``torch.backends.cuda.
matmul.allow_tf32``). TF32 keeps about three decimal digits, which moves
greedy argmaxes off the reference, so the f32 encoder convs and the
decoder's f32 products run inside ``full_f32()``: both flags off within
the block, the caller's values back after it (also on an exception).
Usable as a context manager or as a decorator.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    matmul = torch.backends.cuda.matmul.allow_tf32
    conv = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = conv
