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


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 accumulation and an f32 result, for bf16 operands
    (the JAX package's ``jnp.dot(..., preferred_element_type=f32)``): the
    operands are upcast exactly, and each product of two bf16 values is
    exact in f32. On a CUDA device the product may take TF32 here, since
    TF32's 10-bit mantissa holds every bf16 value (7 bits): the tensor
    cores then compute exactly the f32 products, with f32 accumulation.
    Operands of other dtypes are promoted to f32 and multiplied under the
    caller's TF32 setting (``full_f32`` in the steps)."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    if not (a.is_cuda and a.dtype == b.dtype == torch.bfloat16):
        return a32 @ b32
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return a32 @ b32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
