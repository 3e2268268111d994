"""Shared pieces of the plain reference: how values are rounded before a
layer reads them, and the TF32 switch.

The reference computes in float32 with TF32 off. ``Rounding`` says to which
precision the values a layer reads (inputs and weights) are rounded first:
``"f32"`` keeps them, ``"bf16"`` rounds to bfloat16, ``"fp8"`` to float8
e4m3 with one scale per tensor (the amax over 448, as an fp8 GEMM scales
its operands). The lower roundings make the control: the reference in the
precision below the one a configuration states.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

F32 = torch.float32
FP8_MAX = 448.0


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale, back in float32."""
    t = t.to(F32)
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(F32) * scale


class Rounding:
    """Rounds a tensor to ``name``'s precision; values stay float32."""

    NAMES = ("f32", "bf16", "fp8")

    def __init__(self, name: str = "f32"):
        if name not in self.NAMES:
            raise ValueError(f"rounding {name!r} is not one of {self.NAMES}")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return t.to(F32)
        if self.name == "bf16":
            return t.to(torch.bfloat16).to(F32)
        return round_fp8(t)

    def __repr__(self) -> str:
        return f"Rounding({self.name!r})"


@contextlib.contextmanager
def tf32(enabled: bool) -> Iterator[None]:
    """cuBLAS's and cuDNN's TF32 switches set to ``enabled`` in the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
