"""Initializers with torch's default distributions (counterpart of the JAX
``models/initializers.py``), drawn from an explicit ``torch.Generator``.

Each returns a float32 CPU tensor; modules copy it into their parameters,
which casts to the parameter's device and dtype. The JAX package and this
one draw different numbers from the same seed: tests that compare the two
share weights through ``utils/jax_bridge.py`` instead.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Init = Callable[[Sequence[int], torch.Generator], torch.Tensor]


def _uniform(shape: Sequence[int], bound: float,
             generator: torch.Generator) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=torch.float32).uniform_(
        -bound, bound, generator=generator)


def torch_linear_kernel(shape: Sequence[int],
                        generator: torch.Generator) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)); shape [in, out] (JAX layout)."""
    return _uniform(shape, 1.0 / math.sqrt(shape[0]), generator)


def torch_conv_kernel(shape: Sequence[int],
                      generator: torch.Generator) -> torch.Tensor:
    """Conv weight [out_c, in_c, kh, kw]; fan_in = in_c*kh*kw."""
    fan_in = shape[1] * shape[2] * shape[3]
    return _uniform(shape, 1.0 / math.sqrt(fan_in), generator)


def torch_bias(fan_in: int) -> Init:
    bound = 1.0 / math.sqrt(fan_in)
    return lambda shape, generator: _uniform(shape, bound, generator)


def uniform_pm(scale: float) -> Init:
    """U(-scale, scale): embedding / vocab-head init."""
    return lambda shape, generator: _uniform(shape, scale, generator)


def normal(std: float) -> Init:
    """N(0, std^2): torch's nn.Embedding default (NIC's embedding)."""
    return lambda shape, generator: torch.empty(
        tuple(shape), dtype=torch.float32).normal_(0.0, std,
                                                   generator=generator)
