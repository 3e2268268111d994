"""The package's kernels as PyTorch operators in the ``dcap`` namespace.

    dcap::decode_step         K1, ``decode_step.fused_decode_core``
    dcap::greedy_decode       K2, ``decode_seq.fused_greedy_decode``
    dcap::nic_greedy_decode   K3, ``nic_seq.fused_nic_greedy_decode``
    dcap::beam_decode         K4, ``beam_seq.fused_beam_decode``
    dcap::vit_attention       K5, ``vit_attention.fused_attention``
    dcap::group_norm_nhwc     K6, ``group_norm.group_norm_nhwc``

Its kernel module defines each operator (``implement``), so it exists
once the module is imported, with two implementations and a fake rule:
for CPU tensors the plain PyTorch version, for CUDA tensors the
hand-written kernel (padding, planning, the ctypes launch and the
``LAUNCHES`` counter), and for fake tensors the kernel's output shapes and
dtypes, which is all that ``torch.export`` sees of it.
No other device is registered, so a tensor on another device raises in
the dispatcher. The public wrappers check their arguments and call the
operator; weight structs go in as ``Tensor[]``.

An exported program (``export.py``) keeps each operator as one node, so
one artifact runs the kernels on the card and the plain versions on the
CPU. Loading such a program needs the operators registered:
``register_all()`` imports the kernel modules.
"""

from __future__ import annotations

import importlib
from typing import Callable

import torch

LIB = torch.library.Library("dcap", "DEF")

SCHEMAS = {
    "decode_step": "decode_step(Tensor features, Tensor features_proj, "
                   "Tensor emb, Tensor h, Tensor c, Tensor[] w) "
                   "-> (Tensor, Tensor, Tensor)",
    "greedy_decode": "greedy_decode(Tensor features, Tensor features_proj, "
                     "Tensor h0, Tensor c0, Tensor[] w, int max_length, "
                     "int start_id, int end_id) -> Tensor",
    "nic_greedy_decode": "nic_greedy_decode(Tensor x0, Tensor[] w, "
                         "int max_length) -> Tensor",
    "beam_decode": "beam_decode(Tensor features, Tensor features_proj, "
                   "Tensor h0, Tensor c0, Tensor[] w, int beam_size, "
                   "int max_length, int start_id, int end_id) "
                   "-> (Tensor, Tensor, Tensor)",
    "vit_attention": "vit_attention(Tensor q, Tensor k, Tensor v, "
                     "float scale, int n_valid) -> Tensor",
    "group_norm_nhwc": "group_norm_nhwc(Tensor x, Tensor weight, "
                       "Tensor bias, Tensor? residual, int groups, "
                       "float eps, bool relu) -> Tensor",
}

MODULES = ("decode_step", "decode_seq", "nic_seq", "beam_seq",
           "vit_attention", "group_norm")


def implement(name: str, cpu: Callable, cuda: Callable,
              fake: Callable) -> None:
    """Define operator ``dcap::name`` (``SCHEMAS``) with its CPU and CUDA
    implementations and its fake rule."""
    LIB.define(SCHEMAS[name])
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"dcap::{name}", fake, lib=LIB)


def register_all() -> None:
    """Import every kernel module, which registers its operator."""
    for mod in MODULES:
        importlib.import_module(
            f"depth_image_captioning_pub_torch.ops.kernels.{mod}")
