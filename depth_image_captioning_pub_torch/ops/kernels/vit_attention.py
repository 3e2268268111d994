"""Fused ViT attention: CUDA kernel wrapper and plain version.

Counterpart of the JAX ``ops/pallas/vit_attention.py``. Over q/k/v
[Z, N, d] (Z = batch * heads):

  s   = q @ k^T * scale            f32, keys >= n_valid set to -inf
  p   = softmax(s)                 f32, then rounded to v's dtype
  out = p @ v                      f32 accumulation, stored in v's dtype

``fused_attention`` launches ``csrc/vit_attention.cu`` for CUDA tensors
and ``fused_attention_plain`` for CPU tensors, through operator
``dcap::vit_attention`` (``library.py``). The kernel takes d in (32,
64, 128). bf16 runs on the tensor cores (one CTA per z and tile of 128
query rows, 64 at d=128; two passes over the key tiles, no score rows
kept) at any N >= 1. f32 runs on the CUDA cores with a tile of 32 query
rows' score rows in shared memory, so its n_valid is bounded by the 227 KB
a block may use (about 1,490 at d=64); the wrapper raises outside that
envelope, as the Pallas kernel asserts its VMEM budget.
"""

from __future__ import annotations

import torch

from depth_image_captioning_pub_torch.ops.kernels import _build, library
from depth_image_captioning_pub_torch.ops.kernels.decode_step import (
    FEATURE_DTYPES, check_kernel_device, check_same_device, cuda_pointers)

LAUNCHES = 0   # kernel launches of dcap_vit_attention in this process

HEAD_DIMS = (32, 64, 128)
ROWS, TILE = 32, 128             # kRows, kTile of the f32 route
# kWarps, kBlocks, kKeys, kStages of the bf16 route
TC_WARPS, TC_BLOCKS, TC_KEYS, TC_STAGES = 4, 2, 64, 2
SMEM_LIMIT = 232448              # bytes of shared memory a block may use


def smem_bytes(d: int, n_valid: int, dtype: torch.dtype) -> int:
    """The kernel's dynamic shared memory (``smem_bytes`` of
    csrc/vit_attention.cu). bf16: the Q rows and the K/V ring, rows padded
    by 16 bytes, whatever n_valid; f32: the Q tile, one K/V tile and the
    score rows."""
    if dtype == torch.bfloat16:
        rows = 16 * TC_WARPS * (TC_BLOCKS if d < 128 else 1)
        return (rows + 2 * TC_STAGES * TC_KEYS) * (2 * d + 16)
    ld = (n_valid + 3) // 4 * 4
    return 4 * (ROWS * d + d * (TILE + 1) + ROWS * ld)


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, n_valid: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, the same rounding points."""
    f32 = torch.float32
    s = torch.matmul(q.to(f32), k.to(f32).transpose(1, 2)) * scale
    if n_valid < s.shape[-1]:
        s[..., n_valid:] = float("-inf")
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p.to(v.dtype).to(f32), v.to(f32)).to(v.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, n_valid: int) -> torch.Tensor:
    """softmax(q @ k^T * scale, keys < n_valid) @ v over [Z, N, d]; returns
    [Z, N, d] in v's dtype. Runs operator ``dcap::vit_attention``: CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if q.dim() != 3 or q.shape[0] < 1 or q.shape[1] < 1:
        raise ValueError(f"q must be [Z>=1, N>=1, d], got {tuple(q.shape)}")
    z, n, d = q.shape
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (z, n, d):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(z, n, d)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in FEATURE_DTYPES:
        raise TypeError(f"q/k/v must be float32 or bfloat16, got {q.dtype}")
    if not 1 <= n_valid <= n:
        raise ValueError(f"n_valid must be in [1, {n}], got {n_valid}")
    named = [("q", q), ("k", k), ("v", v)]
    check_same_device(named, q.device)
    check_kernel_device(q.device)
    return torch.ops.dcap.vit_attention(q, k, v, float(scale), int(n_valid))


def _vit_cpu(q, k, v, scale, n_valid):
    return fused_attention_plain(q, k, v, scale=scale, n_valid=n_valid)


def _vit_fake(q, k, v, scale, n_valid):
    return v.new_empty(v.shape)


def _vit_cuda(q, k, v, scale, n_valid):
    """The kernel launch of ``dcap::vit_attention``."""
    global LAUNCHES
    z, n, d = q.shape
    named = [("q", q), ("k", k), ("v", v)]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    smem = smem_bytes(d, n_valid, q.dtype)
    if smem > SMEM_LIMIT:
        raise ValueError(f"n_valid={n_valid} at d={d} in {q.dtype} needs "
                         f"{smem} bytes of shared memory per block, more "
                         f"than {SMEM_LIMIT}")
    ptrs = cuda_pointers(named)
    if q.dtype == torch.bfloat16 and any(p % 16 for p in ptrs):
        raise ValueError("bf16 q, k and v must start on 16-byte boundaries "
                         "(the kernel copies rows in 16-byte pieces)")
    lib = _build.load()
    out = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcap_vit_attention(
            *ptrs, out.data_ptr(), int(q.dtype == torch.bfloat16), z, n, d,
            n_valid, float(scale), stream)
    _build.check_launch(err, "dcap_vit_attention")
    LAUNCHES += 1
    return out


library.implement("vit_attention", _vit_cpu, _vit_cuda, _vit_fake)
