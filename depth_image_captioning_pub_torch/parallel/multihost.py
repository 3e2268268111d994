"""Joining the process group (counterpart of the JAX
``parallel/multihost.py``).

The JAX package joins its hosts with ``jax.distributed.initialize``, after
which its mesh spans every host's devices and each host feeds its own
shard of the global batch. PyTorch's idiom is one process per card:
``torchrun --nproc-per-node N`` starts them with ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` set, and ``initialize``
joins the default group from those (``env://``), or from the address,
count and index given. The mesh (``parallel/mesh.make_mesh``) is then the
group's ranks, and the trainer and the evaluation shard their batches
over it.

The backend is NCCL for a CUDA device and gloo for the CPU, unless the
caller names one: two gloo ranks may share one card, which NCCL refuses.
A backend that is not available raises; nothing falls back to another.
``timeout`` bounds each collective (gloo's default is 30 minutes): a rank
whose peer died then raises instead of waiting, as the ``timeout`` of
``jax.distributed.initialize`` bounds the JAX package's.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device="cuda",
               timeout: Optional[timedelta] = None) -> None:
    """Join the default process group on every process.

    ``coordinator_address``: ``host:port`` of rank 0's store (``tcp://``),
    a full ``tcp://`` or ``file://`` URL, or None for ``env://`` (the
    variables ``torchrun`` sets). ``num_processes`` and ``process_id``:
    the world size and this process's rank (None: from the environment).
    ``backend``: "nccl" or "gloo"; by default NCCL when ``device`` is a
    CUDA device (then also made the current device) and gloo otherwise.
    ``timeout``: how long a collective waits for its peers (None: the
    backend's default).
    """
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("the NCCL backend is not available in this "
                           "PyTorch build; pass backend='gloo' to use gloo")
    if backend == "gloo" and not dist.is_gloo_available():
        raise RuntimeError("the gloo backend is not available in this "
                           "PyTorch build")
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if timeout is not None:
        kwargs["timeout"] = timeout
    dist.init_process_group(backend=backend, init_method=init_method,
                            **kwargs)


def shutdown() -> None:
    """Leave the default process group, if this process joined one (and
    the data axis of a layout over its sub-groups)."""
    from depth_image_captioning_pub_torch.parallel.mesh import set_data_axis
    set_data_axis(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The default group's size; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def launched_ranks() -> int:
    """``WORLD_SIZE`` as ``torchrun`` sets it; 1 when it is not set."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_device(device) -> torch.device:
    """The device of this process: ``cuda:LOCAL_RANK`` for a CUDA
    ``device`` without an index under ``torchrun``, else ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def build_kernels(device) -> None:
    """On a CUDA device, build the kernel library on rank 0 first while
    the other ranks wait, then load it everywhere: ranks that start cold
    would each run nvcc over the same sources."""
    if torch.device(device).type != "cuda":
        return
    from depth_image_captioning_pub_torch.ops.kernels import _build
    if process_index() == 0:
        _build.load()
    if process_count() > 1:
        dist.barrier()          # every rank, whatever the mesh's axes
    _build.load()


def host_shard_indices(n_examples: int,
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(indices, real_mask) for THIS host's slice of a global dataset.

    Host ``i`` of ``P`` feeds rows ``[i*m, (i+1)*m)`` of the global order
    with ``m = ceil(n/P)``; the tail wraps so every host supplies the same
    static count. ``real_mask`` flags non-wrapped rows — thread it into the
    batch's ``pad_mask`` so wrapped duplicates are excluded from losses and
    metrics exactly like the single-host pipeline's fill padding.
    """
    joined = dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if joined else 0
    if process_count is None:
        process_count = dist.get_world_size() if joined else 1
    m = -(-n_examples // process_count)
    raw = np.arange(process_index * m, (process_index + 1) * m)
    return raw % n_examples, raw < n_examples


def global_batch(local_batch):
    """The global batch from every process's local shard: each leaf (a
    tensor or an array, or a dict of them) gathered along its leading
    dim in rank order, ``local * process_count`` rows; arrays come back
    as arrays."""
    from depth_image_captioning_pub_torch.parallel.mesh import (
        all_gather_rows)
    if isinstance(local_batch, dict):
        return {k: global_batch(v) for k, v in local_batch.items()}
    if isinstance(local_batch, np.ndarray):
        return all_gather_rows(torch.from_numpy(
            np.ascontiguousarray(local_batch))).numpy()
    return all_gather_rows(local_batch)
