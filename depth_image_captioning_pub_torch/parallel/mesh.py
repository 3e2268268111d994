"""The data mesh and its collectives (counterpart of the JAX
``parallel/mesh.py``).

The JAX package's one distribution story is a 1-D mesh over the batch
axis: parameters replicated, every batch sharded over the devices, the
gradients combined by the all-reduces that XLA inserts. Here the mesh is
the ranks of the default ``torch.distributed`` process group (one process
per card under ``torchrun``; ``parallel/multihost.initialize`` joins it),
or the one rank of a process that joined none:

* ``shard_batch`` gives this rank its contiguous rows ``[r * B / R, (r + 1)
  * B / R)`` of a global batch, what the JAX ``shard_batch`` places on
  device r; ``pad_batch_to_devices`` rounds a batch up so that it splits;
* ``replicate`` broadcasts rank 0's parameters and buffers;
* ``all_reduce_grads`` sums the trainable gradients across ranks in one
  flattened collective a step (each rank's loss is its rows' share of the
  global batch's loss, so the sum is the single-device gradient);
* ``global_rows`` makes a noise hook draw at the global batch's shape and
  keep this rank's rows, so that a run of R ranks draws what one rank
  draws: dropout masks and Gumbel noise are the same numbers either way.

The helpers ``all_reduce_sum``, ``all_gather_rows``,
``all_reduce_autograd``, ``broadcast_object`` and ``barrier`` are the
collectives that the trainer, the evaluation and the depth encoder's
BatchNorm use. Each is a no-op in a process without a group. Under the
gloo backend a CUDA tensor goes through host memory (gloo's collectives
other than all-reduce and broadcast take CPU tensors only); under NCCL a
host tensor goes through the current card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: this process's ``rank`` of ``size`` ranks over
    ``axis_name``; ``active`` when a process group exists (a group of one
    rank is active, and runs its collectives)."""

    rank: int
    size: int
    axis_name: str = DATA_AXIS
    active: bool = False

    @property
    def sharded(self) -> bool:
        """More than one rank: batches split, statistics and noise go
        global."""
        return self.size > 1


def make_mesh(axis_name: str = DATA_AXIS) -> Mesh:
    """The 1-D data mesh over the ranks of the default process group (one
    rank of one without a group)."""
    if not dist.is_initialized():
        return Mesh(0, 1, axis_name, False)
    return Mesh(dist.get_rank(), dist.get_world_size(), axis_name, True)


def pad_batch_to_devices(batch_size: int, n_devices: int) -> int:
    """Smallest multiple of n_devices >= batch_size (static shape per
    shard)."""
    return -(-batch_size // n_devices) * n_devices


def _check_divides(extent: int, ways: int, label: str = "") -> None:
    if extent % ways != 0:
        raise AssertionError(
            f"{label or 'array'} dim 0 extent {extent} is not divisible by "
            f"ways={ways}; pad it with pad_batch_to_devices first")


def batch_sharding(mesh: Mesh, extent: int) -> slice:
    """This rank's rows of a global batch of ``extent`` rows: ``slice(r *
    n, (r + 1) * n)``, n = extent / size; AssertionError unless size
    divides extent."""
    _check_divides(extent, mesh.size, "batch")
    n = extent // mesh.size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of every leaf of ``batch`` (a tensor, an array, or
    a dict, list or tuple of them); 0-d leaves are replicated, so they
    pass as they are."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)) and not hasattr(batch, "shape"):
        out = [shard_batch(mesh, v) for v in batch]
        return type(batch)(*out) if hasattr(batch, "_fields") else \
            type(batch)(out)
    if getattr(batch, "ndim", 0) == 0:
        return batch
    return batch[batch_sharding(mesh, batch.shape[0])]


def local_shard_shape(x) -> tuple:
    """The shape of this rank's shard: each rank holds its local tensor."""
    return tuple(x.shape)


def assert_partitioned(x, dim: int, ways: int, extent: int,
                       label: str = "") -> None:
    """Assert that the local tensor ``x`` is this rank's ``1/ways`` of a
    global ``extent`` along ``dim``: an extent that does not divide is an
    error of the check itself (the JAX helper's rule), and a local extent
    other than ``extent / ways`` means the data was not partitioned."""
    if extent % ways != 0:
        raise AssertionError(
            f"{label or 'array'} dim {dim} extent {extent} is not "
            f"divisible by ways={ways}; pick a divisible extent so the "
            f"partition check is meaningful")
    expect = extent // ways
    if x.shape[dim] != expect:
        raise AssertionError(
            f"{label or 'array'} {tuple(x.shape)} is not {ways}-way "
            f"partitioned on dim {dim}: local extent {x.shape[dim]} "
            f"(expected {expect} of {extent})")


def global_rows(hook: Optional[Callable], mesh: Mesh) -> Optional[Callable]:
    """A noise hook ``hook(t, shape)`` that draws at the global batch's
    shape (``shape[0] * size`` rows) and keeps this rank's rows: each rank
    runs the same draws in the same order, so the noise of R ranks is one
    rank's. The hook itself with one rank or None."""
    if hook is None or not mesh.sharded:
        return hook

    def rows(t, shape):
        n = shape[0]
        full = hook(t, (n * mesh.size, *shape[1:]))
        return full[mesh.rank * n:(mesh.rank + 1) * n]
    return rows


def _to_comm(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend's collectives take it: host memory for a
    CUDA tensor under gloo, the current card for a host tensor under
    NCCL."""
    if dist.get_backend() == dist.Backend.GLOO:
        return t.cpu() if t.is_cuda else t
    return t if t.is_cuda else t.to(torch.cuda.current_device())


def all_reduce_sum(t: torch.Tensor, op=None) -> torch.Tensor:
    """The sum (or ``op``) of ``t`` over the ranks, a new tensor on
    ``t``'s device; ``t`` itself without a group."""
    if not make_mesh().active:
        return t
    buf = _to_comm(t.detach()).clone()
    dist.all_reduce(buf, op=op or dist.ReduceOp.SUM)
    return buf.to(t.device)


def all_reduce_autograd(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks with autograd through it (the
    gradient of each rank's copy is the sum of the ranks' gradients of
    the result); ``t`` itself with one rank."""
    if not make_mesh().sharded:
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(_to_comm(t)).to(t.device)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The ranks' tensors of one shape concatenated along dim 0 in rank
    order, on ``t``'s device; ``t`` itself with one rank."""
    mesh = make_mesh()
    if not mesh.sharded:
        return t
    src = _to_comm(t.contiguous())
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim=0).to(t.device)


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if not make_mesh().sharded:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier() -> None:
    """Wait until every rank gets here (nothing without a group)."""
    if make_mesh().sharded:
        dist.barrier()


def any_rank(flag: bool, device=None) -> bool:
    """True on every rank when ``flag`` is True on any of them (a MAX
    all-reduce)."""
    if not make_mesh().sharded:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    return bool(all_reduce_sum(t, dist.ReduceOp.MAX).item() > 0)


def replicate(mesh: Mesh, modules: Iterable[torch.nn.Module]) -> None:
    """Broadcast rank 0's parameters and buffers into every rank's
    modules, in place (the JAX ``replicate`` of the train state)."""
    if not mesh.sharded:
        return
    with torch.no_grad():
        for module in modules:
            for t in list(module.parameters()) + list(module.buffers()):
                buf = _to_comm(t.detach()).clone()
                dist.broadcast(buf, src=0)
                t.copy_(buf.to(t.device))


def all_reduce_grads(params: Sequence[torch.nn.Parameter],
                     extra: Optional[List[torch.Tensor]] = None
                     ) -> List[torch.Tensor]:
    """Sum the ``.grad`` of ``params`` (those that have one) across the
    ranks in place, with the 0-d or small tensors ``extra`` (a step's
    metrics) in the same flattened collective; returns the summed extras.
    Nothing moves without a group."""
    extra = list(extra or [])
    if not make_mesh().active:
        return extra
    grads = [p.grad for p in params if p.grad is not None]
    parts = [g.reshape(-1).to(torch.float32) for g in grads] + [
        e.detach().reshape(-1).to(torch.float32) for e in extra]
    if not parts:
        return extra
    flat = torch.cat(parts)
    out = all_reduce_sum(flat)
    at = 0
    for g in grads:
        g.copy_(out[at:at + g.numel()].view_as(g))
        at += g.numel()
    summed = []
    for e in extra:
        summed.append(out[at:at + e.numel()].view_as(e).to(e.dtype))
        at += e.numel()
    return summed

