"""Tensor parallelism over a 2-D (data, model) mesh (counterpart of the JAX
``parallel/tp.py``).

The JAX package annotates parameter placements over a named mesh axis and
lets GSPMD partition every matmul and insert the collectives. PyTorch's
idiom is one process per rank, each holding its own shard, with the
collectives written out (Megatron-LM): the ranks of the default process
group form a (data, model) grid, model innermost, and every rank creates
the sub-group of its data row (the ``model`` axis) and of its model column
(the ``data`` axis). The rules are the JAX package's:

* ViT blocks (``models/dpt.ViTBlock``): ``qkv`` and ``fc1`` column-parallel
  (their biases split with them), ``proj`` and ``fc2`` row-parallel with
  replicated biases added after the sum over ``model``. ``qkv`` is split
  by heads: rank r of T holds heads ``[r H/T, (r + 1) H/T)`` of each of q,
  k and v, so that K5 runs on this rank's heads alone.
* Attention decoder (``models/decoder.AttentionDecoder``): the vocab
  projection ``out_w`` / ``out_b`` column-parallel over the vocabulary,
  the LSTM kernels and biases over the ``4 d_dec`` gate dimension, the
  embedding over its features; their outputs are gathered before the
  cell, the loss or the argmax.
* Everything else (convolutions, norms, the attention scorer) replicated.

Layouts: an ``nn.Linear.weight`` is ``[out, in]`` where a flax kernel is
``[in, out]``, so column-parallel splits its dim 0 here; the decoder's
flat parameters keep the JAX layout ``[in, out]`` and split dim 1.

``shard_tree`` replaces each matched parameter by this rank's slice in
place, so an optimizer built afterwards (AdamW) keeps moments of the local
shapes, and marks the modules that own them with the ``model`` axis, which
their forwards read. The collectives are Megatron's four maps, each an
autograd function with its own backward (``copy_to_region``,
``reduce_from_region``, ``gather_from_region``, ``scatter_to_region``):
``torch.distributed.nn``'s all-reduce and all-gather sum their gradients
over the ranks, which would count a loss that every model rank holds T
times. Every map is the identity on an axis of one rank, and on None (no
axis). The mesh's data
axis becomes the data mesh of ``parallel/mesh.make_mesh``
(``mesh.set_data_axis``) while the mesh's ``with`` block lasts, so the
trainer sums the gradients over the ranks that hold the same shards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from depth_image_captioning_pub_torch.parallel import mesh as mesh_lib
from depth_image_captioning_pub_torch.parallel.mesh import (
    DATA_AXIS, Mesh, _to_comm)

MODEL_AXIS = "model"

# (last two name components) -> split dim; a rule fires only at its ndim
_COLUMN_LINEAR = ("qkv", "fc1")      # weight [out, in] -> dim 0, bias too
_ROW_LINEAR = ("proj", "fc2")        # weight [out, in] -> dim 1
_COLUMN_FLAT = ("out_w", "lstm_w_ih", "lstm_w_hh", "embed")   # [in, out]
_COLUMN_BIAS = ("out_b", "lstm_b_ih", "lstm_b_hh")


@dataclass(frozen=True)
class Mesh2D:
    """A (data, model) grid of ranks: this rank's place on each axis, each
    a ``parallel/mesh.Mesh`` over its sub-group; ``member`` is False on a
    rank outside the grid (a world larger than the grid)."""

    data: Mesh
    model: Mesh
    member: bool = True

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data.size, MODEL_AXIS: self.model.size}

    def __enter__(self) -> "Mesh2D":
        return self

    def __exit__(self, *exc) -> None:
        """Give ``parallel/mesh.make_mesh`` back the default group."""
        if mesh_lib.make_mesh() is self.data:
            mesh_lib.set_data_axis(None)


def grid_axes(n_rows: int, n_cols: int, row_name: str, col_name: str):
    """Lay the first ``n_rows * n_cols`` ranks of the default group out as
    a row-major grid (columns innermost) and return this rank's (row axis,
    column axis, member): the column axis spans its row's ranks, the row
    axis its column's. Every rank creates every line's group, in one order
    (a rank that skipped one would leave the others waiting). A line that
    spans the world is the default group; a line of one rank is an
    inactive axis, which runs no collective. A ValueError when there are
    too few ranks."""
    joined = dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    need = n_rows * n_cols
    if world < need:
        raise ValueError(f"need {need} devices, have {world}")
    rank = dist.get_rank() if joined else 0
    rows = [[r * n_cols + c for c in range(n_cols)] for r in range(n_rows)]
    cols = [[r * n_cols + c for r in range(n_rows)] for c in range(n_cols)]
    groups = {tuple(line): dist.new_group(line) for line in rows + cols
              if 1 < len(line) < world}
    if rank >= need:
        return Mesh(0, 1, row_name), Mesh(0, 1, col_name), False

    def axis(name, line):
        return Mesh(line.index(rank), len(line), name,
                    joined and len(line) > 1, groups.get(tuple(line)))
    r, c = divmod(rank, n_cols)
    return axis(row_name, cols[c]), axis(col_name, rows[r]), True


def make_mesh_2d(n_data: int, n_model: int) -> Mesh2D:
    """The (data, model) mesh over the first ``n_data * n_model`` ranks,
    model innermost (the ranks of a model group are consecutive, as JAX
    ``tp.py`` puts the model axis on the fastest links). Its data axis is
    ``parallel/mesh.make_mesh``'s until the ``with`` block of the mesh
    ends (``with make_mesh_2d(2, 2) as mesh:``); a ValueError while
    another layout's is. Without a process group, a 1x1 mesh of this
    process."""
    data, model, member = grid_axes(n_data, n_model, DATA_AXIS, MODEL_AXIS)
    if member and dist.is_initialized():
        mesh_lib.set_data_axis(data)
    return Mesh2D(data, model, member)


# ---- the rules --------------------------------------------------------------

def spec_for(name: str, tensor: torch.Tensor) -> Optional[int]:
    """The dimension of parameter ``name`` (a ``named_parameters`` name)
    split over ``model``, or None (replicated)."""
    parts = name.split(".")
    last, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    if tensor.dim() == 2:
        if last == "weight" and parent in _COLUMN_LINEAR:
            return 0
        if last == "weight" and parent in _ROW_LINEAR:
            return 1
        if last in _COLUMN_FLAT:
            return 1
    if tensor.dim() == 1:
        if last == "bias" and parent in _COLUMN_LINEAR:
            return 0
        if last in _COLUMN_BIAS:
            return 0
    return None


def _head_rows(dim: int, heads: int, rank: int, ways: int) -> torch.Tensor:
    """The ``qkv`` output rows of rank ``rank``'s heads: ``s * dim + h *
    dh + j`` for s in (q, k, v), its heads h and j < dh."""
    if heads % ways:
        raise ValueError(f"{heads} heads do not split over {ways} ranks")
    per = heads // ways
    rows = torch.arange(3 * dim).view(3, heads, dim // heads)
    return rows[:, rank * per:(rank + 1) * per].reshape(-1)


def _owner(module: torch.nn.Module, name: str) -> torch.nn.Module:
    """The nearest module above parameter ``name`` that has a
    tensor-parallel forward (a ``tp`` attribute)."""
    parts = name.split(".")[:-1]
    while True:
        sub = module.get_submodule(".".join(parts))
        if hasattr(sub, "tp"):
            return sub
        if not parts:
            raise ValueError(f"parameter {name!r} is split over {MODEL_AXIS!r} "
                             f"but no module above it has a "
                             f"tensor-parallel forward")
        parts = parts[:-1]


def shard_tree(mesh: Mesh2D, module: torch.nn.Module) -> torch.nn.Module:
    """Replace every parameter of ``module`` that ``spec_for`` splits by
    this rank's slice of it, in place, and set ``tp`` (the model axis) on
    the modules whose forwards then run the collectives; ``module``. A
    model axis of one rank leaves everything as it is."""
    axis = mesh.model
    if axis.size == 1:
        return module
    if not mesh.member:
        raise ValueError("this rank is outside the mesh")
    owners = {}
    plan = []
    for name, p in module.named_parameters():
        dim = spec_for(name, p)
        if dim is None:
            continue
        owner = _owner(module, name)
        if owner.tp is not None:
            raise ValueError(f"{name!r} is sharded already")
        owners[id(owner)] = owner
        plan.append((name, p, dim, owner))
    with torch.no_grad():
        for name, p, dim, owner in plan:
            extent = p.shape[dim]
            if extent % axis.size:
                raise ValueError(f"{name!r} dim {dim} extent {extent} does "
                                 f"not split over {axis.size} ranks")
            if name.split(".")[-2:-1] == ["qkv"]:
                rows = _head_rows(owner.qkv.in_features, owner.heads,
                                  axis.rank, axis.size).to(p.device)
                local = p.index_select(0, rows)
            else:
                n = extent // axis.size
                local = p.narrow(dim, axis.rank * n, n)
            p.data = local.contiguous()
    for owner in owners.values():
        owner.tp = axis
    return module


def shard_batch_2d(mesh: Mesh2D, batch):
    """This rank's data row's contiguous rows of ``batch`` (replicated over
    ``model``), as ``parallel/mesh.shard_batch`` over the data axis."""
    return mesh_lib.shard_batch(mesh.data, batch)


# ---- Megatron's maps --------------------------------------------------------

def _comm(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` where the backend's collectives take it."""
    d = t.detach().contiguous()
    c = _to_comm(d)
    return c.clone() if c is d else c


def _all_reduce(t: torch.Tensor, axis: Mesh) -> torch.Tensor:
    buf = _comm(t)
    dist.all_reduce(buf, group=axis.group)
    return buf.to(t.device)


def _all_gather(t: torch.Tensor, axis: Mesh, dim: int) -> torch.Tensor:
    src = _comm(t)
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts, dim=dim).to(t.device)


def _split(t: torch.Tensor, axis: Mesh, dim: int) -> torch.Tensor:
    n = t.shape[dim] // axis.size
    return t.narrow(dim, axis.rank * n, n).contiguous()


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.axis), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return _split(grad, ctx.axis, ctx.dim), None, None


class _ScatterToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _split(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.axis, ctx.dim), None, None


def _idle(axis: Optional[Mesh]) -> bool:
    return axis is None or axis.size == 1


def copy_to_region(x: torch.Tensor, axis: Optional[Mesh]) -> torch.Tensor:
    """Forward ``x``; backward the sum of the ranks' gradients (a
    replicated input entering a split matmul)."""
    return x if _idle(axis) else _CopyToRegion.apply(x, axis)


def reduce_from_region(x: torch.Tensor, axis: Optional[Mesh]
                       ) -> torch.Tensor:
    """Forward the sum over the ranks (a row-parallel matmul's partial
    sums); backward the gradient as it is."""
    return x if _idle(axis) else _ReduceFromRegion.apply(x, axis)


def gather_from_region(x: torch.Tensor, axis: Optional[Mesh], dim: int
                       ) -> torch.Tensor:
    """Forward the ranks' equal slices joined along ``dim`` in rank order;
    backward this rank's slice of the gradient."""
    if _idle(axis):
        return x
    return _GatherFromRegion.apply(x, axis, dim % x.dim())


def scatter_to_region(x: torch.Tensor, axis: Optional[Mesh], dim: int
                      ) -> torch.Tensor:
    """Forward this rank's slice of ``x`` along ``dim`` (which the ranks
    divide); backward the ranks' gradients joined."""
    if _idle(axis):
        return x
    return _ScatterToRegion.apply(x, axis, dim % x.dim())
