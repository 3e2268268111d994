"""Pipeline parallelism over a ``stage`` axis, GPipe schedule (counterpart
of the JAX ``parallel/pp.py``).

The JAX package runs the schedule as one jitted ``shard_map`` over a named
``stage`` mesh axis: a ``lax.scan`` over the M + S - 1 schedule steps and
a ``ppermute`` that moves each stage's activation to the next stage every
step. Here each stage is a rank of the default process group and runs the
same schedule: at step t stage s applies its blocks to microbatch t - s
(stage 0 to microbatch t of the input), keeps the result when that
microbatch exists, and sends it one stage on, around the ring, while it
receives its next input from the stage before (``shift``). The bubble is
the usual (S - 1) / (M + S - 1).

Every block has the same parameter shapes, so the blocks' parameters are
stacked on a leading block axis (``stack_block_params``) and each stage
rank keeps only its ``n_blocks / S`` consecutive blocks
(``shard_stacked_params``): weight memory scales 1/S, the point of PP.

The schedule is differentiable. The shift is an autograd function whose
backward is the reverse shift, and every rank's graph has the same shape
(stage 0's choice of its input and each step's keep-or-not are
``torch.where`` on a tensor, as the JAX ``jnp.where``), so that each
rank's backward reaches the same shifts in the same order and their
collectives meet. The stage outputs are gathered over the stages (and the
data axis), so every rank returns the whole ``[S, B, ...]`` result; the
gradient of a stage's blocks lands on its rank.

Under gloo the activations of a CUDA run go through host memory
(``parallel/mesh._to_comm``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from depth_image_captioning_pub_torch.parallel.mesh import (
    DATA_AXIS, Mesh, _to_comm, global_rank)
from depth_image_captioning_pub_torch.parallel.tp import (
    gather_from_region, grid_axes)

STAGE_AXIS = "stage"

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class StageMesh:
    """A (data, stage) grid of ranks, stage innermost: this rank's place on
    each axis (``parallel/mesh.Mesh`` over its sub-group); ``member`` is
    False on a rank outside the grid."""

    data: Mesh
    stage: Mesh
    member: bool = True

    def axis(self, name: str) -> Mesh:
        return {DATA_AXIS: self.data, STAGE_AXIS: self.stage}[name]


def make_stage_mesh(n_stages: int, n_data: int = 1) -> StageMesh:
    """The pipeline mesh over the first ``n_data * n_stages`` ranks: each
    data row's ``n_stages`` consecutive ranks are its stages. ValueError
    when there are too few ranks."""
    data, stage, member = grid_axes(n_data, n_stages, DATA_AXIS, STAGE_AXIS)
    return StageMesh(data, stage, member)


@dataclass(frozen=True)
class StageParams:
    """This stage's blocks of a stacked tree: ``local`` leaves lead with
    its ``n_blocks / S`` blocks."""

    local: Params
    n_blocks: int


def stack_block_params(blocks: Sequence[Params]) -> Params:
    """Stack per-block parameter dicts (identical shapes) on a new leading
    block axis, the axis that splits over ``stage``."""
    return {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}


def _n_blocks(stacked: Params) -> int:
    return next(iter(stacked.values())).shape[0]


def shard_stacked_params(mesh: StageMesh, stacked: Params) -> StageParams:
    """This stage's consecutive ``n_blocks / S`` blocks of ``stacked``
    (copies: the rank holds only them); ValueError when S does not divide
    the blocks."""
    n_blocks, n_stages = _n_blocks(stacked), mesh.stage.size
    if n_blocks % n_stages:
        raise ValueError(f"{n_blocks} blocks not divisible by "
                         f"{n_stages} stages")
    per = n_blocks // n_stages
    at = mesh.stage.rank * per
    return StageParams({k: v[at:at + per].detach().clone()
                        for k, v in stacked.items()}, n_blocks)


def _shift_ring(x: torch.Tensor, axis: Mesh, step: int) -> torch.Tensor:
    """Send ``x`` to the stage ``step`` on around the ring and return what
    the stage ``step`` before sent."""
    size = axis.size
    send = _to_comm(x.detach().contiguous())
    recv = torch.empty_like(send)
    to = global_rank(axis, (axis.rank + step) % size)
    frm = global_rank(axis, (axis.rank - step) % size)
    ops = [dist.P2POp(dist.isend, send, to, axis.group),
           dist.P2POp(dist.irecv, recv, frm, axis.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _shift_ring(x, axis, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift_ring(grad, ctx.axis, -1), None


def shift(x: torch.Tensor, axis: Mesh) -> torch.Tensor:
    """Each stage's ``x`` moved one stage on (the last to the first), with
    the reverse move as its backward (the JAX ``ppermute``)."""
    return x if axis.size == 1 else _Shift.apply(x, axis)


def pipeline_stage_outputs(block_apply: Callable[[Params, torch.Tensor],
                                                 torch.Tensor],
                           stacked, x: torch.Tensor, mesh: StageMesh,
                           n_microbatches: int,
                           batch_axis: Optional[str] = None) -> torch.Tensor:
    """Run ``n_blocks`` chained ``block_apply`` calls as an S-stage pipeline.

    ``block_apply(one_block_params, act) -> act`` keeps the shape;
    ``stacked``: the stacked tree of every block (``stack_block_params``;
    this stage's blocks are taken from it) or this stage's
    (``shard_stacked_params``); ``x``: the global ``[B, ...]``
    activations, B divisible by ``n_microbatches`` M (and with
    ``batch_axis`` each microbatch by that axis' size: dp x pp, each data
    row runs the pipeline on its rows of every microbatch, and no
    collective crosses the rows until the outputs are gathered).

    Returns ``[S, B, ...]`` on every rank: the activation after each
    stage's last block for the whole batch, i.e. after global block ``(s +
    1) * n_blocks / S - 1``; row S - 1 is the whole stack's output.
    """
    if not mesh.member:
        raise ValueError("this rank is outside the mesh")
    if not isinstance(stacked, StageParams):
        stacked = shard_stacked_params(mesh, stacked)
    local, n_stages = stacked.local, mesh.stage.size
    batch, n_mb = x.shape[0], n_microbatches
    if batch % n_mb:
        raise ValueError(f"batch {batch} not divisible by "
                         f"M={n_mb} microbatches")
    mb = batch // n_mb
    rows = mesh.axis(batch_axis) if batch_axis is not None else None
    if rows is not None and mb % rows.size:
        raise ValueError(f"microbatch {mb} not divisible by mesh axis "
                         f"{batch_axis!r}={rows.size}")
    xs = x.reshape(n_mb, mb, *x.shape[1:])
    if rows is not None:
        n = mb // rows.size
        xs = xs[:, rows.rank * n:(rows.rank + 1) * n]
    stage = mesh.stage.rank
    first = torch.tensor(stage == 0, device=x.device)
    per = _n_blocks(local)

    def apply_stage(act):
        for i in range(per):
            act = block_apply({k: v[i] for k, v in local.items()}, act)
        return act

    act = torch.zeros_like(xs[0])
    buf = [torch.zeros_like(xs[0]) for _ in range(n_mb)]
    for t in range(n_mb + n_stages - 1):
        res = apply_stage(torch.where(first, xs[min(t, n_mb - 1)], act))
        j = t - stage              # the microbatch this stage holds
        jc = min(max(j, 0), n_mb - 1)
        keep = torch.tensor(0 <= j < n_mb, device=x.device)
        buf[jc] = torch.where(keep, res, buf[jc])
        act = shift(res, mesh.stage)
    out = torch.stack(buf)                       # [M, rows, ...]
    if rows is not None:
        out = gather_from_region(out, rows, 1)   # [M, mb, ...]
    out = out.reshape(1, batch, *x.shape[1:])
    return gather_from_region(out, mesh.stage, 0)


def vit_taps_pipelined(blocks: Sequence[torch.nn.Module],
                       tokens: torch.Tensor, mesh: StageMesh,
                       n_microbatches: int, *,
                       n_valid: Optional[int] = None,
                       hooks: Tuple[int, int] = (8, 11)
                       ) -> Tuple[torch.Tensor, ...]:
    """The DPT's ViT block stack (``models/dpt.DPTDepthModel``'s block
    loop) as a pipeline: the hook taps (after global blocks ``hooks``),
    each ``[B, N, D]`` with pad rows still attached. ``blocks``: every
    ``ViTBlock`` of the stack (each stage keeps its own blocks' stacked
    parameters); ``n_valid``: the real tokens, K5's key mask. The hooks
    must land on stage boundaries: 4 or 12 stages for the standard (8,
    11)."""
    n_blocks, n_stages = len(blocks), mesh.stage.size
    per = n_blocks // n_stages
    if per == 0:
        raise ValueError(f"{n_stages} stages exceed {n_blocks} blocks")
    for h in hooks:
        if (h + 1) % per:
            raise ValueError(
                f"hook {h} not on a stage boundary with {n_stages} stages "
                f"({per} blocks/stage); use 4 or 12 stages for the "
                f"standard DPT hooks (8, 11)")
    template = blocks[0]
    local = shard_stacked_params(mesh, stack_block_params(
        [dict(b.named_parameters()) for b in blocks]))

    def block_apply(p, a):
        return torch.func.functional_call(template, p, (a,),
                                          {"n_valid": n_valid})

    out = pipeline_stage_outputs(block_apply, local, tokens, mesh,
                                 n_microbatches)
    return tuple(out[(h + 1) // per - 1] for h in hooks)
