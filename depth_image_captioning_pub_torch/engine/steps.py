"""Train and eval steps (counterpart of the JAX ``engine/steps.py``).

Each step is a plain function of the captioner, the optimizer (train), a
batch of device tensors and the noise source (a ``torch.Generator``, or the
decoders' ``dropout_keep(t, shape)`` / ``att_noise(t, shape)`` hooks),
returning its metrics as 0-d device tensors: nothing in a step waits on
the card. The whole step (forward, backward and AdamW) runs inside
``full_f32()``, so no f32 product takes TF32.

The frozen RGB backbone runs under ``torch.no_grad()``; autograd sees the
decoder, NIC's projection and the depth encoder, whose BatchNorms train on
the batch's statistics (``DepthCNNEncoder(train=True)``). AdamW is
``torch.optim.AdamW`` with the JAX package's ``optax.adamw`` settings (lr
from the config, betas 0.9/0.999, eps 1e-8, weight decay 0.01 on every
trainable tensor, biases and BN scales included) and a constant learning
rate, as the JAX trainer runs it.

``features`` (the train-time feature cache, ``engine/feature_cache.py``)
replaces the frozen stage by its cached output. ``accum_steps`` k > 1
accumulates the gradient over k microbatches before the one AdamW update,
as the JAX package's ``_accum_grads``: microbatch j holds the batch's rows
``j::k`` (a strided split), each microbatch's loss is normalized by the
whole batch's token and row counts (``losses.caption_loss(denoms=)``), so
the summed gradients and metrics are the one-shot step's up to rounding,
and each microbatch's backward frees its activations before the next
forward. The depth CNN's BatchNorms move their running statistics
microbatch by microbatch, in order. Each microbatch draws its own noise:
from the generator in turn, or from the hooks, which then take the
microbatch index first (``dropout_keep(j, t, shape)``, ``att_noise(j, t,
shape)``: the tests replay the JAX step's ``jax.random.split(rng, k)``
through them).

Over several ranks (``parallel/mesh``: one process per card, each with
its contiguous rows of the global batch) a step computes what one rank
computes on the whole batch: the normalizers are the global batch's
(``caption_denoms`` and ``nic_denom`` all-reduce the counts), so each
rank's loss is its rows' share of the global loss; the gradients are
summed across ranks in one flattened collective before AdamW
(``mesh.all_reduce_grads``, with the metrics in the same buffer, so every
rank returns the global loss); the noise is drawn at the global shape and
each rank keeps its rows (``mesh.global_rows`` around the hooks or the
generator's draws); the depth CNN's BatchNorms see the global
(micro)batch (``models/depth_encoders.BatchNorm2d``). With accumulation a
rank's rows ``j::k`` are the global microbatch j's rows of that rank as
long as k divides each rank's row count, which the trainer's padding to a
multiple of ranks * k keeps. A group of one rank runs the same
collectives, which leave every value as it is.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from depth_image_captioning_pub_torch.engine.losses import (
    Metrics, caption_loss, nic_loss, token_mask)
from depth_image_captioning_pub_torch.models.captioner import Captioner
from depth_image_captioning_pub_torch.ops.decode import (
    dropout_masks, region_noise)
from depth_image_captioning_pub_torch.ops.image_ops import (
    imagenet_normalize, to_unit_float)
from depth_image_captioning_pub_torch.ops.pooling import global_avg_pool
from depth_image_captioning_pub_torch.ops.precision import full_f32
from depth_image_captioning_pub_torch.parallel.mesh import (
    all_reduce_grads, all_reduce_sum, global_rows, make_mesh)

DeviceBatch = Dict[str, torch.Tensor]


def make_optimizer(cap: Captioner, lr: float,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW over ``cap.trainable_parameters()`` only."""
    return torch.optim.AdamW(cap.trainable_parameters(), lr=lr,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def check_accum_steps(accum_steps: int,
                      batch_size: Optional[int] = None) -> None:
    """Raise ValueError unless ``accum_steps`` >= 1 divides ``batch_size``
    (when given)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if batch_size is not None and batch_size % accum_steps:
        raise ValueError(f"batch size {batch_size} not divisible by "
                         f"accum_steps={accum_steps}")


def _micro(batch: DeviceBatch, j: int, k: int) -> DeviceBatch:
    """Microbatch j of k: rows ``j::k`` of every tensor."""
    return {name: t[j::k] for name, t in batch.items()}


def _sharded_denoms(batch: DeviceBatch):
    """The global batch's normalizers over several ranks; None (each
    loss counts its own batch) with one."""
    return caption_denoms(batch) if make_mesh().sharded else None


def _micro_hook(hook, j: int):
    return None if hook is None else (
        lambda t, shape: hook(j, t, shape))


def caption_denoms(batch: DeviceBatch):
    """(token_total, example_total): the whole batch's normalizers of
    ``caption_loss`` (the JAX ``_global_denoms``); over several ranks the
    global batch's, all-reduced."""
    captions, pad = batch["captions"], batch.get("pad_mask")
    mask = token_mask(batch["lengths"], captions.shape[1] - 1, pad)
    if make_mesh().sharded:
        rows = (pad.sum() if pad is not None else
                torch.tensor(captions.shape[0], device=captions.device))
        tok, ex = all_reduce_sum(torch.stack([mask.sum(), rows]))
        return (torch.clamp(tok, min=1),
                torch.clamp(ex.to(torch.float32), min=1.0))
    tok = torch.clamp(mask.sum(), min=1)
    ex = (torch.clamp(pad.sum().to(torch.float32), min=1.0)
          if pad is not None else
          torch.tensor(float(captions.shape[0]), device=captions.device))
    return tok, ex


def nic_denom(batch: DeviceBatch) -> torch.Tensor:
    """The whole batch's token count of ``nic_loss`` (targets t <
    length); over several ranks the global batch's."""
    captions, pad = batch["captions"], batch.get("pad_mask")
    t = torch.arange(captions.shape[1], device=captions.device)[None, :]
    mask = t < batch["lengths"][:, None]
    if pad is not None:
        mask = mask & pad[:, None]
    return torch.clamp(all_reduce_sum(mask.sum()) if make_mesh().sharded
                       else mask.sum(), min=1)


def _global_noise(decoder, generator, dropout_keep, att_noise,
                  stochastic: bool):
    """The decoder's noise hooks over several ranks: the given hooks, or
    the generator's draws the decoder would make, at the global batch's
    shape with this rank's rows kept (``mesh.global_rows``); the hooks as
    they are with one rank. ``stochastic``: training noise is on (dropout
    is drawn)."""
    mesh = make_mesh()
    if not mesh.sharded:
        return dropout_keep, att_noise
    if generator is not None:
        if att_noise is None and getattr(
                decoder, "attention_kind", None) == "hard":
            att_noise = region_noise(generator)
        if dropout_keep is None and stochastic and decoder.dropout > 0.0:
            dropout_keep = dropout_masks(generator, decoder.dropout)
    return global_rows(dropout_keep, mesh), global_rows(att_noise, mesh)


def batch_to_device(batch, device, depth=None,
                    images: bool = True) -> DeviceBatch:
    """A ``data/pipeline.Batch`` as device tensors: images (uint8 NHWC;
    left out with ``images=False``, for a step fed cached features),
    captions, lengths, pad_mask and, for depth kinds, ``depth`` (the
    provider's [B, 224, 224, 1] maps, numpy or a tensor)."""
    names = (("images",) if images else ()) + ("captions", "lengths",
                                                "pad_mask")
    out = {name: torch.from_numpy(np.ascontiguousarray(
        getattr(batch, name))).to(device, non_blocking=True)
        for name in names}
    if depth is not None:
        if isinstance(depth, np.ndarray):
            depth = torch.from_numpy(np.ascontiguousarray(depth))
        out["depth"] = depth.to(device, torch.float32)
    return out


@torch.no_grad()
def frozen_features(cap: Captioner, images: torch.Tensor) -> torch.Tensor:
    """The frozen stage of the step on uint8 NHWC images: the grid
    features [B, K, 2048], or NIC's pooled backbone features [B, 2048]
    (before its trainable projection); encoder dtype, no autograd."""
    x = imagenet_normalize(to_unit_float(images))
    if cap.spec.is_nic:
        return global_avg_pool(cap.backbone(x))
    return cap.encoder(x)


def attention_loss(cap: Captioner, features: torch.Tensor,
                   batch: DeviceBatch, *, train: bool, temp=1.0,
                   alpha_reg: float = 0.0, hard_eval_sampling: bool = False,
                   generator: Optional[torch.Generator] = None,
                   dropout_keep=None, att_noise=None, denoms=None):
    """(loss, metrics) of the attention kinds on frozen ``features``: the
    depth encoder (batch statistics when ``train``), the teacher-forced
    decoder and ``caption_loss`` (``denoms``: a whole batch's
    normalizers, for a microbatch)."""
    dep = None
    if cap.spec.uses_depth:
        dep = cap.depth_encoder_apply(train=train)(batch["depth"])
    dropout_keep, att_noise = _global_noise(
        cap.decoder, generator, dropout_keep, att_noise,
        train and not hard_eval_sampling)
    logits, alphas = cap.decoder(
        features, batch["captions"], dep, train=train, temp=temp,
        hard_eval_sampling=hard_eval_sampling, generator=generator,
        dropout_keep=dropout_keep, att_noise=att_noise)
    return caption_loss(logits, batch["captions"], batch["lengths"], alphas,
                        batch["pad_mask"], alpha_reg, denoms=denoms)


def nic_loss_of(cap: Captioner, pooled: torch.Tensor, batch: DeviceBatch,
                *, train: bool, generator: Optional[torch.Generator] = None,
                dropout_keep=None, denom=None):
    """(loss, metrics) of NIC on the pooled backbone features: the
    projection, the teacher-forced decoder and ``nic_loss`` (``denom``: a
    whole batch's token count, for a microbatch)."""
    dropout_keep, _ = _global_noise(cap.decoder, generator, dropout_keep,
                                    None, train)
    logits = cap.decoder(cap.projection(pooled), batch["captions"],
                         train=train, generator=generator,
                         dropout_keep=dropout_keep)
    return nic_loss(logits, batch["captions"], batch["lengths"],
                    batch["pad_mask"], denom=denom)


def _params(optimizer: torch.optim.Optimizer):
    return [p for group in optimizer.param_groups for p in group["params"]]


def _update(optimizer: torch.optim.Optimizer, metrics: Metrics) -> Metrics:
    """Sum the gradients (and the metrics) across the ranks, then the
    AdamW update; returns the metrics, detached and global."""
    names = list(metrics)
    summed = all_reduce_grads(_params(optimizer),
                              [metrics[k].detach() for k in names])
    optimizer.step()
    return dict(zip(names, summed))


def _apply(optimizer: torch.optim.Optimizer, loss: torch.Tensor,
           metrics: Metrics) -> Metrics:
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    return _update(optimizer, metrics)


def _detached(metrics: Metrics) -> Metrics:
    """The metrics detached and, over ranks, summed (an eval step's)."""
    names = list(metrics)
    return dict(zip(names, all_reduce_grads(
        [], [metrics[k].detach() for k in names])))


def _accumulate(optimizer: torch.optim.Optimizer, loss_of, batch,
                features: torch.Tensor, accum_steps: int) -> Metrics:
    """Backward of ``loss_of(j, microbatch, features rows)`` for each of
    the k microbatches in order, the gradients summed in ``.grad``, then
    one reduction across the ranks and one optimizer step; returns the
    summed metrics."""
    check_accum_steps(accum_steps, features.shape[0])
    optimizer.zero_grad(set_to_none=True)
    total: Optional[Metrics] = None
    for j in range(accum_steps):
        loss, metrics = loss_of(j, _micro(batch, j, accum_steps),
                                features[j::accum_steps])
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        total = metrics if total is None else {
            k: total[k] + v for k, v in metrics.items()}
    return _update(optimizer, total)


@full_f32()
def attention_train_step(cap: Captioner, optimizer: torch.optim.Optimizer,
                         batch: DeviceBatch, *, temp=1.0,
                         alpha_reg: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         dropout_keep=None, att_noise=None,
                         features: Optional[torch.Tensor] = None,
                         accum_steps: int = 1) -> Metrics:
    """One AdamW step of base-*, depth-* and mdepth-*: dropout, and hard
    attention's Gumbel-softmax at temperature ``temp``, from
    ``generator`` or the hooks. ``features`` skips the frozen encoder
    (its output on ``batch["images"]``). ``accum_steps`` > 1 accumulates
    over that many microbatches (the hooks then take the microbatch index
    first)."""
    if features is None:
        features = frozen_features(cap, batch["images"])
    if accum_steps > 1:
        denoms = caption_denoms(batch)
        return _accumulate(optimizer, lambda j, mb, feats: attention_loss(
            cap, feats, mb, train=True, temp=temp, alpha_reg=alpha_reg,
            generator=generator, dropout_keep=_micro_hook(dropout_keep, j),
            att_noise=_micro_hook(att_noise, j), denoms=denoms),
            batch, features, accum_steps)
    loss, metrics = attention_loss(
        cap, features, batch, train=True, temp=temp, alpha_reg=alpha_reg,
        generator=generator, dropout_keep=dropout_keep, att_noise=att_noise,
        denoms=_sharded_denoms(batch))
    return _apply(optimizer, loss, metrics)


@torch.no_grad()
@full_f32()
def attention_eval_step(cap: Captioner, batch: DeviceBatch, *,
                        alpha_reg: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        att_noise=None,
                        features: Optional[torch.Tensor] = None
                        ) -> Metrics:
    """Validation loss, teacher forced: BN on running statistics, no
    dropout; hard attention takes Gumbel-max regions (the JAX
    ``hard_eval_sampling``) from ``generator`` or ``att_noise``.
    ``features``: the cached frozen features of ``batch["images"]``."""
    if features is None:
        features = frozen_features(cap, batch["images"])
    _, metrics = attention_loss(
        cap, features, batch, train=False,
        alpha_reg=alpha_reg,
        hard_eval_sampling=cap.spec.attention == "hard",
        generator=generator, att_noise=att_noise,
        denoms=_sharded_denoms(batch))
    return _detached(metrics)


@full_f32()
def nic_train_step(cap: Captioner, optimizer: torch.optim.Optimizer,
                   batch: DeviceBatch, *,
                   generator: Optional[torch.Generator] = None,
                   dropout_keep=None,
                   features: Optional[torch.Tensor] = None,
                   accum_steps: int = 1) -> Metrics:
    """One AdamW step of NIC (projection and decoder): output dropout from
    ``generator`` or ``dropout_keep``. ``features``: the pooled backbone
    features of ``batch["images"]``. ``accum_steps``: as
    ``attention_train_step``'s."""
    if features is None:
        features = frozen_features(cap, batch["images"])
    if accum_steps > 1:
        denom = nic_denom(batch)
        return _accumulate(optimizer, lambda j, mb, feats: nic_loss_of(
            cap, feats, mb, train=True, generator=generator,
            dropout_keep=_micro_hook(dropout_keep, j), denom=denom),
            batch, features, accum_steps)
    loss, metrics = nic_loss_of(
        cap, features, batch, train=True, generator=generator,
        dropout_keep=dropout_keep,
        denom=nic_denom(batch) if make_mesh().sharded else None)
    return _apply(optimizer, loss, metrics)


@torch.no_grad()
@full_f32()
def nic_eval_step(cap: Captioner, batch: DeviceBatch,
                  features: Optional[torch.Tensor] = None) -> Metrics:
    if features is None:
        features = frozen_features(cap, batch["images"])
    _, metrics = nic_loss_of(
        cap, features, batch, train=False,
        denom=nic_denom(batch) if make_mesh().sharded else None)
    return _detached(metrics)
