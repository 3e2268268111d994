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
rate, as the JAX trainer runs it. Gradient accumulation is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from depth_image_captioning_pub_torch.engine.losses import (
    Metrics, caption_loss, nic_loss)
from depth_image_captioning_pub_torch.models.captioner import Captioner
from depth_image_captioning_pub_torch.ops.image_ops import (
    imagenet_normalize, to_unit_float)
from depth_image_captioning_pub_torch.ops.pooling import global_avg_pool
from depth_image_captioning_pub_torch.ops.precision import full_f32

TRAIN_REST_ITEM = "ROADMAP.md, Queue A item 7"
DeviceBatch = Dict[str, torch.Tensor]


def make_optimizer(cap: Captioner, lr: float,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW over ``cap.trainable_parameters()`` only."""
    return torch.optim.AdamW(cap.trainable_parameters(), lr=lr,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def check_accum_steps(accum_steps: int) -> None:
    if accum_steps != 1:
        raise NotImplementedError(
            f"gradient accumulation (accum_steps={accum_steps}) is not "
            f"ported yet ({TRAIN_REST_ITEM}.3)")


def batch_to_device(batch, device, depth=None) -> DeviceBatch:
    """A ``data/pipeline.Batch`` as device tensors: images (uint8 NHWC),
    captions, lengths, pad_mask and, for depth kinds, ``depth`` (the
    provider's [B, 224, 224, 1] maps, numpy or a tensor)."""
    out = {name: torch.from_numpy(np.ascontiguousarray(
        getattr(batch, name))).to(device, non_blocking=True)
        for name in ("images", "captions", "lengths", "pad_mask")}
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
                   dropout_keep=None, att_noise=None):
    """(loss, metrics) of the attention kinds on frozen ``features``: the
    depth encoder (batch statistics when ``train``), the teacher-forced
    decoder and ``caption_loss``."""
    dep = None
    if cap.spec.uses_depth:
        dep = cap.depth_encoder_apply(train=train)(batch["depth"])
    logits, alphas = cap.decoder(
        features, batch["captions"], dep, train=train, temp=temp,
        hard_eval_sampling=hard_eval_sampling, generator=generator,
        dropout_keep=dropout_keep, att_noise=att_noise)
    return caption_loss(logits, batch["captions"], batch["lengths"], alphas,
                        batch["pad_mask"], alpha_reg)


def nic_loss_of(cap: Captioner, pooled: torch.Tensor, batch: DeviceBatch,
                *, train: bool, generator: Optional[torch.Generator] = None,
                dropout_keep=None):
    """(loss, metrics) of NIC on the pooled backbone features: the
    projection, the teacher-forced decoder and ``nic_loss``."""
    logits = cap.decoder(cap.projection(pooled), batch["captions"],
                         train=train, generator=generator,
                         dropout_keep=dropout_keep)
    return nic_loss(logits, batch["captions"], batch["lengths"],
                    batch["pad_mask"])


def _apply(optimizer: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()


def _detached(metrics: Metrics) -> Metrics:
    return {k: v.detach() for k, v in metrics.items()}


@full_f32()
def attention_train_step(cap: Captioner, optimizer: torch.optim.Optimizer,
                         batch: DeviceBatch, *, temp=1.0,
                         alpha_reg: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         dropout_keep=None, att_noise=None,
                         features: Optional[torch.Tensor] = None
                         ) -> Metrics:
    """One AdamW step of base-*, depth-* and mdepth-*: dropout, and hard
    attention's Gumbel-softmax at temperature ``temp``, from
    ``generator`` or the hooks. ``features`` skips the frozen encoder
    (its output on ``batch["images"]``)."""
    if features is None:
        features = frozen_features(cap, batch["images"])
    loss, metrics = attention_loss(
        cap, features, batch, train=True, temp=temp, alpha_reg=alpha_reg,
        generator=generator, dropout_keep=dropout_keep, att_noise=att_noise)
    _apply(optimizer, loss)
    return _detached(metrics)


@torch.no_grad()
@full_f32()
def attention_eval_step(cap: Captioner, batch: DeviceBatch, *,
                        alpha_reg: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        att_noise=None) -> Metrics:
    """Validation loss, teacher forced: BN on running statistics, no
    dropout; hard attention takes Gumbel-max regions (the JAX
    ``hard_eval_sampling``) from ``generator`` or ``att_noise``."""
    _, metrics = attention_loss(
        cap, frozen_features(cap, batch["images"]), batch, train=False,
        alpha_reg=alpha_reg,
        hard_eval_sampling=cap.spec.attention == "hard",
        generator=generator, att_noise=att_noise)
    return _detached(metrics)


@full_f32()
def nic_train_step(cap: Captioner, optimizer: torch.optim.Optimizer,
                   batch: DeviceBatch, *,
                   generator: Optional[torch.Generator] = None,
                   dropout_keep=None,
                   features: Optional[torch.Tensor] = None) -> Metrics:
    """One AdamW step of NIC (projection and decoder): output dropout from
    ``generator`` or ``dropout_keep``. ``features``: the pooled backbone
    features of ``batch["images"]``."""
    if features is None:
        features = frozen_features(cap, batch["images"])
    loss, metrics = nic_loss_of(cap, features, batch, train=True,
                                generator=generator,
                                dropout_keep=dropout_keep)
    _apply(optimizer, loss)
    return _detached(metrics)


@torch.no_grad()
@full_f32()
def nic_eval_step(cap: Captioner, batch: DeviceBatch) -> Metrics:
    _, metrics = nic_loss_of(cap, frozen_features(cap, batch["images"]),
                             batch, train=False)
    return _detached(metrics)
