"""Gradient accumulation (``accum_steps`` k > 1 in ``engine/steps.py``):
the port's step == the JAX package's ``accum_steps`` step, and the
accumulated step == the one-shot step.

* The sum over k microbatches: with no noise (dropout 0, soft attention)
  and no BatchNorm (base-soft, mdepth-soft, nic), the k=3 step's
  metrics and gradients equal the one-shot step's within 1e-6 (the
  microbatches' losses are normalized by the whole batch's token and row
  counts; only the order of the f32 sums differs). The gradients are read
  as the change of an SGD step at lr 1.
* JAX parity: base-soft, depth-soft (its BatchNorms move their running
  statistics microbatch by microbatch) and nic, one AdamW step at k=2 on
  both sides from one JAX init, with the port's noise the JAX step's own:
  microbatch j's dropout masks and Gumbel noise from
  ``jax.random.split(rng, 2)[j]``, fed through the hooks, which take the
  microbatch index first. Bounds: ``tests/test_torch_train_steps.py``'s
  (loss 1e-5, parameters rtol 1e-3 / atol 2e-5 with 2 * lr of room for a
  small gradient, BN statistics 1e-5).
* B % k != 0 raises ValueError; the trainer's padding
  (``parallel/mesh.pad_batch_to_devices``) rounds up to a multiple of k.

B=6 (one pad row), L=8, 64x64 images, ResNet blocks 1,1,1,1, f32
encoders, V=24.
"""

import functools

import numpy as np
import pytest
import jax
import torch

from depth_image_captioning_pub_tpu.engine import steps as jsteps
from depth_image_captioning_pub_torch.config import ConfigTrain
from depth_image_captioning_pub_torch.engine import steps as tsteps
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.parallel.mesh import pad_batch_to_devices

import test_torch_train_steps as base
from test_torch_train_steps import (
    Twin, assert_metrics_close, assert_params_close, count_noise, jax_hooks)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

B, K_ACCUM = 6, 2
SUM_TOL = 1e-6


def make_batch(seed, depth=False, bsz=B):
    """``base.make_batch`` at ``bsz`` rows (the last a pad row)."""
    rng = np.random.default_rng(seed)
    caps = rng.integers(0, base.V - 4, (bsz, base.L)).astype(np.int32)
    caps[:, 0] = base.V - 4
    lengths = rng.integers(2, base.L + 1, (bsz,)).astype(np.int32)
    batch = {"images": rng.integers(0, 256, (bsz, base.HW, base.HW, 3),
                                    dtype=np.uint8),
             "captions": caps, "lengths": lengths,
             "pad_mask": np.array([True] * (bsz - 1) + [False])}
    if depth:
        batch["depth"] = rng.random((bsz, 224, 224, 1)).astype(np.float32)
    return batch


class AccumTwin(Twin):
    """``Twin`` whose JAX train step accumulates over ``K_ACCUM``
    microbatches, and whose port step does too, on the JAX step's own
    microbatch keys."""

    def __init__(self, kind, dropout):
        super().__init__(kind, dropout)
        cap = self.jcap
        if kind == "nic":
            self.step = jsteps.make_nic_train_step(
                cap.encoder_apply(), cap.decoder_apply(), self.opt,
                donate=False, accum_steps=K_ACCUM)
        else:
            self.step = jsteps.make_attention_train_step(
                cap.encoder_apply(), cap.decoder_apply(), self.opt,
                alpha_reg=self.alpha_reg,
                depth_encoder_apply=cap.depth_encoder_apply(), donate=False,
                accum_steps=K_ACCUM)

    def port_train(self, cap, opt, batch, rng):
        rate = self.tcfg.nic_dropout if self.kind == "nic" else self.dropout
        shape = (B // K_ACCUM, base.L, self.tcfg.dim_hidden)
        per = [jax_hooks(self.kind, r, rate, shape)
               for r in jax.random.split(rng, K_ACCUM)]
        hooks = {name: (lambda j, t, s, name=name: per[j][name](t, s))
                 for name in per[0]}
        kw = {} if self.kind == "nic" else {"temp": base.TEMP,
                                            "alpha_reg": self.alpha_reg}
        step = (tsteps.nic_train_step if self.kind == "nic"
                else tsteps.attention_train_step)
        return step(cap, opt, base.port_batch(batch), accum_steps=K_ACCUM,
                    **kw, **hooks)


@functools.lru_cache(maxsize=None)
def twin(kind):
    return AccumTwin(kind, 0.5)


@pytest.mark.parametrize("kind", ["base-soft", "depth-soft", "nic"])
def test_accumulated_step_matches_jax(kind):
    t = twin(kind)
    depth = t.jcap.spec.uses_depth
    batch, rng = make_batch(7, depth), jax.random.PRNGKey(7)
    state, want = t.jax_train(t.jax_state(), batch, rng)
    cap, opt = t.port()
    got = t.port_train(cap, opt, batch, rng)
    assert_metrics_close(got, want)
    assert_params_close(t, cap, state, count_noise(cap))


def _sgd_deltas(kind, accum, batch):
    """(metrics, parameter changes) of one SGD step at lr 1 (the changes
    are the gradients) at ``accum`` microbatches, dropout 0."""
    cfg = ConfigTrain()
    cfg.max_caption_len, cfg.nic_dim_embedding = base.L, 20
    cap = build_captioner(kind, base.V, cfg, encoder_dtype=torch.float32,
                          resnet_layers=base.LAYERS, device="cpu")
    cap.init(torch.Generator().manual_seed(3))
    cap.decoder.dropout = 0.0
    opt = torch.optim.SGD(cap.trainable_parameters(), lr=1.0)
    before = [p.detach().clone() for p in cap.trainable_parameters()]
    pb = base.port_batch(batch)
    if kind == "nic":
        m = tsteps.nic_train_step(cap, opt, pb, accum_steps=accum)
    else:
        m = tsteps.attention_train_step(cap, opt, pb, alpha_reg=0.7,
                                        accum_steps=accum)
    return m, [b - p.detach() for b, p in
               zip(before, cap.trainable_parameters())]


@pytest.mark.parametrize("kind", ["base-soft", "mdepth-soft", "nic"])
def test_microbatch_sum_equals_one_shot(kind):
    batch = make_batch(11, kind.startswith("mdepth"))
    m1, g1 = _sgd_deltas(kind, 1, batch)
    mk, gk = _sgd_deltas(kind, 3, batch)
    assert set(mk) == set(m1)
    for name in m1:
        np.testing.assert_allclose(mk[name].item(), m1[name].item(),
                                   rtol=0, atol=SUM_TOL, err_msg=name)
    for a, b in zip(gk, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=SUM_TOL)


def test_indivisible_batch_raises():
    cap = build_captioner("base-soft", base.V, encoder_dtype=torch.float32,
                          resnet_layers=base.LAYERS, device="cpu")
    opt = tsteps.make_optimizer(cap, base.LR)
    batch = base.port_batch(make_batch(2, bsz=5))
    with pytest.raises(ValueError, match="not divisible by accum_steps=2"):
        tsteps.attention_train_step(cap, opt, batch, accum_steps=2)
    with pytest.raises(ValueError, match="accum_steps must be >= 1"):
        tsteps.check_accum_steps(0)
    # the trainer's padding: a multiple of ranks * k (one rank here)
    assert [pad_batch_to_devices(30, k) for k in (1, 2, 3, 4, 7)] == \
        [30, 30, 30, 32, 35]
