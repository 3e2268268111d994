"""The mixed-precision decoder (``decoder_dtype=torch.bfloat16``, the JAX
``cfg.decoder_dtype = "bfloat16"``): one AdamW step of base-soft, nic and
mdepth-soft == the JAX package's bf16 step on its own noise, the bf16
trajectory within 3% of the f32 one (the JAX test's bound), the f32 path
unchanged, f32 parameters and AdamW state, and the decode paths' refusal.

Tolerances, from bf16's epsilon (``EPS`` = 2^-7, unit roundoff 2^-8):

* the losses within ``U`` = 2^-8 relative: the two packages round the same
  bf16 ops (the attention, the gate, the LSTM state) at different points,
  and the loss, a mean of f32 log-softmax terms, is held to one rounding of
  a bf16 value (measured on a CPU: at most 5e-5);
* the parameters after one AdamW step: the step is ~lr * sign(g), so an
  element agrees within rtol 1e-3 / atol 2e-5 (the f32 bounds) unless its
  gradient is at the rounding level, where the sign can flip and the two
  differ by up to 2 * lr: a port gradient below ``EPS`` of its tensor's
  largest, or below ``EPS`` * 1e-3 (the scale of the attention scorer's
  gradients) ~ 8e-6 (the zero-by-symmetry ``att_b_full``; measured on a
  CPU). The attention scorer's gradients (``att_*``) pass the softmax
  Jacobian, whose cancellation over the tests' K=4 regions turns bf16's
  rounding into large relative errors: measured on a CPU, each package's
  bf16 gradients of ``att_w_enc``, ``att_b_enc`` and ``att_w_dec`` lie
  3-12% (base-soft) and 19-29% (mdepth-soft) of their tensor's largest
  from the f32 step's, the port's closer than JAX's, so those elements
  get the room below ``ATT_NOISE`` = 0.3 of their tensor's largest.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from depth_image_captioning_pub_tpu.config import ConfigTrain as JaxConfig
from depth_image_captioning_pub_tpu.engine import steps as jsteps
from depth_image_captioning_pub_tpu.models.captioner import (
    build_captioner as jax_build_captioner)
from depth_image_captioning_pub_torch.config import ConfigTrain
from depth_image_captioning_pub_torch.engine import steps as tsteps
from depth_image_captioning_pub_torch.engine import train as ttrain
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    flatten_tree, params_from_jax, params_to_jax)

import test_torch_train_steps as base
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

EPS = float(torch.finfo(torch.bfloat16).eps)        # 2^-7
U = EPS / 2                                         # 2^-8
SMALL_ABS = EPS * 1e-3
ATT_NOISE = 0.3
BF16 = torch.bfloat16


class BF16Twin(base.Twin):
    """``Twin`` with the JAX decoder (and mdepth's MLP) in bf16, and a bf16
    port captioner."""

    def __init__(self, kind):
        self.kind, self.dropout = kind, 0.5
        jcfg, tcfg = JaxConfig(), ConfigTrain()
        for cfg in (jcfg, tcfg):
            cfg.lr, cfg.max_caption_len, cfg.dropout = base.LR, base.L, 0.5
            cfg.nic_dim_embedding = 20
        self.tcfg = tcfg
        cap = jax_build_captioner(kind, base.V, jcfg,
                                  encoder_dtype=jnp.float32,
                                  decoder_dtype=jnp.bfloat16,
                                  resnet_layers=base.LAYERS)
        self.jcap = cap
        self.init = base._np(cap.init(jax.random.PRNGKey(0),
                                      image_hw=(base.HW, base.HW)))
        self.opt = jsteps.make_optimizer(base.LR)
        self.alpha_reg = 0.7 if cap.spec.attention == "soft" else 0.0
        if kind == "nic":
            self.step = jsteps.make_nic_train_step(
                cap.encoder_apply(), cap.decoder_apply(), self.opt,
                donate=False)
        else:
            self.step = jsteps.make_attention_train_step(
                cap.encoder_apply(), cap.decoder_apply(), self.opt,
                alpha_reg=self.alpha_reg,
                depth_encoder_apply=cap.depth_encoder_apply(), donate=False)

    def port(self, dtype=BF16):
        cap = build_captioner(self.kind, base.V, self.tcfg,
                              encoder_dtype=torch.float32,
                              resnet_layers=base.LAYERS, device="cpu",
                              decoder_dtype=dtype)
        params_from_jax(cap, *self.init)
        return cap, tsteps.make_optimizer(cap, base.LR)


@functools.lru_cache(maxsize=None)
def twin(kind):
    return BF16Twin(kind)


def grads_by_leaf(t, cap):
    """The port's gradients in the JAX trees' flat layout."""
    holder, _ = t.port(torch.float32)
    with torch.no_grad():
        for h, p in zip(holder.trainable_parameters(),
                        cap.trainable_parameters()):
            h.copy_(p.grad)
    return flatten_tree(params_to_jax(holder)[0])


@pytest.mark.parametrize("kind", ["base-soft", "nic", "mdepth-soft"])
def test_bf16_step_matches_jax(kind):
    t = twin(kind)
    batch, rng = base.make_batch(1, t.jcap.spec.uses_depth), \
        jax.random.PRNGKey(1)
    state, want = t.jax_train(t.jax_state(), batch, rng)
    cap, opt = t.port()
    got = t.port_train(cap, opt, batch, rng)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=U,
                                   atol=0, err_msg=k)
    grads = grads_by_leaf(t, cap)
    g_tree = flatten_tree(params_to_jax(cap)[0])
    w_tree = flatten_tree(base._np(state.params))
    assert set(g_tree) == set(w_tree) == set(grads)
    for name, w in w_tree.items():
        g = np.abs(grads[name])
        noise = ATT_NOISE if name.startswith("decoder/att_") else EPS
        small = (g < noise * g.max()) | (g < SMALL_ABS)
        tol = (base.PARAM_ATOL + base.PARAM_RTOL * np.abs(w)
               + 2 * base.LR * small)
        assert (np.abs(g_tree[name] - w) <= tol).all(), (
            name, np.abs(g_tree[name] - w).max())
    # parameters and AdamW's state stay f32
    assert all(p.dtype == torch.float32 for p in cap.trainable_parameters())
    for st in opt.state.values():
        assert all(v.dtype == torch.float32 for k, v in st.items()
                   if k != "step"), st.keys()


def _trajectory(dtype, n=3):
    """Losses of ``n`` AdamW steps of a seeded base-soft captioner on one
    batch (the JAX test's set-up: B=8, V=24, L=8, lr 1e-3), the dropout
    masks from one seeded generator."""
    cfg = ConfigTrain()
    cfg.max_caption_len = 8
    cap = build_captioner("base-soft", 24, cfg, encoder_dtype=torch.float32,
                          resnet_layers=base.LAYERS, device="cpu",
                          decoder_dtype=dtype)
    cap.init(torch.Generator().manual_seed(0))
    opt = tsteps.make_optimizer(cap, 1e-3)
    rng = np.random.default_rng(0)
    batch = {"images": torch.from_numpy(rng.integers(
                 0, 256, (8, 64, 64, 3), dtype=np.uint8)),
             "captions": torch.from_numpy(
                 rng.integers(0, 24, (8, 8)).astype(np.int32)),
             "lengths": torch.full((8,), 8, dtype=torch.int32),
             "pad_mask": torch.ones((8,), dtype=torch.bool)}
    feats = tsteps.frozen_features(cap, batch["images"])
    gen = torch.Generator().manual_seed(5)
    return [tsteps.attention_train_step(cap, opt, batch, alpha_reg=0.7,
                                        generator=gen,
                                        features=feats)["loss"].item()
            for _ in range(n)], cap


def test_bf16_trajectory_within_3_percent_of_f32():
    l16, cap = _trajectory(BF16)
    l32, _ = _trajectory(torch.float32)
    assert all(np.isfinite(l16)), l16
    for a, b in zip(l16, l32):
        assert a == pytest.approx(b, rel=3e-2)
    assert l16[-1] < l16[0], "bf16 training did not reduce the loss"
    assert l16 != l32      # the bf16 path ran
    assert cap.decoder.dtype == BF16


def test_f32_path_unchanged():
    """An f32 decoder's casts are the parameters themselves (``_w``), so
    the one teacher-forced pass runs the ops it ran before the bf16
    decoder existed; its logits and alphas are f32 and equal those of the
    decoder built without ``dtype``, bit for bit."""
    batch = base.port_batch(base.make_batch(4))
    outs = []
    for kw in ({}, {"decoder_dtype": torch.float32}):
        cap = build_captioner("base-soft", base.V,
                              encoder_dtype=torch.float32,
                              resnet_layers=base.LAYERS, device="cpu", **kw)
        cap.init(torch.Generator().manual_seed(4))
        dec = cap.decoder
        assert all(dec._w(p) is p for p in dec.parameters())
        feats = tsteps.frozen_features(cap, batch["images"])
        with torch.no_grad():
            outs.append(dec(feats, batch["captions"]))
    for a, b in zip(*outs):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_bf16_decoder_refuses_the_kernels():
    """K1 (sampling), K2 (greedy), K4 (beam) and K3 (NIC greedy) refuse a
    bf16 decoder, as the JAX kernel paths do; ``train`` builds the bf16
    captioner from ``cfg.decoder_dtype`` and refuses another name."""
    cfg = ConfigTrain()
    feats = torch.zeros((2, 4, cfg.dim_encoder))
    cap = build_captioner("base-soft", base.V, cfg,
                          resnet_layers=base.LAYERS, device="cpu",
                          decoder_dtype=BF16)
    dec = cap.decoder
    for call in (lambda: dec.greedy_sample(feats, 0),
                 lambda: dec.beam_sample(feats, 0, 1, beam_size=2),
                 lambda: dec.stochastic_sample(feats, 0,
                                               torch.Generator()),
                 lambda: dec.seq_weights()):
        with pytest.raises(ValueError, match="requires a float32 decoder"):
            call()
    nic = build_captioner("nic", base.V, cfg, resnet_layers=base.LAYERS,
                          device="cpu", decoder_dtype=BF16).decoder
    with pytest.raises(ValueError, match="requires a float32 decoder"):
        nic.greedy_sample(torch.zeros((2, cfg.nic_dim_embedding)))
    cfg.decoder_dtype = "bfloat16"
    assert ttrain.decoder_dtype(cfg) == BF16
    cfg.decoder_dtype = "float16"
    with pytest.raises(ValueError, match="decoder_dtype"):
        ttrain.decoder_dtype(cfg)
