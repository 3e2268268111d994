"""One AdamW train step and one eval step of base-soft, base-hard and nic
(``tests/test_torch_train_depth_steps.py``: the four depth kinds), and a
4-step trajectory with dropout on for base-soft and nic: the port's
``engine/steps.py`` == the JAX package's jitted ``engine/steps.py``.

Both sides start from one JAX ``Captioner.init`` (ResNet blocks 1,1,1,1 at
64x64 (a 2x2 grid: the regions differ), f32 encoders, V=24, L=8, B=5
with one pad row), bridged into the
port with ``params_from_jax``; the batches are made from a seed with
numpy, and the port's dropout masks and Gumbel noise are the JAX step's
own draws (its ``rng`` through ``fold_in(rng, t)`` -> ``split``, NIC's
``bernoulli(rng)``), fed through the decoders' hooks. Bounds: the loss
rtol/atol 1e-5; every updated parameter ``rtol=1e-3, atol=2e-5``, as
``tests/test_trajectory_twin.py``; BN statistics 1e-5; eval losses 1e-5.
One exception, counted per element. AdamW's first steps are
lr * m / (sqrt(v) + eps) with eps 1e-8: about lr * sign(g) for a gradient
well above eps, whatever its rounding, but for a gradient below ~1e-6 the
step follows the gradient's relative error, which rounding makes large
where the gradient is a cancellation around zero (the attention biases of
a unit active on every region: the softmax is shift-invariant; the depth
CNN's conv biases: each BN subtracts its batch mean; a feature channel
that a ReLU leaves just above zero). So an element gets 2 * lr more room
for each step at which its port gradient was below 1e-6 (``SMALL_GRAD``)
or, in the depth CNN, below 5e-2 of its tensor's max |g|
(``DEPTH_SMALL``): the gradient reaching the CNN is mostly constant over
each channel's positions (the decoder's initial state reads the regions'
mean), which each train-mode BN's backward subtracts, so the remainder
carries the f32 convs' rounding at up to ~3e-2 of its max (measured on a
CPU against the JAX step).
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
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    flatten_tree, params_from_jax, params_to_jax)

LAYERS, HW, V, L, B = (1, 1, 1, 1), 64, 24, 8, 5
LR, TEMP, STEPS = 1e-3, 0.7, 4
SMALL_GRAD = 1e-6
DEPTH_SMALL = 5e-2
LOSS_TOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-3, 2e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_batch(seed, depth=False):
    """A numpy batch: uint8 images, <start>-led captions of lengths 2..L,
    the last row a pad row; depth maps [B, 224, 224, 1] in [0, 1]."""
    rng = np.random.default_rng(seed)
    caps = rng.integers(0, V - 4, (B, L)).astype(np.int32)
    caps[:, 0] = V - 4                      # <start>
    lengths = rng.integers(2, L + 1, (B,)).astype(np.int32)
    batch = {"images": rng.integers(0, 256, (B, HW, HW, 3), dtype=np.uint8),
             "captions": caps, "lengths": lengths,
             "pad_mask": np.array([True] * (B - 1) + [False])}
    if depth:
        batch["depth"] = rng.random((B, 224, 224, 1)).astype(np.float32)
    return batch


def port_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def jax_hooks(kind, rng, dropout, nic_shape=None):
    """The JAX step's draws for key ``rng``, as the port's hooks."""
    if kind == "nic":
        keep = np.asarray(jax.random.bernoulli(rng, 1.0 - dropout,
                                               nic_shape))
        return {"dropout_keep": lambda t, shape: torch.from_numpy(keep)}

    def keys(t):
        return jax.random.split(jax.random.fold_in(rng, t))
    return {"att_noise": lambda t, shape: torch.from_numpy(np.asarray(
                jax.random.gumbel(keys(t)[0], shape, jnp.float32))),
            "dropout_keep": lambda t, shape: torch.from_numpy(np.asarray(
                jax.random.bernoulli(keys(t)[1], 1.0 - dropout, shape)))}


class Twin:
    """One kind in both packages: the JAX captioner, its jitted train and
    eval steps, and a fresh port captioner + optimizer per ``port()``
    call, both from the same JAX init."""

    def __init__(self, kind, dropout):
        self.kind, self.dropout = kind, dropout
        jcfg, tcfg = JaxConfig(), ConfigTrain()
        for cfg in (jcfg, tcfg):
            cfg.lr, cfg.max_caption_len, cfg.dropout = LR, L, dropout
            cfg.nic_dim_embedding = 20
        self.tcfg = tcfg
        cap = jax_build_captioner(kind, V, jcfg, encoder_dtype=jnp.float32,
                                  resnet_layers=LAYERS)
        self.jcap = cap
        self.init = _np(cap.init(jax.random.PRNGKey(0), image_hw=(HW, HW)))
        self.opt = jsteps.make_optimizer(LR)
        self.alpha_reg = 0.7 if cap.spec.attention == "soft" else 0.0
        if kind == "nic":
            self.step = jsteps.make_nic_train_step(
                cap.encoder_apply(), cap.decoder_apply(), self.opt,
                donate=False)
            self.eval = jsteps.make_nic_eval_step(cap.encoder_apply(),
                                                  cap.decoder_apply())
        else:
            self.step = jsteps.make_attention_train_step(
                cap.encoder_apply(), cap.decoder_apply(), self.opt,
                alpha_reg=self.alpha_reg,
                depth_encoder_apply=cap.depth_encoder_apply(), donate=False)
            self.eval = jsteps.make_attention_eval_step(
                cap.encoder_apply(), cap.decoder_apply(),
                alpha_reg=self.alpha_reg,
                depth_encoder_apply=cap.depth_encoder_apply(),
                hard_eval_sampling=cap.spec.attention == "hard")

    def jax_state(self):
        params, frozen, stats = (jax.tree_util.tree_map(jnp.asarray, t)
                                 for t in self.init)
        return jsteps.TrainState(params, self.opt.init(params), frozen,
                                 stats, jnp.int32(0))

    def jax_train(self, state, batch, rng):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if self.kind == "nic":
            return self.step(state, jb, rng)
        return self.step(state, jb, rng, jnp.float32(TEMP))

    def jax_eval(self, state, batch, rng):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if self.kind == "nic":
            return self.eval(state, jb)
        return self.eval(state, jb, rng)

    def port(self):
        cap = build_captioner(self.kind, V, self.tcfg,
                              encoder_dtype=torch.float32,
                              resnet_layers=LAYERS, device="cpu")
        params_from_jax(cap, *self.init)
        return cap, tsteps.make_optimizer(cap, LR)

    def port_train(self, cap, opt, batch, rng):
        rate = self.tcfg.nic_dropout if self.kind == "nic" else self.dropout
        hooks = jax_hooks(self.kind, rng, rate, (B, L, self.tcfg.dim_hidden))
        if self.kind == "nic":
            return tsteps.nic_train_step(cap, opt, port_batch(batch),
                                         **hooks)
        return tsteps.attention_train_step(
            cap, opt, port_batch(batch), temp=TEMP,
            alpha_reg=self.alpha_reg, **hooks)

    def port_eval(self, cap, batch, rng):
        if self.kind == "nic":
            return tsteps.nic_eval_step(cap, port_batch(batch))
        return tsteps.attention_eval_step(
            cap, port_batch(batch), alpha_reg=self.alpha_reg,
            att_noise=jax_hooks(self.kind, rng, 0.0)["att_noise"])


def assert_metrics_close(got, want, tol=LOSS_TOL):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        assert got[k].dim() == 0
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)


def count_noise(cap, counts=None):
    """Add 1 where this step's gradient was small (``SMALL_GRAD``,
    ``DEPTH_SMALL``)."""
    params = cap.trainable_parameters()
    depth = {id(p) for p in (cap.depth_module.parameters()
                             if cap.spec.depth_encoder == "cnn" else ())}
    counts = counts or [torch.zeros_like(p) for p in params]
    for c, p in zip(counts, params):
        if p.grad is None:
            c += 1.0
            continue
        g = p.grad.abs()
        small = g < SMALL_GRAD
        if id(p) in depth:
            small |= g < DEPTH_SMALL * g.max()
        c += small.float()
    return counts


def assert_params_close(twin, cap, state, counts):
    """Every trainable leaf within PARAM_RTOL/ATOL of JAX's (plus 2 * lr a
    step with a small gradient), the BN statistics within 1e-5."""
    trainable, _, stats = params_to_jax(cap)
    got = flatten_tree(trainable)
    want = flatten_tree(_np(state.params))
    holder, _ = twin.port()              # the counts in the trees' layout
    with torch.no_grad():
        for h, c in zip(holder.trainable_parameters(), counts):
            h.copy_(c)
    extra = flatten_tree(params_to_jax(holder)[0])
    assert set(got) == set(want) == set(extra)
    for name, w in want.items():
        tol = PARAM_ATOL + PARAM_RTOL * np.abs(w) + 2 * LR * extra[name]
        assert (np.abs(got[name] - w) <= tol).all(), (
            name, np.abs(got[name] - w).max())
    got_s, want_s = flatten_tree(stats), flatten_tree(_np(state.batch_stats))
    assert set(got_s) == set(want_s)
    for name, w in want_s.items():
        np.testing.assert_allclose(got_s[name], w, rtol=0, atol=1e-5,
                                   err_msg=name)


def check_one_step(twin, seed=1):
    """One train step, then one eval step on another batch, both sides."""
    depth = twin.jcap.spec.uses_depth
    batch, vbatch = make_batch(seed, depth), make_batch(seed + 50, depth)
    rng, vrng = jax.random.PRNGKey(seed), jax.random.PRNGKey(seed + 50)
    state, want = twin.jax_train(twin.jax_state(), batch, rng)
    cap, opt = twin.port()
    before = [p.detach().clone() for p in cap.trainable_parameters()]
    got = twin.port_train(cap, opt, batch, rng)
    assert_metrics_close(got, want)
    assert_params_close(twin, cap, state, count_noise(cap))
    assert all(not torch.equal(b, p) for b, p in
               zip(before, cap.trainable_parameters()) if p.numel() > 1)
    assert_metrics_close(twin.port_eval(cap, vbatch, vrng),
                         twin.jax_eval(state, vbatch, vrng))


def assert_within_steps(cap, state, stats_rtol):
    """Every trainable leaf within 2 * lr * STEPS of JAX's (the steps of
    AdamW apart, each at most lr), the BN statistics within ``stats_rtol``
    of their largest value."""
    trainable, _, stats = params_to_jax(cap)
    got, want = flatten_tree(trainable), flatten_tree(_np(state.params))
    assert set(got) == set(want)
    for name, w in want.items():
        assert np.abs(got[name] - w).max() <= 2 * LR * STEPS, name
    got_s, want_s = flatten_tree(stats), flatten_tree(_np(state.batch_stats))
    assert set(got_s) == set(want_s)
    for name, w in want_s.items():
        assert np.abs(got_s[name] - w).max() <= stats_rtol * np.abs(w).max()


def check_trajectory(twin, loss_tol=LOSS_TOL, stats_rtol=None):
    """STEPS steps on fresh batches, dropout on: losses per step (rtol and
    atol ``loss_tol``) and the final parameters and statistics
    (``assert_params_close``; with ``stats_rtol``, ``assert_within_steps``
    instead)."""
    depth = twin.jcap.spec.uses_depth
    state = twin.jax_state()
    cap, opt = twin.port()
    counts = None
    for s in range(STEPS):
        batch, rng = make_batch(100 + s, depth), jax.random.PRNGKey(100 + s)
        state, want = twin.jax_train(state, batch, rng)
        got = twin.port_train(cap, opt, batch, rng)
        assert_metrics_close(got, want, loss_tol)
        counts = count_noise(cap, counts)
    if stats_rtol is None:
        assert_params_close(twin, cap, state, counts)
    else:
        assert_within_steps(cap, state, stats_rtol)


@functools.lru_cache(maxsize=None)
def twin(kind, dropout=0.5):
    return Twin(kind, dropout)


@pytest.mark.parametrize("kind", ["base-soft", "base-hard", "nic"])
def test_train_and_eval_step_match_jax(kind):
    check_one_step(twin(kind))


@pytest.mark.parametrize("kind", ["base-soft", "nic"])
def test_four_step_trajectory_matches_jax(kind):
    check_trajectory(twin(kind))


def test_step_runs_in_full_f32_and_refuses_accumulation(monkeypatch):
    """TF32 is off through the whole step (forward, backward, AdamW) and
    the caller's flags come back after it; ``accum_steps`` > 1 raises,
    naming the ROADMAP item."""
    t = twin("base-soft")
    cap, opt = t.port()
    seen = []
    step = opt.step

    def spy(*a, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return step(*a, **kw)
    monkeypatch.setattr(opt, "step", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    t.port_train(cap, opt, make_batch(3), jax.random.PRNGKey(3))
    assert seen == [(False, False)]
    assert torch.backends.cudnn.allow_tf32 is True
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        tsteps.check_accum_steps(2)
    tsteps.check_accum_steps(1)
    # AdamW holds exactly the trainable tensors, the backbone frozen
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    assert held == {id(p) for p in cap.trainable_parameters()}
    assert not any(p.requires_grad for p in cap.encoder.parameters())
