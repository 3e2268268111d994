"""The training slice's ops and modules: the port == the JAX package.

Same numpy-made inputs, weights bridged name for name, and the JAX
package's own noise replayed through the port's hooks (the Gumbel draws of
``fold_in(rng, t)`` -> ``split`` -> ``akey``, the dropout keep-masks of
``dkey``; NIC's one ``bernoulli(rng)``):

* ``gumbel_softmax_attention``: atol 1e-6;
* the teacher-forced ``AttentionDecoder.forward`` (soft and hard x none,
  add, concat fusion; train on and off, and hard's ``hard_eval_sampling``):
  logits and alphas atol 2e-5, the bound of ``tests/test_token_parity.py``;
* ``NICDecoder.forward`` with and without dropout: atol 2e-5;
* ``BatchNorm2d`` in train mode: output, new running statistics and
  gradients within 1e-5 of flax's ``nn.BatchNorm`` with
  ``mutable=["batch_stats"]``; ``DepthCNNEncoder`` in train mode, f32: the
  new running statistics 1e-5, the output at the f32 conv bound 1e-4;
* the losses, with and without ``denoms``: 1e-6.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from depth_image_captioning_pub_tpu.engine import losses as jlosses
from depth_image_captioning_pub_tpu.models.decoder import (
    AttentionDecoder as JaxDecoder)
from depth_image_captioning_pub_tpu.models.depth_encoders import (
    DepthCNNEncoder as JaxDepthCNNEncoder)
from depth_image_captioning_pub_tpu.models.nic import NICDecoder as JaxNIC
from depth_image_captioning_pub_tpu.ops import attention as jatt
from depth_image_captioning_pub_torch.engine import losses as tlosses
from depth_image_captioning_pub_torch.models.decoder import AttentionDecoder
from depth_image_captioning_pub_torch.models.depth_encoders import (
    BatchNorm2d, DepthCNNEncoder)
from depth_image_captioning_pub_torch.models.nic import NICDecoder
from depth_image_captioning_pub_torch.ops import attention as tatt
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    flax_state_dict, flax_trees)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

V, L, B, K = 24, 8, 5, 6
D_ENC, D_ATT, D_EMB, D_HID, D_DEP = 40, 16, 12, 16, 8
TOL = 2e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_noise(rng):
    """The JAX decoder's draws of step t, as the port's hooks."""
    def keys(t):
        return jax.random.split(jax.random.fold_in(rng, t))

    def att_noise(t, shape):
        return torch.from_numpy(np.asarray(
            jax.random.gumbel(keys(t)[0], shape, jnp.float32)))

    def dropout_keep(rate):
        return lambda t, shape: torch.from_numpy(np.asarray(
            jax.random.bernoulli(keys(t)[1], 1.0 - rate, shape)))
    return att_noise, dropout_keep


def test_gumbel_softmax_attention_matches_jax():
    rng = np.random.default_rng(0)
    w = [rng.normal(0, 0.3, s).astype(np.float32) for s in (
        (D_ENC, D_ATT), (D_ATT,), (D_HID, D_ATT), (D_ATT,), (D_ATT,), ())]
    feats = rng.normal(size=(B, K, D_ENC)).astype(np.float32)
    h = rng.normal(size=(B, D_HID)).astype(np.float32)
    g = rng.gumbel(size=(B, K)).astype(np.float32)
    jp = jatt.AttentionParams(*map(jnp.asarray, w))
    tp = tatt.AttentionParams(*map(torch.from_numpy, w))
    key = jax.random.PRNGKey(3)
    jg = np.asarray(jax.random.gumbel(key, (B, K), jnp.float32))
    for temp in (1.0, 0.5):
        want = jatt.gumbel_softmax_attention(
            jp, jnp.asarray(feats), jatt.project_features(jp, feats),
            jnp.asarray(h), jnp.float32(temp), key)
        got = tatt.gumbel_softmax_attention(
            tp, torch.from_numpy(feats),
            tatt.project_features(tp, torch.from_numpy(feats)),
            torch.from_numpy(h), temp, torch.from_numpy(jg))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
    # the noise and the temperature both move alpha
    base = tatt.gumbel_softmax_attention(
        tp, torch.from_numpy(feats),
        tatt.project_features(tp, torch.from_numpy(feats)),
        torch.from_numpy(h), 1.0, torch.from_numpy(g))[1]
    assert torch.allclose(base.sum(1), torch.ones(B))
    assert not torch.allclose(base, got[1])


DECODER_CASES = [(att, fusion) for att in ("soft", "hard")
                 for fusion in ("none", "add", "concat")]


@pytest.fixture(scope="module")
def decoders():
    """{(attention, fusion): (jax module, params, port module)} at small
    widths, the port's weights bridged from the JAX init."""
    out = {}
    for i, (att, fusion) in enumerate(DECODER_CASES):
        kw = dict(dim_attention=D_ATT, dim_embedding=D_EMB,
                  dim_encoder=D_ENC, dim_decoder=D_HID)
        jdec = JaxDecoder(vocab_size=V, attention_kind=att, fusion=fusion,
                          dim_depth=D_DEP, dropout=0.5, **kw)
        d_eff = D_ENC + (D_DEP if fusion == "concat" else 0)
        dep = (None if fusion == "none" else
               jnp.zeros((1, K, D_DEP if fusion == "concat" else D_ENC)))
        params = _np(jdec.init(jax.random.PRNGKey(i),
                               jnp.zeros((1, K, D_ENC)),
                               jnp.zeros((1, L), jnp.int32), dep,
                               train=False,
                               rng=jax.random.PRNGKey(0))["params"])
        tdec = AttentionDecoder(V, fusion=fusion, attention_kind=att,
                                dim_depth=D_DEP, device="cpu", **kw)
        assert tdec.dim_enc_eff == d_eff
        tdec.load_state_dict({k: torch.from_numpy(v)
                              for k, v in params.items()}, strict=True)
        out[(att, fusion)] = (jdec, params, tdec)
    return out


def _inputs(fusion, seed):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, K, D_ENC)).astype(np.float32)
    caps = rng.integers(0, V, (B, L)).astype(np.int32)
    dep = None
    if fusion != "none":
        width = D_DEP if fusion == "concat" else D_ENC
        dep = rng.normal(size=(B, K, width)).astype(np.float32)
    return feats, caps, dep


# hard_eval_sampling is a hard-attention flag
FORWARD_CASES = [(att, fusion, mode) for att, fusion in DECODER_CASES
                 for mode in ("train", "eval", "hard_eval_sampling")
                 if att == "hard" or mode != "hard_eval_sampling"]


@pytest.mark.parametrize("att,fusion,mode", FORWARD_CASES)
def test_teacher_forced_decoder_matches_jax(decoders, att, fusion, mode):
    jdec, params, tdec = decoders[(att, fusion)]
    feats, caps, dep = _inputs(fusion, 7)
    rng = jax.random.PRNGKey(11)
    train = mode != "eval"
    flag = mode == "hard_eval_sampling"
    want = jdec.apply({"params": params}, jnp.asarray(feats),
                      jnp.asarray(caps),
                      None if dep is None else jnp.asarray(dep),
                      train=train, temp=0.7, hard_eval_sampling=flag,
                      rng=rng)
    att_noise, keep = jax_noise(rng)
    got = tdec(torch.from_numpy(feats), torch.from_numpy(caps),
               None if dep is None else torch.from_numpy(dep),
               train=train, temp=0.7, hard_eval_sampling=flag,
               att_noise=att_noise, dropout_keep=keep(0.5))
    assert got[0].shape == (B, L - 1, V) and got[1].shape == (B, L - 1, K)
    assert got[0].dtype == got[1].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=TOL)
    if att == "hard" and not (train and not flag):
        # Gumbel-max: exactly one-hot
        assert set(np.unique(got[1].detach().numpy())) <= {0.0, 1.0}


def test_teacher_forced_decoder_draws_from_generator(decoders):
    """Without hooks the decoder draws its masks and noise from the
    generator: the same seed repeats, another seed differs, train without
    either raises."""
    _, _, tdec = decoders[("hard", "add")]
    feats, caps, dep = (torch.from_numpy(x) for x in _inputs("add", 3))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tdec(feats, caps, dep, train=True, generator=g)[0]
    assert torch.equal(run(0), run(0))
    assert not torch.allclose(run(0), run(1))
    with pytest.raises(ValueError, match="generator"):
        tdec(feats, caps, dep, train=True)
    # soft attention in eval mode needs no noise
    _, _, soft = decoders[("soft", "none")]
    soft(feats, caps, train=False)


@pytest.mark.parametrize("train", [True, False])
def test_nic_teacher_forcing_matches_jax(train):
    e, h = 10, 16
    jdec = JaxNIC(vocab_size=V, dim_embedding=e, dim_hidden=h, num_layers=2,
                  dropout=0.1)
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(B, e)).astype(np.float32)
    caps = rng.integers(0, V, (B, L)).astype(np.int32)
    params = _np(jdec.init(jax.random.PRNGKey(2), jnp.asarray(feats),
                           jnp.asarray(caps))["params"])
    tdec = NICDecoder(V, dim_embedding=e, dim_hidden=h, num_layers=2,
                      device="cpu", dropout=0.1)
    tdec.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()},
                         strict=True)
    key = jax.random.PRNGKey(9)
    want = jdec.apply({"params": params}, jnp.asarray(feats),
                      jnp.asarray(caps), train=train, rng=key)
    keep = np.asarray(jax.random.bernoulli(key, 0.9, (B, L, h)))
    got = tdec(torch.from_numpy(feats), torch.from_numpy(caps), train=train,
               dropout_keep=lambda t, shape: torch.from_numpy(keep))
    assert got.shape == (B, L, V)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_flax(dtype):
    """``BatchNorm2d`` alone against flax's ``nn.BatchNorm(momentum=0.9,
    epsilon=1e-5)`` with ``mutable=["batch_stats"]``: the output, the new
    running statistics and the gradients through the batch statistics,
    1e-5 (f32), on a batch whose last rows repeat its first, as a padded
    batch's do; bf16 input gives bf16 output within one bf16 ulp."""
    import flax.linen as nn
    c = 16
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=getattr(jnp, dtype), param_dtype=jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.normal(1.5, 2.0, (5, 7, 7, c)).astype(np.float32)
    x[3:] = x[:2]
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(0, 0.1, c).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.1, c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    weight = rng.normal(size=(5, 7, 7, c)).astype(np.float32)

    def loss(p):
        y, mut = bn.apply({"params": p, "batch_stats": stats}, xj,
                          mutable=["batch_stats"])
        return (y.astype(jnp.float32) * weight).sum(), (y, mut)
    (_, (want, mut)), grads = jax.value_and_grad(loss, has_aux=True)(params)

    tbn = BatchNorm2d(c)
    tbn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                         "bias": torch.from_numpy(params["bias"]),
                         "running_mean": torch.from_numpy(stats["mean"]),
                         "running_var": torch.from_numpy(stats["var"])})
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    y = tbn(xt, train=True)
    (y.float() * torch.from_numpy(weight).permute(0, 3, 1, 2)).sum() \
        .backward()
    assert y.dtype == getattr(torch, dtype)
    got = y.float().permute(0, 2, 3, 1).detach().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        ulp = 2.0 ** -7 * np.abs(want)
        assert (np.abs(got - want) <= ulp + 1e-6).all()
    for name, buf in (("mean", tbn.running_mean), ("var", tbn.running_var)):
        np.testing.assert_allclose(buf.numpy(), np.asarray(
            mut["batch_stats"][name]), rtol=0, atol=1e-5)
    if dtype == "float32":
        for name, g in (("scale", tbn.weight.grad), ("bias", tbn.bias.grad)):
            w = np.asarray(grads[name])
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())


def test_depth_cnn_encoder_train_mode_matches_flax():
    """The whole encoder in train mode, f32: the new running statistics
    1e-5; the output 1e-4, the bound of the f32 encoder test
    (``tests/test_torch_depth_slice.py``: convs of 49-4,608 terms summed in
    another order, which the batch normalization scales up); each
    gradient within 1e-3 of its own max |g|, but the conv biases', which
    are zero (every BN subtracts its batch mean) up to rounding, and are
    held below 1e-5 of the kernels'. Eval mode reads the new statistics
    and leaves them unchanged."""
    enc = JaxDepthCNNEncoder(dtype=jnp.float32)
    variables = _np(jax.jit(enc.init)(jax.random.PRNGKey(5),
                                      jnp.zeros((1, 224, 224, 1))))
    rng = np.random.default_rng(6)
    params = {k: dict(v, bias=rng.normal(0, 0.1, v["bias"].shape)
                      .astype(np.float32))
              for k, v in variables["params"].items()}
    stats = {k: {"mean": rng.normal(0, 0.1, v["mean"].shape)
                 .astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, v["var"].shape)
                 .astype(np.float32)}
             for k, v in variables["batch_stats"].items()}
    # the last row repeats the first, as a padded batch's do
    depth = rng.random((3, 224, 224, 1)).astype(np.float32)
    depth[2:] = depth[:1]

    def loss(p, x):
        out, mut = enc.apply({"params": p, "batch_stats": stats}, x,
                             train=True, mutable=["batch_stats"])
        return (out ** 2).mean(), (out, mut["batch_stats"])
    (_, (want, want_stats)), want_grads = jax.value_and_grad(
        loss, has_aux=True)(params, jnp.asarray(depth))

    tenc = DepthCNNEncoder(14, dtype=torch.float32)
    tenc.load_state_dict({k: torch.from_numpy(v) for k, v in
                          flax_state_dict(params, stats).items()},
                         strict=True)
    out = tenc(torch.from_numpy(depth), train=True)
    (out ** 2).mean().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
    _, got_stats = flax_trees(tenc)
    for name in stats:
        for s in ("mean", "var"):
            np.testing.assert_allclose(got_stats[name][s],
                                       np.asarray(want_stats[name][s]),
                                       rtol=0, atol=1e-5)
    grads = {k: v.grad.numpy() for k, v in tenc.named_parameters()}
    want_sd = flax_state_dict(_np(want_grads))
    assert set(grads) == set(want_sd)
    kernel_max = max(np.abs(want_sd[f"conv{i}.weight"]).max()
                     for i in (1, 2, 3))
    for name, g in grads.items():
        w = want_sd[name]
        if name.startswith("conv") and name.endswith("bias"):
            assert np.abs(g).max() <= 1e-5 * kernel_max, name
            assert np.abs(w).max() <= 1e-5 * kernel_max, name
        else:
            assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max(), name
    before = {k: v.clone() for k, v in tenc.state_dict().items()}
    want_eval = enc.apply({"params": params, "batch_stats": _np(want_stats)},
                          jnp.asarray(depth), train=False)
    with torch.no_grad():
        got_eval = tenc(torch.from_numpy(depth))
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval),
                               rtol=0, atol=1e-4)
    for k, v in tenc.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("use_pad,use_denoms", [(False, False),
                                                (True, False),
                                                (True, True)])
def test_losses_match_jax(use_pad, use_denoms):
    rng = np.random.default_rng(8)
    logits = rng.normal(0, 2, (B, L - 1, V)).astype(np.float32)
    caps = rng.integers(0, V, (B, L)).astype(np.int32)
    lengths = rng.integers(2, L + 1, (B,)).astype(np.int32)
    alphas = rng.dirichlet(np.ones(K), (B, L - 1)).astype(np.float32)
    pad = np.array([True, True, True, False, False]) if use_pad else None
    denoms = (np.int32(17), np.float32(3.0)) if use_denoms else None
    t = {"pad_mask": None if pad is None else torch.from_numpy(pad),
         "denoms": None if denoms is None else tuple(
             torch.tensor(d) for d in denoms)}
    j = {"pad_mask": None if pad is None else jnp.asarray(pad),
         "denoms": None if denoms is None else tuple(
             jnp.asarray(d) for d in denoms)}
    want_loss, want = jlosses.caption_loss(
        jnp.asarray(logits), jnp.asarray(caps), jnp.asarray(lengths),
        jnp.asarray(alphas), alpha_reg=0.7, **j)
    got_loss, got = tlosses.caption_loss(
        torch.from_numpy(logits), torch.from_numpy(caps),
        torch.from_numpy(lengths), torch.from_numpy(alphas), alpha_reg=0.7,
        **t)
    assert set(got) == set(want) == {"ce", "alpha_penalty", "loss"}
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=0,
                                   atol=1e-6)
    mask = tlosses.token_mask(torch.from_numpy(lengths), L - 1,
                              t["pad_mask"])
    np.testing.assert_array_equal(mask.numpy(), np.asarray(
        jlosses.token_mask(jnp.asarray(lengths), L - 1, j["pad_mask"])))
    nic_logits = rng.normal(0, 2, (B, L, V)).astype(np.float32)
    denom = None if denoms is None else denoms[0]
    want_nic, _ = jlosses.nic_loss(jnp.asarray(nic_logits),
                                   jnp.asarray(caps), jnp.asarray(lengths),
                                   j["pad_mask"], denom=denom)
    got_nic, got_m = tlosses.nic_loss(
        torch.from_numpy(nic_logits), torch.from_numpy(caps),
        torch.from_numpy(lengths), t["pad_mask"],
        denom=None if denom is None else torch.tensor(denom))
    assert set(got_m) == {"ce", "loss"}
    np.testing.assert_allclose(got_nic.item(), float(want_nic), rtol=0,
                               atol=1e-6)
