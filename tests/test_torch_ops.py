"""The port's ops == the JAX package's ops on the same numpy-seeded inputs
(f32, CPU; atol 1e-5 — the two frameworks sum in different orders)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from depth_image_captioning_pub_tpu.ops import attention as jatt
from depth_image_captioning_pub_tpu.ops import image_ops as jimg
from depth_image_captioning_pub_tpu.ops import lstm as jlstm
from depth_image_captioning_pub_tpu.ops import pooling as jpool
from depth_image_captioning_pub_torch.ops import attention as tatt
from depth_image_captioning_pub_torch.ops import image_ops as timg
from depth_image_captioning_pub_torch.ops import lstm as tlstm
from depth_image_captioning_pub_torch.ops import pooling as tpool

ATOL = 1e-5
B, K, D, A, H, E = 3, 49, 40, 16, 12, 10


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_to_unit_float_exact():
    img = np.random.default_rng(0).integers(0, 256, (2, 5, 6, 3), np.uint8)
    got = timg.to_unit_float(torch.from_numpy(img))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jimg.to_unit_float(img)))
    f = torch.rand(2, 3)
    assert timg.to_unit_float(f) is f


def test_imagenet_normalize():
    x = np.random.default_rng(1).random((2, 5, 6, 3)).astype(np.float32)
    _close(timg.imagenet_normalize(torch.from_numpy(x)),
           jimg.imagenet_normalize(jnp.asarray(x)))


@pytest.mark.parametrize("in_size,out_size", [(7, 14), (2, 14), (5, 3)])
def test_adaptive_avg_pool2d(in_size, out_size):
    x = _arr(np.random.default_rng(2), 2, in_size, in_size, 8)
    got = tpool.adaptive_avg_pool2d(torch.from_numpy(x), out_size)
    assert tuple(got.shape) == (2, out_size, out_size, 8)
    _close(got, jpool.adaptive_avg_pool2d(jnp.asarray(x), out_size))


def test_adaptive_avg_pool2d_bf16_duplication_exact():
    x = torch.from_numpy(_arr(np.random.default_rng(3), 2, 7, 7, 8)).to(
        torch.bfloat16)
    got = tpool.adaptive_avg_pool2d(x, 14)
    assert got.dtype == torch.bfloat16
    want = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    assert torch.equal(got, want)


def test_max_pool2d():
    x = _arr(np.random.default_rng(4), 2, 9, 9, 5)
    got = tpool.max_pool2d(torch.from_numpy(x), 3, 2, 1)
    _close(got, jpool.max_pool2d(jnp.asarray(x), 3, 2, 1))


def test_global_avg_pool():
    x = _arr(np.random.default_rng(5), 2, 4, 4, 6)
    _close(tpool.global_avg_pool(torch.from_numpy(x)),
           jpool.global_avg_pool(jnp.asarray(x)))


@pytest.fixture(scope="module")
def att():
    rng = np.random.default_rng(6)
    np_params = (_arr(rng, D, A, scale=0.3), _arr(rng, A, scale=0.3),
                 _arr(rng, H, A, scale=0.3), _arr(rng, A, scale=0.3),
                 _arr(rng, A, scale=0.3), np.float32(0.1))
    feats = _arr(rng, B, K, D)
    hidden = _arr(rng, B, H)
    jp = jatt.AttentionParams(*[jnp.asarray(p) for p in np_params])
    tp = tatt.AttentionParams(*[torch.tensor(p) for p in np_params])
    return jp, tp, feats, hidden


def test_project_features(att):
    jp, tp, feats, _ = att
    _close(tatt.project_features(tp, torch.from_numpy(feats)),
           jatt.project_features(jp, jnp.asarray(feats)))


def test_attention_logits(att):
    jp, tp, feats, hidden = att
    proj = jatt.project_features(jp, jnp.asarray(feats))
    got = tatt.attention_logits(tp, torch.tensor(np.asarray(proj)),
                                torch.from_numpy(hidden))
    _close(got, jatt.attention_logits(jp, proj, jnp.asarray(hidden)))


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_soft_attention(att, storage):
    """bf16-STORED features with f32 compute: both sides upcast exactly."""
    jp, tp, feats, hidden = att
    jf = jnp.asarray(feats).astype(storage)
    tf = torch.from_numpy(feats).to(getattr(torch, storage))
    np.testing.assert_array_equal(np.asarray(jf.astype(jnp.float32)),
                                  tf.float().numpy())
    jproj = jatt.project_features(jp, jf, compute_dtype=jnp.float32)
    tproj = tatt.project_features(tp, tf, compute_dtype=torch.float32)
    assert tproj.dtype == torch.float32
    _close(tproj, jproj)
    jctx, jalpha = jatt.soft_attention(jp, jf, jproj, jnp.asarray(hidden),
                                       compute_dtype=jnp.float32)
    tctx, talpha = tatt.soft_attention(tp, tf, tproj,
                                       torch.from_numpy(hidden),
                                       compute_dtype=torch.float32)
    assert tctx.dtype == talpha.dtype == torch.float32
    _close(tctx, jctx)
    _close(talpha, jalpha)


def test_lstm_cell():
    rng = np.random.default_rng(7)
    x_dim = 9
    ps = (_arr(rng, x_dim, 4 * H, scale=0.3), _arr(rng, H, 4 * H, scale=0.3),
          _arr(rng, 4 * H, scale=0.3), _arr(rng, 4 * H, scale=0.3))
    x, h, c = _arr(rng, B, x_dim), _arr(rng, B, H), _arr(rng, B, H)
    jh, jc = jlstm.lstm_cell(jlstm.LSTMCellParams(*map(jnp.asarray, ps)),
                             jnp.asarray(x), jnp.asarray(h), jnp.asarray(c))
    th, tc = tlstm.lstm_cell(
        tlstm.LSTMCellParams(*map(torch.from_numpy, ps)),
        torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(c))
    _close(th, jh)
    _close(tc, jc)


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
