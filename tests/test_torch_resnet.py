"""The port's ResNet grid encoder == the JAX AttentionGridEncoder on
bridged weights (1,1,1,1 blocks at 64x64; BN parameters and statistics
randomized so the BN mapping is exercised).

Tolerances: f32 rtol/atol 1e-4 (the two conv libraries sum in different
orders). bf16: max abs error <= 5e-2 * max|feat|, because bf16 rounds at
different places in the two frameworks' convs."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from depth_image_captioning_pub_tpu.models.resnet import (
    AttentionGridEncoder as JaxEncoder)
from depth_image_captioning_pub_torch.models.resnet import (
    AttentionGridEncoder, Bottleneck)
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    encoder_state_dict)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

LAYERS = (1, 1, 1, 1)


def _randomize_bn(tree, rng):
    """Replace flax's BN init (scale 1, bias 0, mean 0, var 1)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _randomize_bn(val, rng)
            continue
        val = np.asarray(val)
        n = val.shape
        if key == "scale":
            val = rng.uniform(0.5, 1.5, n)
        elif key == "bias" or key == "mean":
            val = rng.normal(0.0, 0.1, n)
        elif key == "var":
            val = rng.uniform(0.5, 1.5, n)
        out[key] = np.asarray(val, np.float32)
    return out


@pytest.fixture(scope="module")
def bridged():
    enc = JaxEncoder(layers=LAYERS, dtype=jnp.float32)
    variables = jax.jit(enc.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 64, 64, 3), jnp.float32))
    variables = _randomize_bn(jax.tree_util.tree_map(np.asarray,
                                                     dict(variables)),
                              np.random.default_rng(1))
    images = np.random.default_rng(2).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    return variables, images


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(bridged, dtype):
    variables, images = bridged
    want = np.asarray(JaxEncoder(layers=LAYERS, dtype=getattr(jnp, dtype))
                      .apply(variables, jnp.asarray(images)), np.float32)
    enc = AttentionGridEncoder(14, dtype=getattr(torch, dtype),
                               layers=LAYERS)
    enc.load_state_dict({k: torch.tensor(v) for k, v in
                         encoder_state_dict(variables).items()}, strict=True)
    with torch.inference_mode():
        got = enc(torch.from_numpy(images))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape == (2, 196, 2048)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = np.abs(got - want).max()
        assert err <= 5e-2 * np.abs(want).max(), (err, np.abs(want).max())


def test_bridge_covers_every_tensor(bridged):
    """strict load: every port tensor has a flax source, and vice versa."""
    variables, _ = bridged
    sd = encoder_state_dict(variables)
    enc = AttentionGridEncoder(14, dtype=torch.float32, layers=LAYERS)
    assert set(sd) == set(enc.state_dict())
    w = sd["backbone.layer2_0.conv2.weight"]
    k = np.asarray(variables["params"]["backbone"]["layer2_0"]["conv2"]
                   ["kernel"])
    assert w.shape == (128, 128, 3, 3) and k.shape == (3, 3, 128, 128)
    np.testing.assert_array_equal(w[5, 7], k[:, :, 7, 5])


def test_bottleneck_keeps_channels_last():
    blk = Bottleneck(64, 16, stride=2, downsample=True, dtype=torch.float32)
    x = torch.randn(2, 64, 8, 8).contiguous(memory_format=torch.channels_last)
    y = blk(x)
    assert tuple(y.shape) == (2, 64, 4, 4)
    assert y.is_contiguous(memory_format=torch.channels_last)
