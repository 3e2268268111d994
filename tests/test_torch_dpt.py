"""The port's DPT-hybrid == the JAX ``models/dpt.py``, module by module, on
the same numpy-seeded inputs and bridged weights (f32, CPU).

Flax's initial GroupNorm/LayerNorm scales (1), biases (0) and class token
(0) are replaced by random values so the weight mapping is exercised.
Tolerances: atol 1e-5 for each module and for the image ops (the two
frameworks sum in different orders), atol 1e-4 for the whole tiny DPT and
its depth function (the differences of 20-odd layers add up); each atol is
scaled by max|output| where that exceeds 1 (``_close``). Stride-2
SAME windows are run at even and odd sizes: XLA puts the odd pad pixel at
the end, which the port has to reproduce.

K5's plain version (``ops/kernels/vit_attention.fused_attention_plain``,
what the wrapper runs for CPU tensors) is held to the Pallas kernel in
interpret mode, atol 1e-5. K6's plain version
(``ops/kernels/group_norm.group_norm_nhwc_plain``, what every
``GroupNormAct`` runs on the CPU) is held to ``nn.GroupNorm`` on the NCHW
tensor, atol 1e-5 (f32 sums in another order), and its residual epilogue
to the bottleneck's former ``relu(norm3(y) + shortcut)``, exactly; the
backbone hands every convolution and GroupNorm a contiguous NHWC tensor."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from depth_image_captioning_pub_tpu.models import dpt as jdpt
from depth_image_captioning_pub_tpu.ops import image_ops as jimg
from depth_image_captioning_pub_tpu.ops.pallas.vit_attention import (
    fused_attention as jax_fused_attention)
from depth_image_captioning_pub_torch.models import dpt as tdpt
from depth_image_captioning_pub_torch.ops import image_ops as timg
from depth_image_captioning_pub_torch.ops.kernels import (
    group_norm, vit_attention)
from depth_image_captioning_pub_torch.ops.pooling import nchw, nhwc
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    dpt_params_from_jax, flax_state_dict)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-5
TINY = dict(vit_blocks=3, hooks=(1, 2), resnet_layers=(1, 1, 1), vit_dim=64,
            vit_heads=4, features=32)


def _close(got, want, atol=ATOL):
    """|got - want| <= atol * max(1, max|want|): f32 rounding is relative,
    so the bound grows with outputs above 1 (the ResNet taps reach ~8)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=atol * max(1.0, np.abs(want).max()),
                               rtol=0)


def _arr(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _perturb(tree, rng):
    """Random norm scales, biases and class token in place of flax's
    constant initializers."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict) or hasattr(val, "items"):
            out[key] = _perturb(val, rng)
            continue
        val = np.asarray(val, np.float32)
        if key == "scale":
            val = rng.uniform(0.5, 1.5, val.shape)
        elif key in ("bias", "cls_token"):
            val = rng.normal(0.0, 0.1, val.shape)
        out[key] = np.asarray(val, np.float32)
    return out


def _pair(jmod, tmod, *inputs, seed=0):
    """Init the flax module on ``inputs``, perturb, load into the torch
    module; returns (jax output, torch output)."""
    variables = jmod.init(jax.random.PRNGKey(seed),
                          *[jnp.asarray(x) for x in inputs])
    params = _perturb(jax.tree_util.tree_map(np.asarray,
                                             dict(variables))["params"],
                      np.random.default_rng(seed))
    tmod.load_state_dict({k: torch.from_numpy(v) for k, v in
                          flax_state_dict(params).items()}, strict=True)
    want = jmod.apply({"params": params}, *[jnp.asarray(x) for x in inputs])
    with torch.inference_mode():
        got = tmod(*[torch.from_numpy(x) for x in inputs])
    return want, got


# ---- K5: fused ViT attention --------------------------------------------

@pytest.mark.parametrize("n,n_valid", [(17, 17), (24, 17), (1, 1)])
def test_fused_attention_plain_matches_pallas(n, n_valid):
    q, k, v = (_arr(s, 6, n, 16) for s in (1, 2, 3))
    want = jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               scale=0.25, n_valid=n_valid, interpret=True)
    before = vit_attention.LAUNCHES
    got = vit_attention.fused_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=0.25, n_valid=n_valid)
    assert vit_attention.LAUNCHES == before    # CPU: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    _close(got, want)


def test_fused_attention_plain_bf16_rounds_p():
    """bf16 q/k/v: scores and softmax in f32, p rounded to bf16 before PV,
    f32 accumulation, bf16 output; the Pallas kernel rounds alike."""
    q, k, v = (_arr(s, 4, 24, 16) for s in (4, 5, 6))
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    want = jax_fused_attention(*jb, scale=0.25, n_valid=20, interpret=True)
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = vit_attention.fused_attention_plain(*tb, scale=0.25, n_valid=20)
    assert got.dtype == torch.bfloat16
    # one bf16 ulp of |out| <= max|v|: the f32 sums differ in order
    _close(got, np.asarray(want.astype(jnp.float32)),
           atol=2 ** -7 * np.abs(v).max())


def test_fused_attention_rejects_bad_input():
    q = torch.zeros(2, 5, 8)
    with pytest.raises(ValueError, match="n_valid"):
        vit_attention.fused_attention(q, q, q, scale=1.0, n_valid=6)
    with pytest.raises(ValueError, match="shape"):
        vit_attention.fused_attention(q, q[:, :4], q, scale=1.0, n_valid=4)
    with pytest.raises(TypeError):
        vit_attention.fused_attention(q, q.double(), q, scale=1.0, n_valid=5)


def test_fused_attention_smem_envelope():
    """The wrapper's shared-memory sum by dtype. f32 keeps a tile's score
    rows, so 577 tokens at d=64 fit one block and n_valid stops near 1,490;
    bf16 keeps no score rows, so it fits at every n_valid for d <= 128."""
    f32, bf16 = torch.float32, torch.bfloat16
    limit = vit_attention.SMEM_LIMIT
    assert vit_attention.smem_bytes(64, 577, f32) < limit
    assert vit_attention.smem_bytes(64, 1480, f32) <= limit
    assert vit_attention.smem_bytes(64, 1500, f32) > limit
    for d in vit_attention.HEAD_DIMS:
        sizes = {vit_attention.smem_bytes(d, n, bf16)
                 for n in (1, 577, 1500, 4096, 1 << 20)}
        assert len(sizes) == 1 and sizes.pop() <= limit


def test_fused_attention_bf16_cpu_takes_plain_version():
    """A bf16 CPU call beyond the f32 route's envelope still runs the plain
    version (no launch) and matches the Pallas kernel at one bf16 ulp."""
    q, k, v = (_arr(s, 2, 600, 32) for s in (7, 8, 9))
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    want = jax_fused_attention(*jb, scale=32 ** -0.5, n_valid=590,
                               interpret=True)
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    before = vit_attention.LAUNCHES
    got = vit_attention.fused_attention(*tb, scale=32 ** -0.5, n_valid=590)
    assert vit_attention.LAUNCHES == before
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == q.shape
    vmax = np.abs(np.asarray(jb[2].astype(jnp.float32))).max()
    _close(got, np.asarray(want.astype(jnp.float32)), atol=2 ** -7 * vmax)


# ---- image ops --------------------------------------------------------

@pytest.mark.parametrize("hw", [(9, 7), (96, 96), (224, 224), (4, 4)])
def test_resize_bilinear(hw):
    x = np.random.default_rng(7).random((2, 24, 24, 3)).astype(np.float32)
    got = timg.resize_bilinear(torch.from_numpy(x), hw)
    assert tuple(got.shape) == (2, *hw, 3)
    _close(got, jimg.resize_bilinear(jnp.asarray(x), hw))


def test_dpt_normalize():
    x = np.random.default_rng(8).random((2, 5, 6, 3)).astype(np.float32)
    _close(timg.dpt_normalize(torch.from_numpy(x)),
           jimg.dpt_normalize(jnp.asarray(x)))


def test_standardize_depth_map_nan_first():
    d = _arr(9, 3, 6, 5, 1, scale=4.0)
    d[0, 1, 2, 0] = np.nan
    got = timg.standardize_depth_map(torch.from_numpy(d))
    _close(got, jimg.standardize_depth_map(jnp.asarray(d)))
    flat = got.reshape(3, -1)
    assert torch.allclose(flat.amin(1), torch.zeros(3))
    assert torch.allclose(flat.amax(1), torch.ones(3))


@pytest.mark.parametrize("in_hw,out_hw", [((5, 6), (10, 12)), ((4, 4), (9, 3)),
                                          ((1, 3), (2, 6))])
def test_resize_align_corners(in_hw, out_hw):
    x = _arr(10, 2, *in_hw, 3)
    got = tdpt.resize_align_corners(torch.from_numpy(x), out_hw)
    _close(got, jdpt.resize_align_corners(jnp.asarray(x), out_hw))


@pytest.mark.parametrize("grid", [(4, 4), (6, 6), (24, 24), (30, 30)])
def test_resize_pos_embed(grid):
    pos = _arr(11, 1, 1 + 24 * 24, 8)
    got = tdpt.resize_pos_embed(torch.from_numpy(pos), 24, grid)
    assert tuple(got.shape) == (1, 1 + grid[0] * grid[1], 8)
    _close(got, jdpt._resize_pos_embed(jnp.asarray(pos), 24, grid))


@pytest.mark.parametrize("size,kernel,stride,want",
                         [(64, 7, 2, (2, 3)), (63, 7, 2, (3, 3)),
                          (8, 3, 2, (0, 1)), (9, 3, 2, (1, 1)),
                          (16, 1, 2, (0, 0)), (10, 3, 1, (1, 1))])
def test_same_pads_put_the_odd_pixel_last(size, kernel, stride, want):
    assert tdpt.same_pads(size, kernel, stride) == want


# ---- ResNetV2 pieces ------------------------------------------------------

@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("kernel,stride", [(1, 1), (3, 1), (3, 2), (7, 2),
                                           (1, 2)])
def test_std_conv(size, kernel, stride):
    # unit-variance kernels grow |y| by sqrt(fan_in): inputs of 0.1 keep
    # |y| near 1, where atol 1e-5 is a few f32 ulps
    x = _arr(12, 2, size, size, 6, scale=0.1)
    want, got = _pair(jdpt.StdConv(16, (kernel, kernel), (stride, stride)),
                      tdpt.StdConv(6, 16, kernel, stride), x)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("act", [True, False])
def test_group_norm_act(act):
    x = _arr(13, 2, 5, 7, 64, scale=3.0)
    want, got = _pair(jdpt.GroupNormAct(act=act),
                      tdpt.GroupNormAct(64, act=act), x)
    _close(got, want)


@pytest.mark.parametrize("shape", [(2, 5, 7, 64), (1, 6, 6, 256),
                                   (3, 4, 3, 1024), (2, 3, 3, 96)])
@pytest.mark.parametrize("relu", [False, True])
def test_group_norm_plain_matches_nn_group_norm(shape, relu):
    """K6's plain version on NHWC == nn.GroupNorm(32) on the NCHW tensor
    (then the ReLU), f32."""
    x = torch.from_numpy(_arr(17, *shape, scale=3.0) + 0.5)
    c = shape[-1]
    gn = torch.nn.GroupNorm(32, c, eps=1e-5)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(_arr(18, c) * 0.2 + 1.0))
        gn.bias.copy_(torch.from_numpy(_arr(19, c) * 0.1))
        want = nhwc(gn(nchw(x).contiguous()))
        got = group_norm.group_norm_nhwc(x, gn.weight, gn.bias, relu=relu)
    _close(got, torch.relu(want) if relu else want)
    assert got.is_contiguous() and got.dtype == x.dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_residual_epilogue_is_the_old_arithmetic(dtype):
    """norm3 with the shortcut == relu(norm3(y) + shortcut) as the
    bottleneck computed it before the add moved into the norm: bit for
    bit, the add in f32 and rounded to the dtype."""
    norm3 = tdpt.GroupNormAct(64, act=False, dtype=dtype)
    with torch.no_grad():
        norm3.gn.weight.copy_(torch.from_numpy(_arr(20, 64) * 0.2 + 1.0))
        norm3.gn.bias.copy_(torch.from_numpy(_arr(21, 64) * 0.1))
    y = torch.from_numpy(_arr(22, 2, 6, 5, 64, scale=2.0)).to(dtype)
    shortcut = torch.from_numpy(_arr(23, 2, 6, 5, 64)).to(dtype)
    with torch.inference_mode():
        got = norm3(y, residual=shortcut)
        want = F.relu(norm3(y) + shortcut)
    assert got.dtype == dtype and torch.equal(got, want)


def test_group_norm_rejects_bad_input():
    x, w = torch.zeros(2, 3, 3, 64), torch.ones(64)
    gn = group_norm.group_norm_nhwc
    with pytest.raises(ValueError, match="B>=1"):
        gn(x[0], w, w)
    with pytest.raises(ValueError, match="groups"):
        gn(x, w, w, groups=48)
    with pytest.raises(ValueError, match="weight and bias must be"):
        gn(x, w[:32], w)
    with pytest.raises(ValueError, match="residual has shape"):
        gn(x, w, w, residual=x[:1])
    with pytest.raises(TypeError, match="bias"):
        gn(x, w, w.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gn(x.half(), w.half(), w.half())


def test_group_norm_cpu_takes_plain_version():
    """On CPU tensors the operator runs the plain version and launches
    nothing, with or without the epilogue."""
    x = torch.from_numpy(_arr(24, 1, 4, 4, 128))
    w, b = torch.ones(128), torch.zeros(128)
    before = group_norm.LAUNCHES
    for kw in ({}, {"relu": True}, {"residual": x, "relu": True}):
        got = group_norm.group_norm_nhwc(x, w, b, **kw)
        want = group_norm.group_norm_nhwc_plain(x, w, b, **kw)
        assert torch.equal(got, want)
    assert group_norm.LAUNCHES == before


@pytest.mark.parametrize("side", [384, 224])
@pytest.mark.parametrize("div,c", [(2, 64), (4, 64), (4, 128), (4, 256),
                                   (8, 128), (8, 256), (8, 512), (16, 256),
                                   (16, 1024)])
@pytest.mark.parametrize("vec", [8, 4])
def test_group_norm_plan_covers_every_row(side, div, c, vec):
    """K6's tiling at the backbone's shapes: whole row steps a tile
    (TILE_STEPS, more only where MAX_TILES needs it), every tile holds rows
    and together they hold each row once, at most MAX_TILES an image, and
    at 384x384 and B=64 (the main path's chunk) more blocks than the
    H100's 132 SMs."""
    hw = (side // div) ** 2
    tiles, rows = group_norm.plan(hw, c, vec)
    step = group_norm.THREADS // (c // vec)
    steps = -(-hw // step)
    per = max(group_norm.TILE_STEPS, -(-steps // group_norm.MAX_TILES))
    assert rows == per * step
    assert 1 <= tiles <= group_norm.MAX_TILES
    assert (tiles - 1) * rows < hw <= tiles * rows
    if side == 384:
        assert tiles * 64 > 132


@pytest.mark.parametrize("size", [64, 50])
def test_backbone_stays_nhwc(size):
    """Every StdConv and GroupNormAct of the backbone gets a contiguous
    NHWC tensor with its own channel count last (and a residual of the
    same kind): no layout round trip between them."""
    model = tdpt.HybridResNetStages((1, 1, 1))
    seen = []

    def check(mod, args, kwargs):
        c = (mod.weight.shape[1] if isinstance(mod, tdpt.StdConv)
             else mod.gn.num_channels)
        for t in (*args, *kwargs.values()):
            if t is None:
                continue
            assert t.dim() == 4 and t.shape[-1] == c, (type(mod), t.shape)
            assert t.is_contiguous(), (type(mod).__name__, t.stride())
        seen.append(type(mod).__name__)

    for mod in model.modules():
        if isinstance(mod, (tdpt.StdConv, tdpt.GroupNormAct)):
            mod.register_forward_pre_hook(check, with_kwargs=True)
    with torch.inference_mode():
        taps = model(torch.from_numpy(_arr(25, 2, size, size, 3)))
    assert seen.count("StdConv") == 13 and seen.count("GroupNormAct") == 13
    assert all(t.is_contiguous() for t in taps)


def test_dpt_routes_every_group_norm(monkeypatch):
    """Each GroupNormAct call is one call of ``group_norm_nhwc``: 13 a
    forward of the tests' DPT (stem, 3 bottlenecks x 3, 3 downsample
    norms), the three norm3s with their shortcut as the residual."""
    calls = []
    real = group_norm.group_norm_nhwc

    def spy(x, *args, **kw):
        calls.append(kw.get("residual") is not None)
        return real(x, *args, **kw)
    monkeypatch.setattr(group_norm, "group_norm_nhwc", spy)
    model = tdpt.DPTDepthModel(**TINY)
    with torch.inference_mode():
        model(torch.zeros(1, 64, 64, 3))
    assert len(calls) == 13 and sum(calls) == 3


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("stride,downsample", [(1, True), (2, True),
                                               (1, False)])
def test_bottleneck(size, stride, downsample):
    in_c = 64 if downsample else 128
    x = _arr(14, 2, size, size, in_c)
    want, got = _pair(
        jdpt.ResNetV2Bottleneck(mid=32, stride=stride, downsample=downsample),
        tdpt.ResNetV2Bottleneck(in_c, 32, stride, downsample), x)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("size", [64, 50])
def test_hybrid_resnet_stages(size):
    x = _arr(15, 2, size, size, 3)
    want, got = _pair(jdpt.HybridResNetStages(layers=(1, 1, 1)),
                      tdpt.HybridResNetStages((1, 1, 1)), x)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


# ---- ViT and reassembly ---------------------------------------------------

@pytest.mark.parametrize("n", [17, 5])
def test_vit_block(n):
    x = _arr(16, 2, n, 64)
    want, got = _pair(jdpt.ViTBlock(dim=64, heads=4),
                      tdpt.ViTBlock(64, 4), x)
    _close(got, want)


def test_project_readout():
    x = _arr(17, 2, 17, 64)
    want, got = _pair(jdpt.ProjectReadout(64), tdpt.ProjectReadout(64), x)
    assert tuple(got.shape) == (2, 16, 64)
    _close(got, want)


def test_residual_conv_unit():
    x = _arr(18, 2, 5, 6, 32)
    want, got = _pair(jdpt.ResidualConvUnit(32),
                      tdpt.ResidualConvUnit(32), x)
    _close(got, want)


@pytest.mark.parametrize("skip", [True, False])
def test_feature_fusion_block(skip):
    x = _arr(19, 2, 3, 4, 32)
    inputs = (x, _arr(20, 2, 3, 4, 32)) if skip else (x,)
    want, got = _pair(jdpt.FeatureFusionBlock(32),
                      tdpt.FeatureFusionBlock(32, skip=skip), *inputs)
    assert tuple(got.shape) == (2, 6, 8, 32)
    _close(got, want)


# ---- the whole tiny DPT ---------------------------------------------------

@pytest.fixture(scope="module")
def tiny_dpt():
    model = jdpt.DPTDepthModel(**TINY)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 64, 3)))
    params = _perturb(jax.tree_util.tree_map(np.asarray,
                                             dict(variables))["params"],
                      np.random.default_rng(1))
    return model, {"params": params}


def _port_estimator(variables, **kw):
    est = tdpt.DPTDepthEstimator(dtype=torch.float32, image_size=64,
                                 device="cpu", **TINY, **kw)
    dpt_params_from_jax(est, variables)
    return est


@pytest.mark.parametrize("hw", [64, 96])
def test_dpt_model(tiny_dpt, hw):
    """64x64 keeps the 4x4 grid; 96x96 (6x6) also shrinks the 24x24
    position embeddings by another factor."""
    model, variables = tiny_dpt
    x = _arr(21, 2, hw, hw, 3)
    want = model.apply(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = _port_estimator(variables).model(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, hw, hw)
    assert float(np.asarray(want).std()) > 1e-3     # not a constant map
    _close(got, want, atol=1e-4)


def test_depth_fn(tiny_dpt):
    model, variables = tiny_dpt
    est = jdpt.DPTDepthEstimator(dtype=jnp.float32, image_size=64)
    est.model = model
    images = np.random.default_rng(22).integers(0, 256, (3, 48, 48, 3),
                                                dtype=np.uint8)
    want = est.depth_fn()(variables, jnp.asarray(images))
    got = _port_estimator(variables).depth_fn()(torch.from_numpy(images))
    assert tuple(got.shape) == want.shape == (3, 224, 224, 1)
    assert got.dtype == torch.float32
    _close(got, want, atol=1e-4)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_dpt_bridge_is_strict(tiny_dpt):
    """Every port tensor has a flax source and vice versa; a tree with an
    extra or a missing tensor raises."""
    _, variables = tiny_dpt
    sd = flax_state_dict(variables["params"])
    est = _port_estimator(variables)
    assert set(sd) == set(est.model.state_dict())
    qkv = variables["params"]["block0"]["qkv"]["kernel"]
    np.testing.assert_array_equal(sd["block0.qkv.weight"], qkv.T)
    extra = {"params": dict(variables["params"], stray={"bias": np.ones(2)})}
    with pytest.raises(RuntimeError, match="stray"):
        dpt_params_from_jax(est, extra)
    missing = {"params": {k: v for k, v in variables["params"].items()
                          if k != "head_conv3"}}
    with pytest.raises(RuntimeError, match="head_conv3"):
        dpt_params_from_jax(est, missing)


@pytest.mark.parametrize("b", [1, 3])
def test_vit_block_hands_the_kernel_contiguous_qkv(monkeypatch, b):
    """The CUDA kernel takes contiguous q/k/v only; at B=1 a bare reshape
    of the permuted qkv would be a strided view."""
    seen = []
    plain = vit_attention.fused_attention

    def spy(q, k, v, **kw):
        seen.append([t.is_contiguous() for t in (q, k, v)])
        return plain(q, k, v, **kw)

    monkeypatch.setattr(vit_attention, "fused_attention", spy)
    with torch.inference_mode():
        tdpt.ViTBlock(64, 4)(torch.randn(b, 17, 64))
    assert seen == [[True] * 3]
