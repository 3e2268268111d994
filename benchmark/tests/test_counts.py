"""The benchmark's operation and byte counts against hand-worked small
shapes and against ``torch.utils.flop_counter`` on the reference modules
(which counts convolutions and matrix products, as the counts do); the
counts, draws and reference maps that the depth models' files give,
against those pinned before the files were found by name."""

import hashlib
import json
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from counts import kernels, models
from dcbench import judge, program, spec, weights as W
from reference import decoder as ref_decoder
from reference.depth_cnn import depth_features
from reference.resnet import grid_features
from tiny import BENCH, tiny_config

CONFIGS = {p.stem: json.loads(p.read_text())
           for p in sorted((BENCH / "configs").glob("*.json"))}
# every depth model: a file under reference/ that gives ``depth_maps``
DPT_MODELS = sorted(
    p.stem for p in (BENCH / "reference").glob("*.py")
    if hasattr(spec.load(p), "depth_maps"))


def flops(fn, *args, **kwargs):
    with FlopCounterMode(display=False) as m:
        fn(*args, **kwargs)
    return m.get_total_flops()


def tiny_weights(cfg):
    """Weights of ``cfg`` drawn on the CPU, as a run draws them."""
    return program.build(cfg, 3, "cpu", spec.depth_model(cfg)).served


def dpt_ops(cfg):
    """The count of ``cfg``'s depth model (None without one)."""
    model = spec.depth_model(cfg)
    return model.counts.ops if model else None


def test_conv_and_linear_by_hand():
    assert models.conv(3, 64, 7, 112) == 2 * 3 * 64 * 49 * 112 * 112
    assert models.linear(5, 7, 11) == 2 * 5 * 7 * 11


def test_resnet152_published_size():
    # torchvision lists ResNet-152 at 11.51 GMACs at 224x224
    macs = models.resnet((3, 8, 36, 3), 224) / 2 / 1e9
    assert abs(macs - 11.51) < 0.02


@pytest.mark.parametrize("size", [64, 96])
def test_resnet_against_flop_counter(size):
    cfg = tiny_config("base-soft")
    w = tiny_weights(cfg)
    x = torch.zeros((2, size, size, 3), dtype=torch.uint8)
    got = flops(grid_features, w, x, cfg["resnet_layers"], 2)
    assert got == 2 * models.resnet(cfg["resnet_layers"], size)


def test_depth_models_found():
    assert "dpt_hybrid" in DPT_MODELS
    for name in DPT_MODELS:
        for kind in spec.DPT_FILES:
            assert (BENCH / kind / f"{name}.py").is_file(), (name, kind)


@pytest.mark.parametrize("model", DPT_MODELS)
def test_dpt_against_flop_counter(model):
    """The count of each depth model against the flop counter of its own
    reference, at the tiny size of a configuration that names it."""
    names = [n for n, c in CONFIGS.items()
             if "dpt" in c and spec.dpt_name(c["dpt"]) == model]
    assert names, f"no configuration names the depth model {model!r}"
    cfg = tiny_config(names[0])
    d = cfg["dpt"]
    w = judge.dpt_weights(tiny_weights(cfg))
    x = program.images(5, 2, d["image_size"], "cpu")
    ref = spec.depth_model(cfg).reference
    assert flops(ref.depth_maps, w, x, d) == 2 * dpt_ops(cfg)(d)


def test_dpt_hybrid_published_size():
    d = CONFIGS["depth-soft"]["dpt"]
    ops = dpt_ops(CONFIGS["depth-soft"])(d)
    # the ViT-B/16 blocks alone at 577 tokens, worked out by hand
    n, c = 577, 768
    vit = 12 * (2 * n * c * 3 * c + 4 * n * n * c + 2 * n * c * c
                + 4 * n * c * 4 * c)
    assert ops > vit
    assert abs(ops / 1e9 - 250.4157) < 1e-3


# counts.models.caption at 9, 13 and 30 steps, pinned from the counts
# before the depth model was found by name
CAPTION_OPS = {"depth-soft": [274340100352, 274365372672, 274472780032],
               "base-soft": [23183828992, 23209101312, 23316508672]}


@pytest.mark.parametrize("name", sorted(CAPTION_OPS))
def test_caption_counts_pinned(name):
    cfg = CONFIGS[name]
    assert [models.caption(cfg, s, dpt_ops(cfg)) for s in (9, 13, 30)] == \
        CAPTION_OPS[name]


# sha256 over the sorted names and float32 bytes of the tiny
# configurations' draws at seed 11, pinned before the DPT-hybrid's rule
# was found by name
DRAWS = {"depth-soft": "8757cc3b0ba041d4c4d4755b26320d31"
                       "a60cf989d0a357657c19ba1392fdf9b0",
         "base-soft": "133581df6c871e9f1eaefbcfe516e4a1"
                      "378b586e5713a51de46add0e4f006e77"}


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_drawn_weights_pinned(name):
    cfg = tiny_config(name)
    served = program.build(cfg, 11, "cpu", spec.depth_model(cfg)).served
    h = hashlib.sha256()
    for k in sorted(served):
        h.update(k.encode())
        h.update(served[k].contiguous().numpy().tobytes())
    assert h.hexdigest() == DRAWS[name]


def test_dpt_hybrid_reference_maps_pinned():
    """The tiny DPT-hybrid's reference maps at one seed, pinned before
    its reference became ``reference/dpt_hybrid.py``."""
    cfg = tiny_config("depth-soft")
    ref = spec.depth_model(cfg).reference
    m = ref.depth_maps(judge.dpt_weights(tiny_weights(cfg)),
                       program.images(5, 3, 224, "cpu"), cfg["dpt"])
    assert list(m.shape) == [3, 224, 224, 1]
    got = m.flatten()
    pinned = {0: 0.12088150531053543, 1000: 0.37437114119529724,
              5000: 0.5359177589416504, 20000: 0.7880096435546875,
              77777: 0.8565689921379089, 100000: 0.20187634229660034,
              150000: 0.45443427562713623}
    for i, v in pinned.items():
        assert float(got[i]) == pytest.approx(v, rel=1e-6, abs=1e-7), i
    assert float(m.double().sum()) == pytest.approx(65735.37238581554,
                                                    rel=1e-9)


def test_depth_cnn_against_flop_counter():
    cfg = tiny_config("depth-soft")
    w = tiny_weights(cfg)
    maps = torch.zeros((1, 224, 224, 1))
    got = flops(depth_features, w, maps, cfg["enc_img_size"])
    assert got == models.depth_cnn(cfg["depth_cnn"]["channels"], 224)


def test_decoder_against_flop_counter():
    cfg = tiny_config("base-soft")
    d = ref_decoder.weights(tiny_weights(cfg))
    z = models.sizes(cfg)
    feats = torch.rand((3, z["k"], z["d"]))
    steps = 4
    inputs = torch.zeros((3, steps), dtype=torch.long)
    got = flops(ref_decoder.teacher_forced, d, feats, inputs)
    want = 3 * (models.decoder_setup(z["k"], z["d"], z["a"], z["h"])
                + steps * models.decoder_step(**z))
    # the counter leaves out matrix-vector products (aten::mv): the
    # attention score's reduction of K x A a step, which the counts keep
    assert got == want - 3 * steps * 2 * z["k"] * z["a"]


def test_caption_counts_the_steps_it_ran():
    cfg = tiny_config("depth-soft")
    z = models.sizes(cfg)
    fixed = (models.resnet(cfg["resnet_layers"], 224)
             + dpt_ops(cfg)(cfg["dpt"])
             + models.decoder_setup(z["k"], z["d"], z["a"], z["h"])
             + models.depth_cnn(cfg["depth_cnn"]["channels"]))
    assert models.caption(cfg, 12, dpt_ops(cfg)) == \
        fixed + 12 * models.decoder_step(**z)


def test_vit_attention_by_hand():
    ops, nbytes = kernels.vit_attention(768, 577, 64)
    assert ops == 4 * 768 * 577 * 577 * 64
    assert nbytes == 4 * 768 * 577 * 64 * 2
    # bound by bytes at these sizes (PERF.md's K5 bound: 0.0677 ms)
    assert math.isclose(kernels.vit_attention_seconds(768, 577, 64) * 1e3,
                        0.0677, rel_tol=2e-3)


def test_greedy_decode_by_hand():
    k, d, a, e, h, v, length = 2, 8, 4, 8, 8, 10, 3
    ops, nbytes = kernels.greedy_decode([1, 3], k, d, a, e, h, v, length,
                                        feature_bytes=4)
    step = 2 * (h * a + k * a + k * d + h * d + (e + d + h) * 4 * h + h * v)
    assert ops == 4 * step
    weights = h * a + 2 * a + 1 + h * d + d + (e + d + h) * 4 * h + 4 * h
    want = (2 * k * d * 4 + 4 * (2 * k * a + 2 * 2 * h)
            + 4 * (weights + h * v + v + v * e) + 4 * 2 * length + 4 * 4 * e)
    assert nbytes == want


def test_greedy_decode_main_shape_is_bound_by_operations():
    # PERF.md's K2 bound at B=64 and 30 steps: 0.181 ms, operations
    z = dict(k=196, d=2048, a=128, e=128, h=128, v=9956)
    ops, nbytes = kernels.greedy_decode([30] * 64, length=30, **z)
    assert ops / kernels.F32_FLOPS > nbytes / kernels.HBM_BYTES_PER_S
    assert math.isclose(kernels.greedy_decode_seconds(
        [30] * 64, length=30, **z) * 1e3, 0.181, rel_tol=5e-3)


def test_weights_draw_in_few_calls():
    calls = []
    real = torch.randn

    def counting(*a, **kw):
        calls.append(a)
        return real(*a, **kw)
    torch.randn, saved = counting, torch.randn
    try:
        W.draw([(f"x{i}.weight", torch.zeros(4, 4, 3, 3)) for i in range(9)],
               lambda n, s: ("normal", 1.0), torch.Generator(), "cpu")
    finally:
        torch.randn = saved
    assert len(calls) == 1


def test_group_norms_of_the_hybrid():
    """K6's 52 GroupNorms a DPT-hybrid forward at 384x384, and PERF.md's
    bounds at B=64 in bf16: stage 0's norm3 (96x96x256 with the residual)
    0.2704 ms, the forward's 52 3.211 ms."""
    d = CONFIGS["depth-soft"]["dpt"]
    norms = spec.depth_model(CONFIGS["depth-soft"]).counts.group_norms(d)
    assert len(norms) == 52
    assert norms[0] == (192, 64, False)                  # the stem's
    assert sum(res for _, _, res in norms) == sum(d["resnet_layers"])
    assert norms[3] == (96, 256, True)                   # stage 0's norm3
    assert math.isclose(kernels.group_norm_seconds(64, 96 * 96, 256, True)
                        * 1e3, 0.2704, rel_tol=2e-4)
    assert kernels.group_norm(2, 5, 64, False, 4) == 2 * 2 * 5 * 64 * 4
    forward = sum(kernels.group_norm_seconds(64, s * s, c, res)
                  for s, c, res in norms)
    assert math.isclose(forward * 1e3, 3.211, rel_tol=5e-4)


def test_hybrid_gets_the_keywords_it_got():
    """The port's DPT-hybrid is built with the same keywords as before
    the depth model was found by name; any model's block passes on every
    key but the model's name, with ``mlp_ratio`` checked, not passed."""
    d = CONFIGS["depth-soft"]["dpt"]
    assert program.dpt_kwargs(d) == dict(
        dtype=torch.bfloat16, image_size=384, features=256, vit_dim=768,
        vit_heads=12, vit_blocks=12, hooks=(8, 11), resnet_layers=(3, 4, 9),
        patch=16, pretrain_grid=24, gelu="erf", head="full")
    named = program.dpt_kwargs(dict(d, model="dpt_other", extra=[1, 2]))
    assert named == dict(program.dpt_kwargs(d), extra=(1, 2))
    for block in (d, dict(d, model="dpt_other")):
        with pytest.raises(ValueError, match="mlp_ratio"):
            program.dpt_kwargs(dict(block, mlp_ratio=2))
