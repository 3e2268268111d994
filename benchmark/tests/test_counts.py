"""The benchmark's operation and byte counts against hand-worked small
shapes and against ``torch.utils.flop_counter`` on the reference modules
(which counts convolutions and matrix products, as the counts do)."""

import json
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from counts import kernels, models
from dcbench import program, weights as W
from reference import decoder as ref_decoder
from reference.depth_cnn import depth_features
from reference.dpt import dpt_forward
from reference.resnet import grid_features
from tiny import BENCH, TINY_DPT, tiny_config


def flops(fn, *args, **kwargs):
    with FlopCounterMode(display=False) as m:
        fn(*args, **kwargs)
    return m.get_total_flops()


def tiny_weights(cfg):
    """Weights of ``cfg`` drawn on the CPU, as a run draws them."""
    return program.build(cfg, 3, "cpu").served


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


def test_dpt_against_flop_counter():
    cfg = tiny_config("depth-soft")
    w = {k[4:]: v for k, v in tiny_weights(cfg).items()
         if k.startswith("dpt.")}
    d = dict(TINY_DPT)
    x = torch.zeros((2, 3, d["image_size"], d["image_size"]))
    assert flops(dpt_forward, w, x, d) == 2 * models.dpt(d)


def test_dpt_hybrid_published_size():
    d = json.loads((BENCH / "configs" / "depth-soft.json").read_text())["dpt"]
    # the ViT-B/16 blocks alone at 577 tokens, worked out by hand
    n, c = 577, 768
    vit = 12 * (2 * n * c * 3 * c + 4 * n * n * c + 2 * n * c * c
                + 4 * n * c * 4 * c)
    assert models.dpt(d) > vit
    assert abs(models.dpt(d) / 1e9 - 250.4157) < 1e-3


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
    fixed = (models.resnet(cfg["resnet_layers"], 224) + models.dpt(cfg["dpt"])
             + models.decoder_setup(z["k"], z["d"], z["a"], z["h"])
             + models.depth_cnn(cfg["depth_cnn"]["channels"]))
    assert models.caption(cfg, 12) == fixed + 12 * models.decoder_step(**z)


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
