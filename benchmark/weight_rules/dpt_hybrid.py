"""The DPT-hybrid's weight draw (``DPTDepthModel``'s names, the ``dpt.``
prefix taken off): ``dcbench/weights.py``'s conventions, the
weight-standardized ResNetV2 kernels at unit normal (the standardization
rescales them)."""

import math

from dcbench.weights import Rule, fan_in

RELU_AFTER = ("fc1", "project", "conv1", "head_conv1", "head_conv2",
              "stem_conv")


def rule(name: str, shape, res: float) -> Rule:
    parts = name.split(".")
    if name in ("cls_token", "pos_embed"):
        return "normal", 0.02
    if name.endswith(".bias"):
        return "const", 0.0
    if ".gn." in name or parts[-2].startswith("norm"):   # GN, LayerNorm
        return "const", res if ".norm3." in name else 1.0
    if name.startswith("resnet."):                # weight-standardized
        return "normal", 1.0
    if name == "head_conv3.weight":               # the map stays positive
        return "abs_normal", math.sqrt(2.0 / fan_in(shape))
    layer = parts[-2]
    gain = 2.0 if layer in RELU_AFTER else 1.0
    std = math.sqrt(gain / fan_in(shape))
    residual_last = layer in ("proj", "fc2") or (
        layer == "conv2" and ".res" in name)
    return "normal", std * (res if residual_last else 1.0)
