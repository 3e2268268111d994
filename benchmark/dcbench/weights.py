"""Weights drawn from the run's seed on the device, in a few large calls,
into the program's modules; the same values, as float32, go to the
reference.

The draws keep every layer's activations in range, as a trained model's
are, so that a rounding difference stays a rounding difference instead of
growing layer by layer: He-normal kernels before a ReLU, LeCun-normal
elsewhere, and the last layer of each residual branch (its norm's scale,
or its kernel) scaled by ``residual_scale``; the RGB features scaled to
a trained encoder's range by ``feature_scale``. Norms start at scale 1 and
bias 0; BatchNorm's running statistics at mean 0, variance 1. The
decoder keeps the reference repository's uniform draws, with the
embedding at +-``embed_scale`` (so that the token fed back moves the
state), and one LSTM unit made a clock that ends the captions
(``length_clock``). Values are rounded to the dtype each tensor is
stored in by the program, so the reference reads what the program reads.
A depth model's rule is a file of its own, ``weight_rules/<model>.py``,
found by the model's name (``spec.DepthModel``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Tuple

import torch

Rule = Tuple[str, float]     # ("normal" | "uniform" | "abs_normal" | "const", scale)

# the decoder's uniform bounds: the fan-in of each tensor's layer
DECODER_FAN_IN = {"att_w_enc": 0, "att_b_enc": "d", "att_w_dec": 0,
                  "att_b_dec": "h", "att_w_full": 0, "att_b_full": "a",
                  "lstm_w_ih": 0, "lstm_w_hh": 0, "lstm_b_ih": "h",
                  "lstm_b_hh": "h", "init_w": 0, "init_b": "d",
                  "f_beta_w": 0, "f_beta_b": "h"}


def fan_in(shape) -> int:
    """The fan-in of a [out, in, ...] kernel (a transposed convolution's
    [in, out, k, k] needs its own)."""
    return int(math.prod(shape[1:])) if len(shape) > 1 else int(shape[0])


def resnet_rule(name: str, shape, res: float, last: str = "",
                out_scale: float = 1.0) -> Rule:
    """The frozen ResNet (``encoder.backbone.``). The BatchNorms that end
    the block ``last`` (the last stage's first: both of its paths) scale
    by ``out_scale``; every later block is positively homogeneous, so the
    features scale by it."""
    if name.endswith(".weight") and len(shape) == 4:
        return "normal", math.sqrt(2.0 / fan_in(shape))
    if name.endswith("running_var"):
        return "const", 1.0
    if name.endswith(".weight"):                  # a BatchNorm's scale
        ends = name.endswith((".bn3.weight", ".ds_bn.weight"))
        scale = out_scale if ends and f".{last}." in name else 1.0
        return "const", scale * (res if ".bn3." in name else 1.0)
    return "const", 0.0                           # biases, running means


def depth_cnn_rule(name: str, shape, res: float) -> Rule:
    """The depth CNN (``depth_module.``)."""
    if name.endswith(".weight") and len(shape) == 4:
        return "normal", math.sqrt(2.0 / fan_in(shape))
    if name.endswith(("running_var", "bn1.weight", "bn2.weight",
                      "bn3.weight")):
        return "const", 1.0
    return "const", 0.0


def decoder_rule(name: str, shape, sizes: Dict[str, int],
                 embed_scale: float) -> Rule:
    """The attention decoder (``decoder.``): U(+-1/sqrt(fan_in))."""
    if name == "embed":
        return "uniform", embed_scale
    if name == "out_w":
        return "uniform", 0.1
    if name == "out_b":
        return "const", 0.0
    fan = DECODER_FAN_IN[name]
    fan = shape[0] if fan == 0 else sizes[fan]
    return "uniform", 1.0 / math.sqrt(fan)


def length_clock(values: Dict[str, torch.Tensor], end: int, w: Dict,
                 prefix: str = "decoder.") -> None:
    """Make the decoder's last LSTM unit a clock that ends the captions at
    different steps, as a trained decoder's do, in ``values`` (in place).

    Its gates read only their biases, saturated open (input, forget,
    output at +8), but for the cell input, whose pre-activation is
    ``length_rate`` plus the fed-back token's first embedding value (drawn
    in +-``embed_scale``) scaled to +-``length_swing``: its cell sums a
    step of tanh(rate +- swing) a token, from 0, and the unit's output
    rises with it. The unit reads and feeds nothing else, but the
    ``<end>`` logit, which is ``end_weight`` times it plus ``end_bias``:
    ``<end>`` wins once the unit passes the other logits' best. The
    tokens fed back set each row's pace, within bounds, so every caption
    ends between two steps that the four numbers fix."""
    ih, hh = values[prefix + "lstm_w_ih"], values[prefix + "lstm_w_hh"]
    h = hh.shape[0]
    j = h - 1
    gates = [j, h + j, 2 * h + j, 3 * h + j]
    ih[:, gates] = 0.0
    hh[:, gates] = 0.0
    ih[0, 2 * h + j] = w["length_swing"] / w["embed_scale"]
    values[prefix + "lstm_b_ih"][gates] = torch.tensor(
        [8.0, 8.0, w["length_rate"], 8.0], device=ih.device)
    values[prefix + "lstm_b_hh"][gates] = 0.0
    values[prefix + "init_w"][:, [j, h + j]] = 0.0     # h0, c0 of the unit
    values[prefix + "init_b"][[j, h + j]] = 0.0
    for name in ("lstm_w_hh", "att_w_dec", "f_beta_w", "out_w"):
        values[prefix + name][j] = 0.0               # it feeds nothing
    out_w = values[prefix + "out_w"]
    out_w[:, end] = 0.0
    out_w[j, end] = w["end_weight"]
    values[prefix + "out_b"][end] = w["end_bias"]


def draw(tensors: Iterable[Tuple[str, torch.Tensor]],
         rule: Callable[[str, tuple], Rule], generator: torch.Generator,
         device) -> Dict[str, torch.Tensor]:
    """Float32 values for every named tensor by its rule: one normal and
    one uniform draw on ``device`` for all of them, then sliced."""
    plan = [(n, tuple(t.shape), rule(n, tuple(t.shape))) for n, t in tensors]
    out: Dict[str, torch.Tensor] = {}
    for kind in ("normal", "uniform"):
        picked = [(n, s, r) for n, s, r in plan
                  if r[0] == kind or (kind == "normal" and r[0] == "abs_normal")]
        total = sum(math.prod(s) for _, s, _ in picked)
        if not total:
            continue
        if kind == "normal":
            flat = torch.randn(total, generator=generator, device=device)
        else:
            flat = torch.rand(total, generator=generator, device=device)
            flat = flat * 2.0 - 1.0
        at = 0
        for n, s, (k, scale) in picked:
            v = flat[at:at + math.prod(s)].view(s) * scale
            out[n] = v.abs() if k == "abs_normal" else v
            at += math.prod(s)
    for n, s, (k, scale) in plan:
        if k == "const":
            out[n] = torch.full(s, scale, dtype=torch.float32, device=device)
    return out


def load_into(module: torch.nn.Module, values: Dict[str, torch.Tensor],
              prefix: str = "") -> Dict[str, torch.Tensor]:
    """Copy ``values`` into the module's tensors of the same names (under
    ``prefix``); returns the values rounded to the dtype each tensor is
    stored in, as float32, for the reference."""
    state = dict(module.state_dict(keep_vars=True))
    served = {}
    with torch.no_grad():
        for name, v in values.items():
            t = state[name[len(prefix):]]
            served[name] = v.to(t.dtype).to(torch.float32)
            t.copy_(v)
    return served


def seed_generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of the run's draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def named(module: torch.nn.Module, prefix: str = ""):
    """(prefixed name, tensor) of the module's parameters and buffers."""
    return [(prefix + n, t) for n, t in module.state_dict().items()]
