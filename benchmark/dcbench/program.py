"""The program under test, built from a configuration file: the port's
captioner, its DPT, the vocabulary and the weights drawn from the seed.
Only this module and the traffic modes import the port."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from dcbench import weights as W
from dcbench.spec import DepthModel

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
SPECIALS = ("<start>", "<end>", "<unk>", "<null>")
# the generator streams of one run's draws
STREAM_CAPTIONER, STREAM_DPT, STREAM_IMAGES = 1, 2, 3


def vocabulary(size: int):
    """(word_to_id, id_to_word): words w0.. then the four special tokens,
    the order in which the program's vocabulary builder assigns them."""
    words = [f"w{i}" for i in range(size - len(SPECIALS))] + list(SPECIALS)
    return ({w: i for i, w in enumerate(words)},
            {i: w for i, w in enumerate(words)})


def special_ids(size: int) -> Dict[str, int]:
    base = size - len(SPECIALS)
    return {"start": base, "end": base + 1, "unk": base + 2,
            "null": base + 3}


def train_config(cfg: Dict):
    """The program's ``ConfigTrain`` at the configuration's sizes."""
    from depth_image_captioning_pub_torch.config import ConfigTrain
    return ConfigTrain(**{k: cfg[k] for k in (
        "enc_img_size", "dim_attention", "dim_embedding", "dim_encoder",
        "dim_hidden", "max_length") if k in cfg})


@dataclasses.dataclass
class Program:
    cap: torch.nn.Module
    dpt: Optional[object]           # DPTDepthEstimator
    word_to_id: Dict[str, int]
    id_to_word: Dict[int, str]
    served: Dict[str, torch.Tensor]  # every drawn tensor, float32


# keys of a ``dpt`` block that the harness reads itself and does not pass
# on as they are: the model's name (its files) and the dtype (passed as a
# torch dtype)
HARNESS_KEYS = ("model", "dtype")
# keys the port's ``DPTDepthModel`` takes no argument for, whatever the
# model, and the value it holds: its ViT blocks' MLP ratio is fixed at 4
PORT_FIXED = {"mlp_ratio": 4}


def dpt_kwargs(d: Dict) -> Dict:
    """``DPTDepthEstimator``'s keyword arguments (less ``device``) of a
    configuration's ``dpt`` block, for every model alike: every key but
    ``HARNESS_KEYS`` and ``PORT_FIXED`` (whose values the block has to
    hold), lists as tuples, and ``dtype`` as a torch dtype."""
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()
          if k not in HARNESS_KEYS}
    for k, v in PORT_FIXED.items():
        if kw.pop(k, v) != v:
            raise ValueError(f"the port's DPT holds {k} at {v}, not {d[k]}")
    kw["dtype"] = DTYPES[d["dtype"]]
    return kw


def build(cfg: Dict, seed: int, device,
          dpt_model: Optional[DepthModel]) -> Program:
    """The captioner (and DPT) of ``cfg`` on ``device`` with weights drawn
    from ``seed``; the DPT's draw by the rule of ``dpt_model``, the depth
    model ``cfg`` names (``spec.depth_model``; None without a DPT)."""
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.models.dpt import DPTDepthEstimator
    v = cfg["vocab_size"]
    w2i, i2w = vocabulary(v)
    cap = build_captioner(cfg["kind"], v, train_config(cfg),
                          encoder_dtype=DTYPES[cfg["encoder_dtype"]],
                          resnet_layers=tuple(cfg["resnet_layers"]),
                          device=device,
                          decoder_dtype=DTYPES[cfg["decoder_dtype"]])
    wcfg = cfg["weights"]
    res = wcfg["residual_scale"]
    last = f"layer{len(cfg['resnet_layers'])}_0"
    sizes = {"d": cfg["dim_encoder"], "h": cfg["dim_hidden"],
             "a": cfg["dim_attention"]}

    def rule(name, shape):
        if name.startswith("encoder.backbone."):
            return W.resnet_rule(name, shape, res, last,
                                 wcfg["feature_scale"])
        if name.startswith("depth_module."):
            return W.depth_cnn_rule(name, shape, res)
        return W.decoder_rule(name[len("decoder."):], shape, sizes,
                              wcfg["embed_scale"])

    values = W.draw(W.named(cap), rule,
                    W.seed_generator(seed, STREAM_CAPTIONER, device), device)
    W.length_clock(values, special_ids(v)["end"], wcfg)
    served = W.load_into(cap, values)
    del values
    dpt = None
    if "dpt" in cfg:
        dpt_rule = dpt_model.rule
        dpt = DPTDepthEstimator(device=device, **dpt_kwargs(cfg["dpt"]))
        values = W.draw(W.named(dpt.model, "dpt."),
                        lambda n, s: dpt_rule(n[4:], s, res),
                        W.seed_generator(seed, STREAM_DPT, device), device)
        served.update(W.load_into(dpt.model, values, "dpt."))
        del values
    return Program(cap, dpt, w2i, i2w, served)


GRIDS = ((3, 4), (6, 8), (12, 16), (24, 32))


def images(seed: int, n: int, size, device, stream: int = STREAM_IMAGES,
           chunk: int = 256, pin: bool = False) -> torch.Tensor:
    """``n`` seeded photo-like uint8 images [n, H, W, 3] on the host
    (``size``: H = W, or (H, W); ``pin``: in page-locked memory),
    drawn on ``device``: a smooth field (a bilinear upsample of noise on
    a grid of 3x4 to 24x32 cells, one grid an image), under an image's own
    contrast, brightness and colour cast, plus pixel noise of an image's
    own strength; images differ as photographs of different scenes do."""
    import torch.nn.functional as F
    g = W.seed_generator(seed, stream, device)
    hw = (size, size) if isinstance(size, int) else tuple(size)
    out = torch.empty((n, *hw, 3), dtype=torch.uint8, pin_memory=pin)
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        pick = torch.randint(0, len(GRIDS), (m,), generator=g, device=device)
        big = torch.empty((m, 3, *hw), device=device)
        for i, grid in enumerate(GRIDS):
            rows = (pick == i).nonzero()[:, 0]
            small = torch.rand((m, 3, *grid), generator=g, device=device)
            big[rows] = F.interpolate(small[rows], size=hw,
                                      mode="bilinear", align_corners=False)
        u = torch.rand((m, 6), generator=g, device=device)
        contrast = 0.3 + 1.2 * u[:, :1]
        level = 128 + 120 * (u[:, 1:2] - 0.5) + 80 * (u[:, 2:5] - 0.5)
        big = (big - 0.5) * 255 * contrast[:, :, None, None] + level[
            :, :, None, None]
        noise = 2 + 18 * u[:, 5]
        big += torch.randn(big.shape, generator=g, device=device) * noise[
            :, None, None, None]
        out[lo:lo + m] = big.clamp_(0, 255).to(torch.uint8).permute(
            0, 2, 3, 1).cpu()
    return out
