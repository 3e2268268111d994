"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``reference/``) on the same weights and
inputs, once the program is freed.

Captioning (``captions``) compares four numbers, each a stage by itself:

* ``rgb_feat``: the RGB encoder's features against the reference
  encoder's, the largest difference over the largest reference value;
* ``depth_map``: the depth maps the depth CNN read against the reference
  DPT's maps of the same images (maps lie in [0, 1]), the reference of
  the model the configuration names (``reference/<model>.py``);
* ``depth_feat``: the depth CNN's features against the reference CNN's on
  the program's maps;
* ``logit_gap``: the widest gap by which a served token's logit lies
  below the best logit of the reference decoder, teacher-forced over the
  served tokens on the program's fused features.

The last two follow the program's own state (its maps, its features),
so that the decoder's float32 comparison is not drowned by the encoders'
bfloat16 rounding; the stages they skip are checked by the first two.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from dcbench.program import special_ids
from dcbench.spec import DepthModel
from reference import decoder as ref_decoder
from reference.depth_cnn import depth_features
from reference.ops import tf32
from reference.resnet import grid_features

BLOCK = 32          # images a reference call takes at a time


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


def _rows(chunks: List[torch.Tensor], n: int) -> torch.Tensor:
    """The first ``n`` rows of the chunks' outputs, padding rows left out
    (each chunk's valid rows lead it)."""
    out, left = [], n
    size = chunks[0].shape[0] if chunks else 0
    for c in chunks:
        take = min(left, size, c.shape[0])
        out.append(c[:take])
        left -= take
    return torch.cat(out)


def dpt_weights(served: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k[4:]: v for k, v in served.items() if k.startswith("dpt.")}


def readings(cfg: Dict, served: Dict[str, torch.Tensor], images_u8,
             feats, maps, dep, tokens, device,
             dpt: Optional[DepthModel]) -> Dict[str, float]:
    """The numbers of one request: ``images_u8`` [n, H, W, 3] (host),
    the program's ``feats``, ``maps``, ``dep`` [n, ...] (``maps`` and
    ``dep`` None without depth) and ``tokens``; ``dpt``: the depth model
    whose reference makes the maps."""
    dec = ref_decoder.weights(served)
    ids = special_ids(cfg["vocab_size"])
    # largest difference over largest reference value, over the blocks
    num = {"rgb_feat": 0.0} if maps is None else {"rgb_feat": 0.0,
                                                   "depth_feat": 0.0}
    den = dict(num)
    out = {"logit_gap": 0.0, "tokens_compared": 0}
    if maps is not None:
        out["depth_map"] = 0.0

    def gap(key, prog, ref):
        num[key] = max(num[key], float((prog.float() - ref).abs().max()))
        den[key] = max(den[key], float(ref.abs().max()))

    with torch.no_grad(), tf32(False):
        for lo in range(0, images_u8.shape[0], BLOCK):
            hi = lo + BLOCK
            x = torch.as_tensor(images_u8[lo:hi]).to(device)
            gap("rgb_feat", feats[lo:hi], grid_features(
                served, x, cfg["resnet_layers"], cfg["enc_img_size"]))
            fused = feats[lo:hi].float()
            if maps is not None:
                m_ref = dpt.reference.depth_maps(dpt_weights(served), x,
                                                 cfg["dpt"])
                out["depth_map"] = max(out["depth_map"], float(
                    (maps[lo:hi].float() - m_ref).abs().max()))
                gap("depth_feat", dep[lo:hi], depth_features(
                    served, maps[lo:hi], cfg["enc_img_size"]))
                fused = (feats[lo:hi] + dep[lo:hi]).float()   # add fusion
            g, k = ref_decoder.widest_gap(
                dec, fused, torch.as_tensor(tokens[lo:hi]).to(device),
                ids["start"], ids["end"])
            out["logit_gap"] = max(out["logit_gap"], g)
            out["tokens_compared"] += k
    out.update({k: num[k] / max(den[k], 1e-30) for k in num})
    return out


def captions(cfg: Dict, served, records: List[Dict], pool: np.ndarray,
             device, dpt: Optional[DepthModel]) -> Dict[str, float]:
    """The worst readings over the requests kept (each with the chunks'
    captured tensors, its tokens and its index in ``pool``)."""
    worst: Dict[str, float] = {}
    for rec in records:
        n = rec["tokens"].shape[0]
        got = readings(cfg, served, pool[rec["request"]],
                       _rows(rec["feats"], n),
                       _rows(rec["maps"], n) if rec["maps"] else None,
                       _rows(rec["dep"], n) if rec["dep"] else None,
                       rec["tokens"], device, dpt)
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v) if k != "tokens_compared" \
                else worst.get(k, 0) + v
    return worst


def worst_to_checks(worst: Dict[str, float], limits: Optional[Dict]
                    ) -> List[Check]:
    limits = limits or {}
    return [Check(k, v, limits.get(k, float("inf")))
            for k, v in worst.items() if k != "tokens_compared"]
