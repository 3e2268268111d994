"""Model assembly per configuration kind (counterpart of the JAX
``models/captioner.py``). This slice builds ``base-soft`` only: a frozen
ResNet-152 grid encoder and a soft-attention decoder. Every other kind
raises ``NotImplementedError`` until its slice is ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn

from depth_image_captioning_pub_tpu.config import ConfigTrain
from depth_image_captioning_pub_torch.models.decoder import AttentionDecoder
from depth_image_captioning_pub_torch.models.resnet import (
    RESNET152_LAYERS, AttentionGridEncoder)

PORTED_KINDS = ("base-soft",)


@dataclasses.dataclass(frozen=True)
class CaptionerSpec:
    kind: str
    attention: Optional[str]        # None (nic) | "soft" | "hard"
    fusion: str                     # "none" | "add" | "concat"
    depth_encoder: Optional[str]    # None | "cnn" | "mlp"

    @staticmethod
    def from_kind(kind: str) -> "CaptionerSpec":
        table = {
            "nic": (None, "none", None),
            "base-soft": ("soft", "none", None),
            "base-hard": ("hard", "none", None),
            "depth-soft": ("soft", "add", "cnn"),
            "depth-hard": ("hard", "add", "cnn"),
            "mdepth-soft": ("soft", "concat", "mlp"),
            "mdepth-hard": ("hard", "concat", "mlp"),
        }
        att, fusion, dep = table[kind]
        return CaptionerSpec(kind, att, fusion, dep)

    @property
    def uses_depth(self) -> bool:
        return self.depth_encoder is not None

    @property
    def is_nic(self) -> bool:
        return self.attention is None


class Captioner(nn.Module):
    """Encoder + decoder of one configuration on one device.

    ``encoder_dtype`` is the conv compute/storage dtype (bf16 by default);
    the decoder is float32, as the greedy kernel requires. ``resnet_layers``
    shrinks the backbone for tests (default ResNet-152).
    """

    def __init__(self, spec: CaptionerSpec, cfg: ConfigTrain,
                 vocab_size: int, encoder_dtype=torch.bfloat16,
                 resnet_layers: Optional[Sequence[int]] = None,
                 device=None):
        super().__init__()
        if spec.kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"kind {spec.kind!r} is not ported yet; this package has "
                f"{PORTED_KINDS} (ROADMAP.md, Queue A)")
        self.spec = spec
        self.device = torch.device(device or "cpu")
        self.encoder = AttentionGridEncoder(
            cfg.enc_img_size, dtype=encoder_dtype,
            layers=tuple(resnet_layers or RESNET152_LAYERS),
            device=self.device)
        self.decoder = AttentionDecoder(
            vocab_size, dim_attention=cfg.dim_attention,
            dim_embedding=cfg.dim_embedding, dim_encoder=cfg.dim_encoder,
            dim_decoder=cfg.dim_hidden, device=self.device)

    def init(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator`` with the JAX package's
        distributions (torch defaults; U(-0.1, 0.1) embedding and head)."""
        self.encoder.reset_parameters(generator)
        self.decoder.reset_parameters(generator)

    def encoder_apply(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """normalized NHWC images -> features [B, K, 2048] (encoder dtype)."""
        return self.encoder

    def sample_apply(self) -> Callable[..., torch.Tensor]:
        """(features, start_id, *, max_length, end_id) -> tokens [B, L]."""
        return self.decoder.greedy_sample


def build_captioner(kind: str, vocab_size: int,
                    cfg: Optional[ConfigTrain] = None,
                    encoder_dtype=torch.bfloat16,
                    resnet_layers: Optional[Sequence[int]] = None,
                    device=None) -> Captioner:
    return Captioner(CaptionerSpec.from_kind(kind), cfg or ConfigTrain(),
                     vocab_size, encoder_dtype, resnet_layers, device)
