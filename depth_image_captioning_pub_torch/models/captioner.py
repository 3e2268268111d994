"""Model assembly per configuration kind (counterpart of the JAX
``models/captioner.py``). This package builds the JAX package's seven
kinds: ``base-soft`` / ``base-hard`` (a frozen ResNet-152 grid encoder and
a soft- or hard-attention decoder), ``depth-soft`` / ``depth-hard`` (the
same, plus a ``DepthCNNEncoder`` whose features are added to the RGB
features), ``mdepth-soft`` / ``mdepth-hard`` (a ``DepthMLPEncoder`` on 16x16
depth patches whose 32 features per region are concatenated to the RGB
features, D = 2080) and ``nic`` (Show and Tell: the frozen ResNet-152, a
global average pool, a trainable Linear 2048 -> 300 and a two-layer LSTM
decoder). The DPT that makes the depth maps is not part of the
``Captioner``: ``make_caption_fn`` takes it as ``depth_fn``, as in the JAX
package.

Training differentiates ``trainable_parameters()``, the JAX package's
``params`` tree: the decoder, NIC's projection and the depth encoder. The
RGB backbone is frozen (its parameters do not require gradients, and the
train step runs it under ``torch.no_grad()``), as is the DPT.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from depth_image_captioning_pub_torch.config import ConfigTrain
from depth_image_captioning_pub_torch.models.decoder import AttentionDecoder
from depth_image_captioning_pub_torch.models.depth_encoders import (
    DepthCNNEncoder, DepthMLPEncoder, img_to_patch)
from depth_image_captioning_pub_torch.models.initializers import (
    torch_bias, torch_linear_kernel)
from depth_image_captioning_pub_torch.models.nic import NICDecoder
from depth_image_captioning_pub_torch.models.resnet import (
    RESNET152_LAYERS, AttentionGridEncoder, ResNetBackbone)
from depth_image_captioning_pub_torch.ops.pooling import global_avg_pool
from depth_image_captioning_pub_torch.ops.precision import full_f32

PORTED_KINDS = ("nic", "base-soft", "base-hard", "depth-soft", "depth-hard",
                "mdepth-soft", "mdepth-hard")


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
        if kind not in table:
            raise ValueError(f"unknown kind {kind!r}; one of {PORTED_KINDS}")
        att, fusion, dep = table[kind]
        return CaptionerSpec(kind, att, fusion, dep)

    @property
    def uses_depth(self) -> bool:
        return self.depth_encoder is not None

    @property
    def is_nic(self) -> bool:
        return self.attention is None


class NICProjection(nn.Module):
    """The trainable Linear(2048 -> dim_embedding) of the NIC encoder. As
    flax's ``Dense(dtype=pooled.dtype)``: the product and the bias add run
    in the pooled features' dtype, on weights cast to it."""

    def __init__(self, dim_in: int, dim_embedding: int, device=None):
        super().__init__()
        self.linear = nn.Linear(dim_in, dim_embedding, device=device,
                                dtype=torch.float32)

    def reset_parameters(self, generator: torch.Generator) -> None:
        w = self.linear.weight
        with torch.no_grad():
            w.copy_(torch_linear_kernel((w.shape[1], w.shape[0]),
                                        generator).T)
            self.linear.bias.copy_(torch_bias(w.shape[1])(
                self.linear.bias.shape, generator))

    @full_f32()
    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        dt = pooled.dtype
        y = pooled @ self.linear.weight.to(dt).T
        return y + self.linear.bias.to(dt)


class Captioner(nn.Module):
    """Encoder(s) + decoder of one configuration on one device.

    ``encoder_dtype`` is the conv compute/storage dtype of the RGB and depth
    encoders (bf16 by default); the decoder is float32, as the decode
    kernels require. ``resnet_layers`` shrinks the backbone for tests
    (default ResNet-152). ``device`` is where the modules live: the CUDA
    card unless the caller asks for another.
    """

    def __init__(self, spec: CaptionerSpec, cfg: ConfigTrain,
                 vocab_size: int, encoder_dtype=torch.bfloat16,
                 resnet_layers: Optional[Sequence[int]] = None,
                 device="cuda"):
        super().__init__()
        self.spec = spec
        self.device = torch.device(device)
        layers = tuple(resnet_layers or RESNET152_LAYERS)
        self.depth_module = None
        if spec.is_nic:
            self.backbone = ResNetBackbone(layers, dtype=encoder_dtype,
                                           device=self.device)
            self.projection = NICProjection(cfg.dim_encoder,
                                            cfg.nic_dim_embedding,
                                            device=self.device)
            self.decoder = NICDecoder(
                vocab_size, dim_embedding=cfg.nic_dim_embedding,
                dim_hidden=cfg.dim_hidden, num_layers=cfg.num_layers,
                device=self.device, dropout=cfg.nic_dropout)
            return
        self.encoder = AttentionGridEncoder(
            cfg.enc_img_size, dtype=encoder_dtype, layers=layers,
            device=self.device)
        self.decoder = AttentionDecoder(
            vocab_size, dim_attention=cfg.dim_attention,
            dim_embedding=cfg.dim_embedding, dim_encoder=cfg.dim_encoder,
            dim_decoder=cfg.dim_hidden, fusion=spec.fusion,
            device=self.device, attention_kind=spec.attention,
            dim_depth=cfg.dim_out, dropout=cfg.dropout)
        if spec.depth_encoder == "cnn":
            self.depth_module = DepthCNNEncoder(
                cfg.enc_img_size, dtype=encoder_dtype, device=self.device)
        elif spec.depth_encoder == "mlp":
            self.depth_module = DepthMLPEncoder(
                cfg.dim_l1, cfg.dim_l2, cfg.dim_out, device=self.device)

    def init(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator`` with the JAX package's
        distributions (torch defaults; U(-0.1, 0.1) embedding and head;
        the depth encoder's BN at scale 1, bias 0, mean 0, var 1; NIC's
        embedding N(0, 1))."""
        if self.spec.is_nic:
            self.backbone.reset_parameters(generator)
            self.projection.reset_parameters(generator)
        else:
            self.encoder.reset_parameters(generator)
        self.decoder.reset_parameters(generator)
        if self.depth_module is not None:
            self.depth_module.reset_parameters(generator)

    def encoder_apply(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """normalized NHWC images -> features [B, K, 2048] (encoder dtype);
        for NIC the projected image embedding [B, 300]: backbone, global
        average pool and projection, all in the encoder dtype."""
        if self.spec.is_nic:
            return lambda images: self.projection(
                global_avg_pool(self.backbone(images)))
        return self.encoder

    def depth_encoder_apply(
            self, train: bool = False
    ) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
        """standardized depth maps [B, 224, 224, 1] -> depth features: the
        CNN's [B, K, 2048] (encoder dtype; on the BN running statistics,
        or with ``train`` on the batch's, moving the running ones) or the
        MLP's [B, K, 32] f32 on the maps' 16x16 patches (it has no batch
        statistics); None for kinds without depth."""
        if self.spec.depth_encoder == "mlp":
            return lambda depth: self.depth_module(img_to_patch(depth))
        if train and self.depth_module is not None:
            return functools.partial(self.depth_module, train=True)
        return self.depth_module

    def trainable_parameters(self) -> List[nn.Parameter]:
        """The parameters training updates (the JAX ``params`` tree): the
        decoder's, NIC's projection's, the depth encoder's."""
        modules = [self.decoder]
        if self.spec.is_nic:
            modules.append(self.projection)
        if self.depth_module is not None:
            modules.append(self.depth_module)
        return [p for m in modules for p in m.parameters()]

    def sample_apply(self, sampling: Optional[Dict] = None
                     ) -> Callable[..., torch.Tensor]:
        """Greedy decode: (features, start_id, depth_features=None, *,
        max_length, end_id) -> tokens [B, L] (hard attention also takes
        ``generator`` or ``att_noise``, its region noise); for NIC
        (features, *, max_length) -> tokens [B, L]. With ``sampling``
        (``temperature``, ``top_k``, ``top_p``) the stochastic sampler with
        those settings: (features, start_id, generator, depth_features=None,
        *, max_length) -> (tokens [B, L], alphas [B, L, K]); for NIC
        (features, generator, *, max_length) -> tokens [B, L]. Soft
        attention decodes on the kernels, hard attention on PyTorch ops
        (``models/decoder.py``)."""
        if sampling is None:
            return self.decoder.greedy_sample
        return functools.partial(self.decoder.stochastic_sample, **sampling)


def build_captioner(kind: str, vocab_size: int,
                    cfg: Optional[ConfigTrain] = None,
                    encoder_dtype=torch.bfloat16,
                    resnet_layers: Optional[Sequence[int]] = None,
                    device="cuda") -> Captioner:
    return Captioner(CaptionerSpec.from_kind(kind), cfg or ConfigTrain(),
                     vocab_size, encoder_dtype, resnet_layers, device)
