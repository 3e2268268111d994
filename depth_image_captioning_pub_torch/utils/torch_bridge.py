"""Reference PyTorch checkpoints -> the JAX package's parameter trees (the
port's own copy of the JAX ``utils/torch_bridge.py``).

The reference's published and trained weights come as PyTorch files:
torchvision's ResNet-152 IMAGENET1K_V2, the Omnidata DPT-hybrid ``.ckpt``
(its ``state_dict`` keys carry a 6-character ``model.`` prefix), and each
run's encoder / decoder / depth-encoder ``.pth`` state dicts. These
functions turn them into the flax-layout numpy trees that the JAX trainer
writes, so ``utils/jax_bridge.params_from_jax`` / ``encoder_from_jax`` /
``dpt_params_from_jax`` load them unchanged. Every tensor becomes a numpy
array at once. Layout conventions:
  Linear  weight [out, in]        -> kernel [in, out]      (transpose)
  Conv2d  weight [out, in, kh, kw] -> kernel [kh, kw, in, out]
  BatchNorm weight/bias            -> scale/bias, running_* -> mean/var
  LSTM(+Cell) weight_ih [4H, in]   -> w_ih [in, 4H] (gate order preserved)
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a .pth/.ckpt file into {name: numpy array}.

    Handles the Omnidata layout: a dict with 'state_dict' whose keys carry a
    6-char prefix ('model.') that must be stripped. Entries that are not
    tensors are dropped.
    """
    try:  # prefer the safe loader; some Omnidata ckpts need full unpickling
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = {k[6:]: v for k, v in ckpt["state_dict"].items()}
    out = {}
    for k, v in ckpt.items():
        if hasattr(v, "detach"):
            out[k] = v.detach().cpu().numpy()
    return out


def _t(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.T)


def _conv(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.transpose(2, 3, 1, 0))


# --------------------------------------------------------------------------
# ResNet backbone
# --------------------------------------------------------------------------

_SEQ_TO_NAME = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
                "6": "layer3", "7": "layer4"}


def _canonicalize_resnet_keys(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Accept either torchvision names (conv1., layer1.0.) or the
    reference's Sequential-wrapped names (backbone.0., backbone.4.0.)
    produced by ``nn.Sequential(*list(resnet.children())[:-1])``
    (reference: base_caption_models.py:29-30)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("backbone."):
            k = k[len("backbone."):]
            head, rest = k.split(".", 1)
            if head in _SEQ_TO_NAME:
                k = _SEQ_TO_NAME[head] + "." + rest
            else:
                continue  # avgpool etc. have no params
        out[k] = v
    return out if out else dict(sd)


def resnet_to_flax(sd: Dict[str, np.ndarray],
                   layers=(3, 8, 36, 3)) -> Dict[str, Any]:
    """torchvision ResNet state dict -> ResNetBackbone variables
    {'params': ..., 'batch_stats': ...} (models/resnet.py naming)."""
    sd = _canonicalize_resnet_keys(sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def bn(dst: str, src: str):
        params[dst] = {"scale": sd[f"{src}.weight"],
                       "bias": sd[f"{src}.bias"]}
        stats[dst] = {"mean": sd[f"{src}.running_mean"],
                      "var": sd[f"{src}.running_var"]}

    params["conv1"] = {"kernel": _conv(sd["conv1.weight"])}
    bn("bn1", "bn1")
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            src = f"layer{stage + 1}.{b}"
            dst = f"layer{stage + 1}_{b}"
            blk_p: Dict[str, Any] = {}
            blk_s: Dict[str, Any] = {}
            for ci in (1, 2, 3):
                blk_p[f"conv{ci}"] = {
                    "kernel": _conv(sd[f"{src}.conv{ci}.weight"])}
                blk_p[f"bn{ci}"] = {"scale": sd[f"{src}.bn{ci}.weight"],
                                    "bias": sd[f"{src}.bn{ci}.bias"]}
                blk_s[f"bn{ci}"] = {"mean": sd[f"{src}.bn{ci}.running_mean"],
                                    "var": sd[f"{src}.bn{ci}.running_var"]}
            if f"{src}.downsample.0.weight" in sd:
                blk_p["ds_conv"] = {
                    "kernel": _conv(sd[f"{src}.downsample.0.weight"])}
                blk_p["ds_bn"] = {"scale": sd[f"{src}.downsample.1.weight"],
                                  "bias": sd[f"{src}.downsample.1.bias"]}
                blk_s["ds_bn"] = {
                    "mean": sd[f"{src}.downsample.1.running_mean"],
                    "var": sd[f"{src}.downsample.1.running_var"]}
            params[dst] = blk_p
            stats[dst] = blk_s
    return {"params": params, "batch_stats": stats}


def encoder_to_flax(sd: Dict[str, np.ndarray], layers=(3, 8, 36, 3)
                    ) -> Dict[str, Any]:
    """Reference CNNEncoder_Atten .pth -> AttentionGridEncoder variables
    (the backbone nests under the 'backbone' submodule name)."""
    inner = resnet_to_flax(sd, layers)
    return {"params": {"backbone": inner["params"]},
            "batch_stats": {"backbone": inner["batch_stats"]}}


# --------------------------------------------------------------------------
# Attention decoder (soft / hard / CD_ / MD_ variants share names)
# --------------------------------------------------------------------------

def attention_decoder_to_flax(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Reference decoder state dict (base_caption_models.py:59-96 naming;
    identical in the depth variants) -> AttentionDecoder params."""
    return {
        "embed": sd["embed.weight"],
        "att_w_enc": _t(sd["attention.encoder_att.weight"]),
        "att_b_enc": sd["attention.encoder_att.bias"],
        "att_w_dec": _t(sd["attention.decoder_att.weight"]),
        "att_b_dec": sd["attention.decoder_att.bias"],
        "att_w_full": _t(sd["attention.full_att.weight"]),
        "att_b_full": sd["attention.full_att.bias"],
        "lstm_w_ih": _t(sd["decode_step.weight_ih"]),
        "lstm_w_hh": _t(sd["decode_step.weight_hh"]),
        "lstm_b_ih": sd["decode_step.bias_ih"],
        "lstm_b_hh": sd["decode_step.bias_hh"],
        "init_w": _t(sd["init_linear.weight"]),
        "init_b": sd["init_linear.bias"],
        "f_beta_w": _t(sd["f_beta.weight"]),
        "f_beta_b": sd["f_beta.bias"],
        "out_w": _t(sd["linear.weight"]),
        "out_b": sd["linear.bias"],
    }


# --------------------------------------------------------------------------
# NIC
# --------------------------------------------------------------------------

def nic_decoder_to_flax(sd: Dict[str, np.ndarray],
                        num_layers: int = 2) -> Dict[str, Any]:
    """Reference NIC_RNNDecoder state dict (nic.py:61-85) -> NICDecoder."""
    out = {"embed": sd["embed.weight"],
           "out_w": _t(sd["linear.weight"]),
           "out_b": sd["linear.bias"]}
    for li in range(num_layers):
        out[f"lstm{li}_w_ih"] = _t(sd[f"lstm.weight_ih_l{li}"])
        out[f"lstm{li}_w_hh"] = _t(sd[f"lstm.weight_hh_l{li}"])
        out[f"lstm{li}_b_ih"] = sd[f"lstm.bias_ih_l{li}"]
        out[f"lstm{li}_b_hh"] = sd[f"lstm.bias_hh_l{li}"]
    return out


def nic_encoder_linear_to_flax(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The trainable projection of NIC_CNNEncoder (nic.py:41)."""
    return {"linear": {"kernel": _t(sd["linear.weight"]),
                       "bias": sd["linear.bias"]}}


# --------------------------------------------------------------------------
# Depth encoders
# --------------------------------------------------------------------------

def depth_cnn_to_flax(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Reference Depth_CNN_endoder (depth_models.py:12-47) ->
    DepthCNNEncoder variables."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for ci in (1, 2, 3):
        params[f"conv{ci}"] = {"kernel": _conv(sd[f"conv{ci}.weight"]),
                               "bias": sd[f"conv{ci}.bias"]}
        params[f"bn{ci}"] = {"scale": sd[f"bn{ci}.weight"],
                             "bias": sd[f"bn{ci}.bias"]}
        stats[f"bn{ci}"] = {"mean": sd[f"bn{ci}.running_mean"],
                            "var": sd[f"bn{ci}.running_var"]}
    return {"params": params, "batch_stats": stats}


def depth_mlp_to_flax(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Reference Depth_MLP_endoder (depth_models.py:58-79)."""
    return {li: {"kernel": _t(sd[f"{li}.weight"]), "bias": sd[f"{li}.bias"]}
            for li in ("l1", "l2", "l3")}


# --------------------------------------------------------------------------
# DPT-hybrid (Omnidata checkpoint, backbone vitb_rn50_384)
# --------------------------------------------------------------------------

def dpt_to_flax(sd: Dict[str, np.ndarray],
                resnet_layers=(3, 4, 9), vit_blocks: int = 12
                ) -> Dict[str, Any]:
    """DPTDepthModel torch state dict -> models/dpt.DPTDepthModel variables.

    Key layout documented at models/dpt.py; torch source names follow the
    reference's vendored MiDaS modules (vit.py, blocks.py, dpt_depth.py).
    """
    p: Dict[str, Any] = {}
    pre = "pretrained.model."

    def lin(src):
        return {"kernel": _t(sd[src + ".weight"]), "bias": sd[src + ".bias"]}

    def conv(src, bias=True):
        out = {"kernel": _conv(sd[src + ".weight"])}
        if bias:
            out["bias"] = sd[src + ".bias"]
        return out

    def gn(src):
        return {"gn": {"scale": sd[src + ".weight"],
                       "bias": sd[src + ".bias"]}}

    def ln(src):
        return {"scale": sd[src + ".weight"], "bias": sd[src + ".bias"]}

    # hybrid ResNetV2 backbone
    rb = pre + "patch_embed.backbone."
    resnet: Dict[str, Any] = {
        "stem_conv": conv(rb + "stem.conv", bias=False),
        "stem_norm": gn(rb + "stem.norm"),
    }
    for si, blocks in enumerate(resnet_layers):
        for bi in range(blocks):
            src = f"{rb}stages.{si}.blocks.{bi}."
            blk: Dict[str, Any] = {}
            for ci in (1, 2, 3):
                blk[f"conv{ci}"] = conv(src + f"conv{ci}", bias=False)
                blk[f"norm{ci}"] = gn(src + f"norm{ci}")
            if src + "downsample.conv.weight" in sd:
                blk["ds_conv"] = conv(src + "downsample.conv", bias=False)
                blk["ds_norm"] = gn(src + "downsample.norm")
            resnet[f"stage{si}_{bi}"] = blk
    p["resnet"] = resnet

    # patch projection + tokens
    p["patch_proj"] = conv(pre + "patch_embed.proj")
    p["cls_token"] = sd[pre + "cls_token"]
    p["pos_embed"] = sd[pre + "pos_embed"]

    # transformer blocks
    for i in range(vit_blocks):
        src = f"{pre}blocks.{i}."
        p[f"block{i}"] = {
            "norm1": ln(src + "norm1"),
            "qkv": lin(src + "attn.qkv"),
            "proj": lin(src + "attn.proj"),
            "norm2": ln(src + "norm2"),
            "fc1": lin(src + "mlp.fc1"),
            "fc2": lin(src + "mlp.fc2"),
        }

    # reassembly (act_postprocess3/4; 1/2 are identity taps for rn50 hybrid)
    p["pp3_readout"] = {"project": lin("pretrained.act_postprocess3.0.project.0")}
    p["pp3_conv"] = conv("pretrained.act_postprocess3.3")
    p["pp4_readout"] = {"project": lin("pretrained.act_postprocess4.0.project.0")}
    p["pp4_conv"] = conv("pretrained.act_postprocess4.3")
    p["pp4_down"] = conv("pretrained.act_postprocess4.4")

    # scratch convs + fusion blocks
    for i in range(1, 5):
        p[f"layer{i}_rn"] = conv(f"scratch.layer{i}_rn", bias=False)
        src = f"scratch.refinenet{i}."
        blk = {"out_conv": conv(src + "out_conv"),
               "res2": {"conv1": conv(src + "resConfUnit2.conv1"),
                        "conv2": conv(src + "resConfUnit2.conv2")}}
        # res1 exists in every block but is only used when a skip is passed
        # (refinenet4 takes no skip, dpt_depth.py:78)
        blk["res1"] = {"conv1": conv(src + "resConfUnit1.conv1"),
                       "conv2": conv(src + "resConfUnit1.conv2")}
        p[f"refinenet{i}"] = blk

    # head
    p["head_conv1"] = conv("scratch.output_conv.0")
    p["head_conv2"] = conv("scratch.output_conv.2")
    p["head_conv3"] = conv("scratch.output_conv.4")
    return {"params": p}
