"""Load the JAX package's parameter trees into the port.

The inverse direction of the JAX package's ``utils/torch_bridge.py``. The
input is what the JAX ``Captioner.init`` returns (or a checkpoint holds),
``(trainable, frozen, batch_stats)``, with every leaf a numpy array:

  trainable["decoder"][name]                    decoder params, [in, out]
  trainable["depth_encoder"]                    depth CNN convs and BN
                                                scale/bias (depth kinds),
                                                or the depth MLP's Dense
                                                l1/l2/l3 kernels and biases
                                                (mdepth kinds)
  batch_stats                                   depth CNN BN mean/var ({}
                                                for the MLP, which has none)
  frozen["encoder"]["params"]["backbone"]       conv kernels HWIO, BN
                                                scale/bias
  frozen["encoder"]["batch_stats"]["backbone"]  BN mean/var
  frozen["dpt"]["params"]                       the DPT (JAX
                                                ``make_caption_fn``'s frozen
                                                tree), loaded separately by
                                                ``dpt_params_from_jax``

For NIC, ``trainable`` holds ``"enc_linear"`` ({"linear": {kernel, bias}},
the projection) and ``"decoder"``, and ``frozen["encoder"]`` is the
backbone's own ``{"params", "batch_stats"}``, without the ``"backbone"``
level of the attention kinds' grid encoder.

Layout rules (``flax_state_dict``): conv kernels go HWIO -> OIHW, Dense
kernels [in, out] -> ``nn.Linear``'s [out, in]; ``scale`` (BatchNorm,
GroupNorm, LayerNorm) becomes ``weight``, ``mean``/``var`` become
``running_mean``/``running_var``; other leaves (the DPT's ``cls_token`` and
``pos_embed``) keep their names. Decoder params keep their names and
layout. The flax module names are the port's module names, and loading is
strict: a missing or extra tensor raises. ``params_to_jax`` is the inverse:
the port's parameters back to the three trees, every leaf float32 (the
JAX package's parameter dtype; bf16 conv weights convert exactly). A
bfloat16 leaf read from a checkpoint (``msgpack_codec.BFloat16Bits``)
loads bit for bit.

``save_npz``/``load_npz`` keep the three trees in one ``.npz`` file, keys
being the tree paths joined with ``/`` under ``trainable/``, ``frozen/``
and ``batch_stats/``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from depth_image_captioning_pub_torch.utils.msgpack_codec import (
    BFloat16Bits, bf16_tensor)

Tree = Dict[str, Any]

_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}
_STATS = {"running_mean": "mean", "running_var": "var"}


def _leaf(val) -> np.ndarray:
    """A tree leaf as numpy; bfloat16 bits as their float32 values."""
    if isinstance(val, BFloat16Bits):
        return bf16_tensor(val).float().numpy()
    return np.asarray(val)


def _kernel_leaf(kernel) -> np.ndarray:
    """flax conv (HWIO) or Dense ([in, out]) kernel -> torch layout."""
    k = _leaf(kernel)
    k = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
    return np.ascontiguousarray(k)


def flax_state_dict(params: Tree, stats: Optional[Tree] = None,
                    prefix: str = "") -> Dict[str, np.ndarray]:
    """A flax params tree (and its batch_stats twin) -> a torch state dict
    of the module with the same submodule names."""
    def join(name: str) -> str:
        return f"{prefix}.{name}" if prefix else name

    stats = stats or {}
    out: Dict[str, np.ndarray] = {}
    for tree in (params, stats):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                if tree is params:
                    out.update(flax_state_dict(val, stats.get(key),
                                               join(key)))
            elif key == "kernel":
                out[join("weight")] = _kernel_leaf(val)
            else:
                out[join(_RENAME.get(key, key))] = _leaf(val)
    return out


def encoder_state_dict(enc_vars: Tree) -> Dict[str, np.ndarray]:
    """flax AttentionGridEncoder variables -> the port's encoder state."""
    return flax_state_dict(enc_vars["params"]["backbone"],
                           enc_vars["batch_stats"]["backbone"], "backbone")


def _load(module: torch.nn.Module, arrays: Dict[str, np.ndarray]) -> None:
    module.load_state_dict(
        {k: torch.from_numpy(np.array(_leaf(v), dtype=np.float32))
         for k, v in arrays.items()}, strict=True)


def _check_keys(name: str, tree: Tree, allowed) -> None:
    extra = set(tree) - set(allowed)
    if extra:
        raise KeyError(f"{name} has trees the port does not load: "
                       f"{sorted(extra)}")


def encoder_from_jax(cap, enc_vars: Tree) -> None:
    """Copy the flax frozen RGB encoder tree ``frozen["encoder"]`` (NIC:
    the backbone's own ``{"params", "batch_stats"}``) into ``cap``."""
    if cap.spec.is_nic:
        _load(cap.backbone, flax_state_dict(enc_vars["params"],
                                            enc_vars["batch_stats"]))
    else:
        _load(cap.encoder, encoder_state_dict(enc_vars))


def params_from_jax(cap, trainable: Tree, frozen: Tree,
                    batch_stats: Optional[Tree] = None,
                    load_encoder: bool = True) -> None:
    """Copy the JAX package's (trainable, frozen, batch_stats) trees into
    ``cap`` (a port ``Captioner``), casting to each parameter's dtype and
    device. ``frozen["dpt"]``, where present, is left to
    ``dpt_params_from_jax``. ``load_encoder=False`` leaves the frozen
    encoder on the card as it is (a caller that knows it holds
    ``frozen["encoder"]`` already)."""
    depth = cap.depth_module
    _check_keys("frozen", frozen, ("encoder", "dpt"))
    if load_encoder:
        encoder_from_jax(cap, frozen["encoder"])
    if cap.spec.is_nic:
        _check_keys("trainable", trainable, ("enc_linear", "decoder"))
        _load(cap.projection, flax_state_dict(trainable["enc_linear"]))
        _load(cap.decoder, dict(trainable["decoder"]))
        return
    _check_keys("trainable", trainable,
                ("decoder",) + (("depth_encoder",) if depth is not None
                                else ()))
    _load(cap.decoder, dict(trainable["decoder"]))
    if depth is not None:
        if cap.spec.depth_encoder == "mlp" and batch_stats:
            raise KeyError(f"the depth MLP has no batch statistics, got "
                           f"{sorted(batch_stats)}")
        _load(depth, flax_state_dict(trainable["depth_encoder"],
                                     batch_stats))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def flax_trees(module: torch.nn.Module) -> Tuple[Tree, Tree]:
    """The inverse of ``flax_state_dict``: a module's state -> (params,
    batch_stats) flax trees, float32."""
    params: Tree = {}
    stats: Tree = {}
    for key, val in module.state_dict().items():
        *path, name = key.split(".")
        arr = _numpy(val)
        tree = params
        if name in _STATS:
            tree, name = stats, _STATS[name]
        elif name == "weight" and arr.ndim == 1:
            name = "scale"
        elif name == "weight":
            arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0)
                                       if arr.ndim == 4 else arr.T)
            name = "kernel"
        for part in path:
            tree = tree.setdefault(part, {})
        tree[name] = arr
    return params, stats


def params_to_jax(cap) -> Tuple[Tree, Tree, Tree]:
    """``cap``'s parameters as the JAX package's (trainable, frozen,
    batch_stats) trees: the inverse of ``params_from_jax``."""
    decoder = {k: _numpy(v) for k, v in cap.decoder.state_dict().items()}
    if cap.spec.is_nic:
        enc_params, enc_stats = flax_trees(cap.backbone)
        trainable = {"enc_linear": flax_trees(cap.projection)[0],
                     "decoder": decoder}
        return (trainable, {"encoder": {"params": enc_params,
                                        "batch_stats": enc_stats}}, {})
    enc_params, enc_stats = flax_trees(cap.encoder)
    frozen = {"encoder": {"params": enc_params, "batch_stats": enc_stats}}
    trainable: Tree = {"decoder": decoder}
    batch_stats: Tree = {}
    if cap.depth_module is not None:
        trainable["depth_encoder"], batch_stats = flax_trees(
            cap.depth_module)
    return trainable, frozen, batch_stats


def dpt_params_from_jax(dpt, dpt_variables: Tree) -> None:
    """Copy a flax DPT variables tree ({"params": ...}) into ``dpt`` (a
    ``DPTDepthEstimator`` or its ``DPTDepthModel``)."""
    _check_keys("DPT variables", dpt_variables, ("params",))
    _load(getattr(dpt, "model", dpt),
          flax_state_dict(dpt_variables["params"]))


def flatten_tree(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(flatten_tree(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Tree:
    tree: Tree = {}
    for path, val in flat.items():
        node = tree
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = val
    return tree


def save_npz(path: str, trainable: Tree, frozen: Tree,
             batch_stats: Optional[Tree] = None) -> None:
    np.savez(path, **flatten_tree({"trainable": trainable, "frozen": frozen,
                                   "batch_stats": batch_stats or {}}))


def load_npz(path: str) -> Tuple[Tree, Tree, Tree]:
    """(trainable, frozen, batch_stats); batch_stats is {} when the file
    has none."""
    with np.load(path) as data:
        tree = unflatten_tree({k: data[k] for k in data.files})
    return tree["trainable"], tree["frozen"], tree.get("batch_stats", {})
