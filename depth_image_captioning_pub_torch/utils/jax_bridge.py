"""Load the JAX package's parameter trees into the port.

The inverse direction of the JAX package's ``utils/torch_bridge.py``. The
input is the ``(trainable, frozen)`` pair that the JAX ``Captioner.init``
returns (or a checkpoint holds), with every leaf a numpy array:

  trainable["decoder"][name]                    decoder params, [in, out]
  frozen["encoder"]["params"]["backbone"]       conv kernels HWIO, BN
                                                scale/bias
  frozen["encoder"]["batch_stats"]["backbone"]  BN mean/var

Layout rules: conv kernels go HWIO -> OIHW; BN ``scale``/``bias`` and
``mean``/``var`` become ``weight``/``bias``/``running_mean``/
``running_var``; decoder params keep their names and layout. The flax
module names (``conv1``, ``bn1``, ``layer{s}_{b}/conv{1,2,3}``,
``bn{1,2,3}``, ``ds_conv``, ``ds_bn``) are the port's module names, and
loading is strict: a missing or extra tensor raises.

``save_npz``/``load_npz`` keep the pair in one ``.npz`` file, keys being
the tree paths joined with ``/`` under ``trainable/`` and ``frozen/``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]


def _conv_leaf(kernel) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(kernel).transpose(3, 2, 0, 1))


def encoder_state_dict(enc_vars: Tree) -> Dict[str, np.ndarray]:
    """flax AttentionGridEncoder variables -> the port's encoder state."""
    params = enc_vars["params"]["backbone"]
    stats = enc_vars["batch_stats"]["backbone"]
    out: Dict[str, np.ndarray] = {}

    def leaf(prefix: str, p: Tree, s: Tree) -> None:
        if "kernel" in p:
            out[f"{prefix}.weight"] = _conv_leaf(p["kernel"])
            return
        out[f"{prefix}.weight"] = np.asarray(p["scale"])
        out[f"{prefix}.bias"] = np.asarray(p["bias"])
        out[f"{prefix}.running_mean"] = np.asarray(s["mean"])
        out[f"{prefix}.running_var"] = np.asarray(s["var"])

    for name, mod in params.items():
        if name.startswith("layer"):
            for sub, p in mod.items():
                leaf(f"backbone.{name}.{sub}", p, stats[name].get(sub, {}))
        else:
            leaf(f"backbone.{name}", mod, stats.get(name, {}))
    return out


def _load(module: torch.nn.Module, arrays: Dict[str, np.ndarray]) -> None:
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v, dtype=np.float32))
         for k, v in arrays.items()}, strict=True)


def params_from_jax(cap, trainable: Tree, frozen: Tree) -> None:
    """Copy the JAX package's (trainable, frozen) trees into ``cap`` (a
    port ``Captioner``), casting to each parameter's dtype and device."""
    _load(cap.encoder, encoder_state_dict(frozen["encoder"]))
    _load(cap.decoder, dict(trainable["decoder"]))


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


def save_npz(path: str, trainable: Tree, frozen: Tree) -> None:
    np.savez(path, **flatten_tree({"trainable": trainable,
                                   "frozen": frozen}))


def load_npz(path: str) -> Tuple[Tree, Tree]:
    with np.load(path) as data:
        tree = unflatten_tree({k: data[k] for k in data.files})
    return tree["trainable"], tree["frozen"]
