"""Component checkpoints in the JAX package's file format (counterpart of
``save_component`` / ``load_component`` of the JAX ``utils/checkpoint.py``).

The JAX trainer writes each component of a run (encoder, decoder, NIC's
``enc_linear``, the depth encoder's ``{"params", "batch_stats"}`` bundle)
as one flax msgpack file, under the reference's ``.pth`` basenames with
``.msgpack`` appended (``ConfigEval``'s ``*_parameter_files`` tables). This
module reads and writes those files with ``msgpack_codec``: the trees are
nested dicts of numpy arrays, and ``utils/jax_bridge.params_from_jax``
checks their structure when it loads them into the port's modules.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from depth_image_captioning_pub_torch.utils.msgpack_codec import (
    packb, unpackb)

PTH_BRIDGE_ITEM = "ROADMAP.md, Queue A item 12: the reference .pth bridge"


def _state_dict(tree: Any) -> Any:
    """The tree the JAX ``save_component`` writes: dicts in sorted key
    order (its ``tree_map`` sorts them), str keys, lists as maps keyed "0",
    "1", ... (flax's ``to_state_dict``), leaves as numpy arrays."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return None if tree is None else np.asanyarray(tree)


def save_component(path: str, tree: Any) -> str:
    """Write ``tree`` to <path>.msgpack (appended to any ``.pth`` name);
    returns the path written."""
    if not path.endswith(".msgpack"):
        path = path + ".msgpack"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(packb(_state_dict(tree)))
    return path


def load_component(path: str) -> Any:
    """The tree that ``save_component`` (this one or the JAX package's)
    wrote to <path>.msgpack. A reference PyTorch file at ``path`` with no
    msgpack twin raises: its bridge is not ported yet."""
    mp = path if path.endswith(".msgpack") else path + ".msgpack"
    if os.path.exists(mp):
        with open(mp, "rb") as f:
            return unpackb(f.read())
    if os.path.exists(path) and path.endswith((".pth", ".ckpt", ".pt")):
        raise ValueError(f"{path} is a PyTorch checkpoint of the reference; "
                         f"reading it is not ported yet ({PTH_BRIDGE_ITEM})")
    raise FileNotFoundError(mp)
