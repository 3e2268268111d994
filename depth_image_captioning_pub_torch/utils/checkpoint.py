"""Checkpoints (counterpart of the JAX ``utils/checkpoint.py``).

Component checkpoints (``save_component`` / ``load_component``) are in the
JAX package's file format. The JAX trainer writes each component of a run (encoder, decoder, NIC's
``enc_linear``, the depth encoder's ``{"params", "batch_stats"}`` bundle)
as one flax msgpack file, under the reference's ``.pth`` basenames with
``.msgpack`` appended (``ConfigEval``'s ``*_parameter_files`` tables). This
module reads and writes those files with ``msgpack_codec``: the trees are
nested dicts of numpy arrays, and ``utils/jax_bridge.params_from_jax``
checks their structure when it loads them into the port's modules.

Full-state train checkpoints (``TrainCheckpointer``), in a format of the
port's own (the JAX trainer's are orbax directories, which the port does
not read): one ``torch.save`` file of CPU tensors and Python values per
step, written under a temporary name and renamed into place.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from depth_image_captioning_pub_torch.utils.msgpack_codec import (
    packb, unpackb)


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
    msgpack twin raises: ``cli.load_eval_components`` reads such files
    through ``utils/torch_bridge``, and ``utils/convert`` turns them into
    msgpack files."""
    mp = path if path.endswith(".msgpack") else path + ".msgpack"
    if os.path.exists(mp):
        with open(mp, "rb") as f:
            return unpackb(f.read())
    if os.path.exists(path) and path.endswith((".pth", ".ckpt", ".pt")):
        raise ValueError(
            f"{path} is a PyTorch checkpoint: read it with cli."
            f"load_eval_components or convert it with utils.convert "
            f"(utils/torch_bridge)")
    raise FileNotFoundError(mp)


def host_copy(tree: Any) -> Any:
    """``tree`` with every tensor copied to host memory (a real copy, also
    of a CPU tensor), dicts and lists rebuilt, other values kept."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


class TrainCheckpointer:
    """Full-train-state checkpoints for resuming a run: ``state_{step}.pt``
    files under ``directory``.

    ``save`` snapshots the state into host memory before it returns (the
    next step updates the parameters in place); with ``async_save`` one
    background thread writes it, so the loop blocks only on a previous
    write still in flight. A file is written under a temporary name and
    ``os.replace``d into place, so a write cut short never becomes
    ``latest_step``. ``keep`` > 0 keeps only the newest ``keep`` steps,
    pruned after a completed write. ``wait`` drains the write in flight
    (and re-raises its error); ``latest_step`` and ``restore`` drain
    first.
    """

    SUFFIX = ".pt"

    def __init__(self, directory: str, async_save: bool = False,
                 keep: int = 0):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self._executor = (ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-save")
            if async_save else None)
        self._pending = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"state_{step}{self.SUFFIX}")

    def _steps(self) -> list:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("state_") and name.endswith(self.SUFFIX):
                num = name[len("state_"):-len(self.SUFFIX)]
                if num.isdigit():
                    steps.append(int(num))
        return steps

    def _write(self, step: int, host_state: Any) -> None:
        path = self._path(step)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(host_state, tmp)
        os.replace(tmp, path)
        if self.keep:
            for old in sorted(self._steps())[:-self.keep]:
                os.remove(self._path(old))

    def save(self, step: int, state: Any) -> None:
        host = host_copy(state)
        if self._executor is None:
            self._write(step, host)
            return
        self.wait()                       # at most one write in flight
        self._pending = self._executor.submit(self._write, step, host)

    def wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self._steps()
        return max(steps) if steps else None

    def restore(self, step: int) -> Any:
        """The state saved at ``step``, its tensors on the CPU."""
        self.wait()
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def close(self) -> None:
        """Drain the write in flight and stop the writer thread."""
        try:
            self.wait()
        finally:
            if self._executor is not None:
                self._executor.shutdown()
