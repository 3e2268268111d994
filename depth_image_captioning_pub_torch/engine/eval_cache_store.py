"""Disk store of the eval set cache (counterpart of the JAX
``engine/eval_cache_store.py``).

``engine/evaluate.evaluate`` keeps, within one run, the frozen stages'
outputs of checkpoint set 1 (RGB features, DPT depth maps, NIC's pooled
features) and replays them for the sets after it. This module writes them
to disk so that later runs replay them too: no image decode, no ResNet,
no DPT, also with ``--num-sets 1``.

Exactness: each tensor's bytes go to disk as they are, raw and in the
machine's (little-endian) order, with a dtype tag (bf16 as its 2-byte
words, tag ``"bfloat16"``; ``engine/feature_cache.tensor_bytes``), never
cast. An entry is keyed by two digests that must both match:

- ``data_key``: each image's path, size and mtime, its reference captions,
  the batch and pad sizes and the image size: a make-style check of the
  dataset and its batching;
- ``model_key``: digests of the frozen encoder's tree (as the checkpoint
  loader gives it) and of the DPT's ``state_dict``, and the knobs that
  shape the frozen outputs (encoder dtype, grid size, the DPT's input
  side, GELU and head, the kind).

Any mismatch or damage is a miss, and the run fills the store again.
Writes go to a temporary directory that ``os.replace`` renames into
place, so an interrupted fill never leaves a readable half entry.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from depth_image_captioning_pub_torch.engine.feature_cache import (
    dtype_name, from_bytes, hash_state_dict, storage_dtype, tensor_bytes)
from depth_image_captioning_pub_torch.utils.jax_bridge import flatten_tree

FORMAT_VERSION = 1


def _hash_tree(h, tree) -> None:
    """Feed a (nested dict) tree's sorted paths, shapes, dtypes and bytes
    into ``h``."""
    flat = flatten_tree(tree)
    for path in sorted(flat):
        arr = np.ascontiguousarray(flat[path])
        h.update(f"{path}|{arr.shape}|{arr.dtype}|".encode())
        h.update(arr.tobytes())


def model_key(frozen_enc, dpt_state_dict, encoder_dtype: torch.dtype, cfg,
              kind: str) -> str:
    """Digest of everything on the frozen side that shapes cached values:
    the set's frozen encoder tree, the DPT's state dict (None without a
    DPT) and the knobs."""
    h = hashlib.blake2b(digest_size=16)
    h.update(f"v{FORMAT_VERSION}|{kind}|{dtype_name(encoder_dtype)}|"
             f"{int(getattr(cfg, 'enc_img_size', 14))}|"
             f"{int(getattr(cfg, 'dpt_image_size', 384))}|"
             f"gelu={getattr(cfg, 'dpt_gelu', 'erf')}|"
             f"head={getattr(cfg, 'dpt_head', 'full')}".encode())
    _hash_tree(h, frozen_enc)
    if dpt_state_dict is not None:
        hash_state_dict(h, dpt_state_dict)
    return h.hexdigest()


def data_key(dataset, batch_size: int, pad_to: int) -> Optional[str]:
    """Digest of the dataset and its batching, or None when the dataset
    has no image paths to fingerprint (then the disk store stays off)."""
    base = getattr(dataset, "dataset", dataset)
    if not hasattr(base, "image_path"):
        return None
    indices = getattr(dataset, "indices", range(len(dataset)))
    h = hashlib.blake2b(digest_size=16)
    h.update(f"v{FORMAT_VERSION}|b{batch_size}|p{pad_to}|"
             f"hw{getattr(base, 'image_size', None)}".encode())
    for i in indices:
        path = base.image_path(i)
        try:
            st = os.stat(path)
        except OSError:
            return None
        h.update(path.encode())
        h.update(f"|{st.st_size}|{st.st_mtime_ns}|".encode())
        for c in base.captions(i):
            h.update(c.encode())
        h.update(b";")
    return h.hexdigest()


def _entry_dir(root: str, dkey: str, mkey: str) -> str:
    return os.path.join(root, f"{dkey[:16]}-{mkey[:16]}")


def save(root: str, dkey: str, mkey: str, set_cache: Dict[str, Any],
         quiet: bool = False) -> None:
    """Persist a filled set cache ({"entries": [(tensors by name, n_valid),
    ...], "refs": [...]}) under ``root``, atomically."""
    final = _entry_dir(root, dkey, mkey)
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".fill-", dir=root)
    try:
        manifest: Dict[str, Any] = {
            "version": FORMAT_VERSION, "data_key": dkey, "model_key": mkey,
            "entries": [], "refs": [list(r) for r in set_cache["refs"]],
        }
        for ei, (aux, n_valid) in enumerate(set_cache["entries"]):
            arrays: Dict[str, Any] = {}
            for name, val in aux.items():
                if val is None:
                    arrays[name] = None
                    continue
                fname = f"e{ei}_{name}.bin"
                with open(os.path.join(tmp, fname), "wb") as f:
                    f.write(tensor_bytes(val).tobytes())
                arrays[name] = {"file": fname, "shape": list(val.shape),
                                "dtype": dtype_name(val.dtype)}
            manifest["entries"].append({"n_valid": int(n_valid),
                                        "arrays": arrays})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(final):    # a concurrent fill won the race
            shutil.rmtree(tmp)
            return
        os.replace(tmp, final)
        if not quiet:
            print(f"eval cache: saved {len(manifest['entries'])} batches "
                  f"to {final}")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load(root: str, dkey: str, mkey: str, device,
         quiet: bool = False) -> Optional[Dict[str, Any]]:
    """A persisted set cache with its tensors on ``device``; None on any
    miss, mismatch or damage."""
    d = _entry_dir(root, dkey, mkey)
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if (manifest.get("version") != FORMAT_VERSION
                or manifest.get("data_key") != dkey
                or manifest.get("model_key") != mkey):
            return None
        entries: List[Tuple[Dict[str, Any], int]] = []
        for ent in manifest["entries"]:
            aux: Dict[str, Any] = {}
            for name, spec in ent["arrays"].items():
                if spec is None:
                    aux[name] = None
                    continue
                with open(os.path.join(d, spec["file"]), "rb") as f:
                    raw = f.read()
                arr = np.frombuffer(raw, dtype=storage_dtype(
                    spec["dtype"])).reshape(spec["shape"])
                aux[name] = from_bytes(arr, spec["dtype"]).to(device)
            entries.append((aux, int(ent["n_valid"])))
        if not quiet:
            print(f"eval cache: loaded {len(entries)} batches from {d} "
                  f"(frozen stages skipped)")
        return {"entries": entries,
                "refs": [list(r) for r in manifest["refs"]]}
    except (OSError, ValueError, KeyError, TypeError,
            json.JSONDecodeError):
        return None
