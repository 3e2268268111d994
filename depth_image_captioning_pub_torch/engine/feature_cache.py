"""Train-time cache of the frozen encoder's features (counterpart of the
JAX ``engine/feature_cache.py``).

The RGB encoder is frozen, yet an online step runs it on every image of
every epoch. With the cache the encoder runs once per image, into a raw
memmap on disk, and every epoch (the first included) trains from the
cached features: the step skips the whole conv stack.

What is cached per dataset index (``steps.frozen_features``):

* attention kinds: the [196, 2048] grid in the encoder's dtype (bf16 by
  default: 802,816 bytes an image);
* NIC: the [2048] pooled backbone output; its trainable projection stays
  in the step.

The bytes are the encoder's own output, never cast: bf16 is stored as its
raw 2-byte words (``tensor.view(torch.int16)`` <-> ``np.uint16``, dtype tag
``"bfloat16"``; no numpy bf16 type is needed), so every epoch, rerun and
resume replays bit-identical values. The file layout is the JAX
package's: the raw rows in index order, and a JSON sidecar with the shape,
the dtype name, the digest and ``complete`` (an interrupted build is a
miss). ``frozen_digest`` is a blake2b of the frozen module's
``state_dict`` (sorted keys; each tensor's name, shape, dtype and bytes),
the dtype and the feature shape, so another checkpoint, seed or backbone
builds its own file instead of replaying stale features.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from depth_image_captioning_pub_torch.data.pipeline import _load_chunk

BF16 = "bfloat16"


def dtype_name(dtype: torch.dtype) -> str:
    """The sidecar's dtype tag (numpy's names; ``"bfloat16"``)."""
    return str(dtype).replace("torch.", "")


def storage_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a tag's bytes (bf16 as uint16 words)."""
    return np.dtype(np.uint16) if name == BF16 else np.dtype(name)


def tensor_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's exact bytes as a host array of ``storage_dtype``."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_bytes(arr: np.ndarray, name: str) -> torch.Tensor:
    """The inverse of ``tensor_bytes``: a CPU tensor of dtype tag
    ``name``."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:     # np.frombuffer of a file's bytes
        arr = arr.copy()
    if name == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def hash_state_dict(h, state_dict) -> None:
    """Feed a state dict's sorted names, shapes, dtypes and bytes into
    ``h``."""
    for name in sorted(state_dict):
        t = state_dict[name]
        h.update(f"{name}|{tuple(t.shape)}|{dtype_name(t.dtype)}|".encode())
        h.update(tensor_bytes(t).tobytes())


def frozen_digest(frozen: torch.nn.Module, dtype: torch.dtype,
                  feat_shape: Tuple[int, ...]) -> str:
    """Digest of everything that determines the cached values."""
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{dtype_name(dtype)}|{tuple(feat_shape)}".encode())
    hash_state_dict(h, frozen.state_dict())
    return h.hexdigest()


class FeatureCache:
    """Raw-bytes memmap of per-image frozen features + JSON sidecar."""

    def __init__(self, path: str, num_images: int,
                 feat_shape: Tuple[int, ...], dtype: torch.dtype,
                 digest: str):
        self.path = path
        self.meta_path = path + ".json"
        self.shape = (num_images, *feat_shape)
        self.dtype = dtype
        self.name = dtype_name(dtype)
        self.digest = digest

    def exists(self) -> bool:
        if not (os.path.exists(self.path) and os.path.exists(self.meta_path)):
            return False
        try:
            with open(self.meta_path) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        return (tuple(meta.get("shape", ())) == self.shape
                and meta.get("dtype") == self.name
                and meta.get("digest") == self.digest
                and bool(meta.get("complete")))

    def build(self, dataset, encode_fn: Callable[[torch.Tensor],
                                                 torch.Tensor],
              device, batch_size: int = 64, quiet: bool = False) -> None:
        """Run ``encode_fn(uint8 images on device) -> features`` under
        ``torch.inference_mode()`` over the dataset in chunks of
        ``batch_size``, decoding through ``_load_chunk`` (the loader of
        ``train_batches``); the last chunk is padded to the same shape with
        its first image. One frozen forward per image in all."""
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if os.path.exists(self.meta_path):
            os.remove(self.meta_path)     # a rebuild is incomplete until done
        mm = np.memmap(self.path, mode="w+", dtype=storage_dtype(self.name),
                       shape=self.shape)
        n = self.shape[0]
        with torch.inference_mode():
            for start in range(0, n, batch_size):
                idx = list(range(start, min(start + batch_size, n)))
                imgs = np.stack(_load_chunk(dataset, idx))
                if len(idx) < batch_size:
                    pad = batch_size - len(idx)
                    imgs = np.concatenate([imgs, imgs[:1].repeat(pad, 0)])
                feats = encode_fn(torch.from_numpy(imgs).to(device))
                if feats.dtype != self.dtype:
                    raise ValueError(f"the encoder gave {feats.dtype}, the "
                                     f"cache holds {self.dtype}")
                mm[idx[0]: idx[-1] + 1] = tensor_bytes(feats[: len(idx)])
                if not quiet and (start // batch_size) % 10 == 0:
                    print(f"feature cache: {start + len(idx)}/{n}")
        mm.flush()
        del mm
        with open(self.meta_path, "w") as f:
            json.dump({"shape": list(self.shape), "dtype": self.name,
                       "digest": self.digest, "complete": True}, f)

    def open(self) -> np.memmap:
        return np.memmap(self.path, mode="r", dtype=storage_dtype(self.name),
                         shape=self.shape)


def cached_feature_provider(cache: FeatureCache
                            ) -> Callable[[np.ndarray], torch.Tensor]:
    """(indices) -> the batch's features, a CPU tensor of the cache's
    dtype gathered from the memmap. Pad rows repeat real indices
    (``data/pipeline.make_train_batch``), so they fetch a real image's
    features and the loss mask drops them."""
    mm = cache.open()

    def provider(indices) -> torch.Tensor:
        return from_bytes(mm[np.asarray(indices)], cache.name)

    return provider


def build_or_open(cache_dir: str, split: str, dataset,
                  encode_fn: Callable[[torch.Tensor], torch.Tensor],
                  frozen: torch.nn.Module, feat_shape: Tuple[int, ...],
                  dtype: torch.dtype, device, batch_size: int = 64,
                  quiet: bool = False, digest: Optional[str] = None
                  ) -> Callable[[np.ndarray], torch.Tensor]:
    """Resolve one split's cache (``feat_{split}_{digest[:16]}.bin`` under
    ``cache_dir``), build it if it is missing or stale, and return its
    provider. ``digest``: ``frozen_digest``'s value where the caller has
    it (hashing ResNet-152's weights takes a few tenths of a second)."""
    digest = digest or frozen_digest(frozen, dtype, feat_shape)
    path = os.path.join(cache_dir, f"feat_{split}_{digest[:16]}.bin")
    cache = FeatureCache(path, len(dataset), feat_shape, dtype, digest)
    if not cache.exists():
        if not quiet:
            print(f"feature cache: building {split} "
                  f"({len(dataset)} images -> {path})")
        cache.build(dataset, encode_fn, device, batch_size=batch_size,
                    quiet=quiet)
    return cached_feature_provider(cache)
