"""Precomputed depth-map cache (counterpart of the JAX
``engine/depth_cache.py``).

The DPT's standardized 224x224 depth maps of a whole train set, computed
once and keyed by dataset index: a float16 ``.npy`` memmap [N, 224, 224, 1]
plus a ``.json`` sidecar ``{"shape": [...], "complete": true}``, the JAX
package's layout, so either package reads the other's file. Training
epochs then read depth maps from the memmap with no DPT work; validation
computes them per batch (``online_depth_provider``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable

import numpy as np
import torch


class DepthMapCache:
    """float16 [N, 224, 224, 1] memmap + metadata sidecar."""

    def __init__(self, path: str, num_images: int, hw=(224, 224)):
        self.path = path
        self.meta_path = path + ".json"
        self.num_images = num_images
        self.hw = hw
        self.shape = (num_images, hw[0], hw[1], 1)

    def exists(self) -> bool:
        if not (os.path.exists(self.path) and os.path.exists(self.meta_path)):
            return False
        with open(self.meta_path) as f:
            meta = json.load(f)
        return tuple(meta["shape"]) == self.shape and bool(
            meta.get("complete"))

    def build(self, dataset, depth_fn: Callable, device,
              batch_size: int = 32, quiet: bool = False) -> float:
        """Run ``depth_fn(images)`` (uint8 NHWC on ``device`` -> [B, 224,
        224, 1] maps, e.g. ``cli.make_depth_fn``'s, K5 on the card) over
        the dataset in batches of ``batch_size``; the last batch is padded
        with repeats of its first image, as the JAX package pads it.
        Returns the seconds taken."""
        t0 = time.perf_counter()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        mm = np.lib.format.open_memmap(self.path, mode="w+",
                                       dtype=np.float16, shape=self.shape)
        n = len(dataset)
        for start in range(0, n, batch_size):
            idx = list(range(start, min(start + batch_size, n)))
            imgs = np.stack([dataset.load_image(i) for i in idx])
            if len(idx) < batch_size:
                pad = batch_size - len(idx)
                imgs = np.concatenate([imgs, imgs[:1].repeat(pad, 0)])
            maps = depth_fn(torch.from_numpy(imgs).to(device))
            mm[idx[0]: idx[-1] + 1] = maps[: len(idx)].to(
                torch.float16).cpu().numpy()
            if not quiet and (start // batch_size) % 10 == 0:
                print(f"depth cache: {start + len(idx)}/{n}")
        mm.flush()
        with open(self.meta_path, "w") as f:
            json.dump({"shape": list(self.shape), "complete": True}, f)
        return time.perf_counter() - t0

    def open(self) -> np.ndarray:
        return np.load(self.path, mmap_mode="r")


def cached_depth_provider(cache: DepthMapCache) -> Callable:
    """(images, indices) -> the cached f32 maps of the batch's dataset
    indices (numpy), the train loop's depth-provider contract."""
    mm = cache.open()

    def provider(images, indices):
        return np.asarray(mm[np.asarray(indices)], dtype=np.float32)

    return provider


def online_depth_provider(depth_fn: Callable, device) -> Callable:
    """(images, indices) -> ``depth_fn``'s maps of the batch's uint8
    images, computed on ``device`` per batch (validation, and training
    without a cache). The maps stay on the device, as a tensor autograd
    may read."""

    def provider(images: np.ndarray, indices=None) -> torch.Tensor:
        maps = depth_fn(torch.from_numpy(np.ascontiguousarray(images))
                        .to(device))
        return maps.clone()   # out of inference mode

    return provider
