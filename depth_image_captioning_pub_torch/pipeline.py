"""One-call inference API: uint8 image arrays in, caption strings out
(counterpart of the JAX ``pipeline.py``).

    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline

    cap = build_captioner("base-soft", len(word_to_id), device="cuda")
    cap.init(torch.Generator().manual_seed(0))      # or params_from_jax
    pipe = CaptionPipeline(cap, word_to_id, id_to_word,
                           batch_buckets=(1, 16, 64))
    pipe(images_uint8)                              # -> list of captions

A request is cut into chunks of the largest bucket, and each chunk is
padded (with repeats of its rows) to the smallest bucket that fits; padding
rows are dropped before detokenization, so captions do not depend on the
bucket. Chunk i+1 is dispatched before the host waits for chunk i's tokens.

Parameters live in the captioner's modules on its device. Loading from an
experiment directory, stochastic sampling, beam search, several devices
and hot reload wait for later slices (ROADMAP.md), as does decoding JPEG
paths: images are uint8 [H, W, 3] arrays at ``image_hw``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from depth_image_captioning_pub_tpu.data.tokenizer import (
    SPECIAL, ids_to_caption)
from depth_image_captioning_pub_torch.engine.evaluate import make_caption_fn


class CaptionPipeline:
    """Batched greedy captioning over one base-soft captioner."""

    def __init__(self, cap, word_to_id: Dict[str, int],
                 id_to_word: Dict[int, str], *, max_length: int = 30,
                 batch_buckets=(64,), image_hw=(224, 224)):
        self.cap = cap
        self.device = cap.device
        self.max_length = int(max_length)
        self.id_to_word = id_to_word
        self.batch_buckets = tuple(sorted({int(b) for b in batch_buckets}))
        if not self.batch_buckets or self.batch_buckets[0] < 1:
            raise ValueError(f"bad batch_buckets {batch_buckets}")
        self.batch_size = self.batch_buckets[-1]   # the chunk size
        self.image_hw = tuple(image_hw)
        self._fn = make_caption_fn(
            cap, start_id=word_to_id[SPECIAL.start],
            max_length=self.max_length, end_id=word_to_id.get(SPECIAL.end))

    def caption_tokens(self, arrays: np.ndarray) -> np.ndarray:
        """[N,H,W,3] uint8 -> [N, max_length] int32 token IDs."""
        arrays = np.asarray(arrays)
        if (arrays.dtype != np.uint8 or arrays.ndim != 4
                or arrays.shape[1:] != (*self.image_hw, 3)):
            raise ValueError(f"expected uint8 [N, {self.image_hw[0]}, "
                             f"{self.image_hw[1]}, 3] images, got "
                             f"{arrays.dtype} {arrays.shape}")
        pending = []          # (dispatched tokens, valid) one chunk ahead
        rows = [np.zeros((0, self.max_length), np.int32)]
        for lo in range(0, arrays.shape[0], self.batch_size):
            chunk = arrays[lo:lo + self.batch_size]
            valid = chunk.shape[0]
            bucket = next(b for b in self.batch_buckets if b >= valid)
            if valid < bucket:
                reps = np.zeros((bucket - valid,), np.int64)
                chunk = np.concatenate([chunk, chunk[reps]], axis=0)
            images = torch.from_numpy(np.ascontiguousarray(chunk))
            pending.append((self._fn(images.to(self.device)), valid))
            if len(pending) > 1:
                toks, v = pending.pop(0)
                rows.append(toks.cpu().numpy()[:v])
        for toks, v in pending:
            rows.append(toks.cpu().numpy()[:v])
        return np.concatenate(rows, axis=0)

    def __call__(self, images: Union[np.ndarray, Sequence[np.ndarray]]
                 ) -> Union[str, List[str]]:
        """One [H,W,3] uint8 image -> a caption; [N,H,W,3] or a list of
        images -> a list of captions."""
        single = isinstance(images, np.ndarray) and images.ndim == 3
        if single:
            batch = images[None]
        elif isinstance(images, np.ndarray):
            batch = images
        else:
            if any(isinstance(im, str) for im in images):
                raise TypeError("image paths are not supported yet: pass "
                                "uint8 arrays")
            batch = np.stack([np.asarray(im) for im in images])
        caps = [ids_to_caption(row, self.id_to_word)
                for row in self.caption_tokens(batch)]
        return caps[0] if single else caps
