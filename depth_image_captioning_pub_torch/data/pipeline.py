"""Fixed-shape batches and a background prefetcher (the port's own copy of
the JAX package's ``data/pipeline.py``): train batches (one of each
image's captions, tokenized and <null>-padded to a fixed length, with the
lengths beside them) and evaluation batches (images and their cleaned
reference strings).

Every batch has one shape: the last one is padded with repeated rows and
``pad_mask`` marks the repeats, which the losses leave out. Images stay
uint8 on the host; the device converts them. For the same seed, epoch and
``pad_to``, ``train_batches`` yields the JAX package's batches array for
array (the same ``random.Random`` draws in the same order).
"""

from __future__ import annotations

import queue as queue_mod
import random
import threading
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np

from depth_image_captioning_pub_torch.data.tokenizer import (
    SPECIAL, tokenize_caption, untokenize_caption)


class Batch(NamedTuple):
    """One fixed-shape training batch (NHWC images, padded captions)."""

    images: np.ndarray        # [B, H, W, 3] uint8
    captions: np.ndarray      # [B, L] int32, <null>-padded
    lengths: np.ndarray       # [B] int32 (includes <start> and <end>)
    pad_mask: np.ndarray      # [B] bool, False for repeated padding rows
    indices: np.ndarray = None  # [B] int32 dataset indices (depth-cache key)


def pad_captions(token_lists: Sequence[Sequence[int]], null_id: int,
                 max_len: int) -> "tuple[np.ndarray, np.ndarray]":
    """<null>-pad token lists to [B, max_len]; a longer caption is cut to
    max_len tokens that keep its final <end>."""
    bsz = len(token_lists)
    out = np.full((bsz, max_len), null_id, dtype=np.int32)
    lengths = np.zeros((bsz,), dtype=np.int32)
    for i, toks in enumerate(token_lists):
        toks = list(toks)
        if len(toks) > max_len:
            toks = toks[: max_len - 1] + [toks[-1]]
        out[i, : len(toks)] = toks
        lengths[i] = len(toks)
    return out, lengths


def make_train_batch(images: Sequence[np.ndarray],
                     caption_sets: Sequence[Sequence[str]],
                     word_to_id: Dict[str, int],
                     max_len: int,
                     rng: random.Random,
                     batch_size: Optional[int] = None,
                     indices: Optional[Sequence[int]] = None) -> Batch:
    """Pick one of each image's captions with ``rng``, tokenize, pad to
    ``max_len``, and pad the rows to ``batch_size`` with repeats."""
    tokens = [tokenize_caption(rng.choice(list(caps)), word_to_id)
              for caps in caption_sets]
    captions, lengths = pad_captions(tokens, word_to_id[SPECIAL.null], max_len)
    imgs = np.stack(images)
    n = imgs.shape[0]
    target = batch_size or n
    idx = np.asarray(list(indices) if indices is not None else range(n),
                     dtype=np.int32)
    pad_mask = np.ones((target,), dtype=bool)
    if n < target:
        reps = [i % n for i in range(n, target)]
        imgs = np.concatenate([imgs, imgs[reps]], axis=0)
        captions = np.concatenate([captions, captions[reps]], axis=0)
        lengths = np.concatenate([lengths, lengths[reps]], axis=0)
        idx = np.concatenate([idx, idx[reps]], axis=0)
        pad_mask[n:] = False
    return Batch(imgs, captions, lengths, pad_mask, idx)


class EvalBatch(NamedTuple):
    images: np.ndarray            # [B, H, W, 3]
    references: List[List[str]]   # per-image cleaned reference captions
    pad_mask: np.ndarray          # [B] bool, False for repeated padding rows


def make_eval_batch(images: Sequence[np.ndarray],
                    caption_sets: Sequence[Sequence[str]],
                    word_to_id: Dict[str, int],
                    batch_size: Optional[int] = None) -> EvalBatch:
    """Images and their cleaned reference strings, padded to
    ``batch_size`` rows."""
    refs = [[untokenize_caption(c, word_to_id) for c in caps]
            for caps in caption_sets]
    imgs = np.stack(images)
    n = imgs.shape[0]
    target = batch_size or n
    pad_mask = np.ones((target,), dtype=bool)
    if n < target:
        reps = [i % n for i in range(n, target)]
        imgs = np.concatenate([imgs, imgs[reps]], axis=0)
        pad_mask[n:] = False
    return EvalBatch(imgs, refs, pad_mask)


def generate_subset(dataset, ratio: float, random_seed: int = 0):
    """Two disjoint shuffled index lists split at ``ratio`` (the same seed
    gives the same split)."""
    size = int(len(dataset) * ratio)
    indices = list(range(len(dataset)))
    random.Random(random_seed).shuffle(indices)
    return indices[:size], indices[size:]


def batched_indices(n: int, batch_size: int, shuffle: bool = False,
                    rng: Optional[random.Random] = None) -> List[List[int]]:
    idx = list(range(n))
    if shuffle:
        (rng or random).shuffle(idx)
    return [idx[i: i + batch_size] for i in range(0, n, batch_size)]


def train_batches(dataset, word_to_id: Dict[str, int], batch_size: int,
                  max_len: int, shuffle: bool, seed: int,
                  epoch: int = 0,
                  pad_to: Optional[int] = None,
                  indices: Optional[Sequence[int]] = None,
                  start: int = 0) -> Iterator[Batch]:
    """Fixed-shape train batches over a dataset with ``load_image(i)`` (or
    ``load_images_batch``), ``captions(i)`` and ``len``: the order
    shuffled by ``random.Random(seed * 100003 + epoch)``, which also picks
    each image's caption; every batch padded to ``pad_to or batch_size``
    rows. ``start`` > 0 yields from batch ``start`` on, the batches after
    it as without ``start``: the skipped batches' caption draws are made,
    their images are not decoded (a resumed epoch)."""
    rng = random.Random(seed * 100003 + epoch)
    order = list(indices) if indices is not None else list(range(len(dataset)))
    if shuffle:
        rng.shuffle(order)
    chunks = [order[i: i + batch_size] for i in range(0, len(order), batch_size)]
    for n, chunk in enumerate(chunks):
        caps = [dataset.captions(i) for i in chunk]
        if n < start:
            for c in caps:      # make_train_batch's draws, in its order
                rng.choice(list(c))
            continue
        yield make_train_batch(_load_chunk(dataset, chunk), caps, word_to_id,
                               max_len, rng, batch_size=pad_to or batch_size,
                               indices=chunk)


def _load_chunk(dataset, chunk):
    """Batched decode when the dataset supports it."""
    if hasattr(dataset, "load_images_batch"):
        return list(dataset.load_images_batch(chunk))
    return [dataset.load_image(i) for i in chunk]


def eval_batches(dataset, word_to_id: Dict[str, int], batch_size: int,
                 pad_to: Optional[int] = None) -> Iterator[EvalBatch]:
    for chunk in batched_indices(len(dataset), batch_size):
        imgs = _load_chunk(dataset, chunk)
        caps = [dataset.captions(i) for i in chunk]
        yield make_eval_batch(imgs, caps, word_to_id,
                              batch_size=pad_to or batch_size)


class Prefetcher:
    """Bounded background-thread prefetch over any batch iterator: decodes
    the next batches while the device works on the current one."""

    _DONE = object()

    def __init__(self, iterator: Iterator, depth: int = 2):
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._cancel = threading.Event()

        def run():
            try:
                for item in iterator:
                    # a bounded put, so that close() can stop a producer
                    # whose consumer left mid-iteration
                    while not self._cancel.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue_mod.Full:
                            continue
                    if self._cancel.is_set():
                        return
            except BaseException as e:  # surfaced to the consumer
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the producer thread without draining the iterator."""
        self._cancel.set()
        try:  # make room in case the producer is mid-put
            while True:
                self._q.get_nowait()
        except queue_mod.Empty:
            pass
        self._thread.join(timeout=timeout)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
