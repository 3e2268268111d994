"""Fixed-shape evaluation batches and a background prefetcher (the port's
own copy of what it uses from the JAX package's ``data/pipeline.py``).

Every batch has one shape: the last one is padded with repeated images and
``pad_mask`` marks the repeats. Images stay uint8 on the host; the device
converts them.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np

from depth_image_captioning_pub_torch.data.tokenizer import untokenize_caption


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


def batched_indices(n: int, batch_size: int) -> List[List[int]]:
    return [list(range(i, min(i + batch_size, n)))
            for i in range(0, n, batch_size)]


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
