"""Batched caption generation (counterpart of the JAX
``engine/evaluate.py``): base-soft greedy decode on one device, no caches.

The hot path is ``make_caption_fn``: uint8 NHWC images -> /255 and ImageNet
normalization on the device -> frozen encoder -> whole-sequence greedy
decode kernel -> token IDs.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from depth_image_captioning_pub_tpu.data.pipeline import (
    Prefetcher, eval_batches)
from depth_image_captioning_pub_tpu.data.tokenizer import ids_to_caption
from depth_image_captioning_pub_torch.models.captioner import Captioner
from depth_image_captioning_pub_torch.ops.image_ops import (
    imagenet_normalize, to_unit_float)


def make_caption_fn(cap: Captioner, start_id: int, max_length: int = 30,
                    end_id: Optional[int] = None
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn(images [B,H,W,3] uint8 on the captioner's device) -> tokens
    [B, max_length] int32 on that device. ``end_id`` (when known) turns on
    <end>-padding and the early exit of the decode kernel."""
    encoder = cap.encoder_apply()
    sample = cap.sample_apply()

    @torch.inference_mode()
    def caption_fn(images: torch.Tensor) -> torch.Tensor:
        feats = encoder(imagenet_normalize(to_unit_float(images)))
        return sample(feats, start_id, max_length=max_length, end_id=end_id)

    return caption_fn


def generate_captions(caption_fn: Callable, dataset,
                      word_to_id: Dict[str, int],
                      id_to_word: Dict[int, str], batch_size: int,
                      device, prefetch: int = 3
                      ) -> Tuple[List[str], List[List[str]]]:
    """Caption every image of ``dataset`` (anything with ``load_image(i)``
    or ``load_images_batch``, ``captions(i)`` and ``len``); returns
    (hypotheses, references).

    Batches keep one shape (the last is padded with repeated images, which
    are dropped before detokenization). Detokenizing batch i overlaps the
    device's work on batch i+1: the host waits one batch behind.
    """
    hypos: List[str] = []
    refs: List[List[str]] = []
    pending: List[Tuple[torch.Tensor, int]] = []

    def drain(entry):
        tokens, n_valid = entry
        for row in tokens.cpu().numpy()[:n_valid]:
            hypos.append(ids_to_caption(row, id_to_word))

    it = Prefetcher(eval_batches(dataset, word_to_id, batch_size),
                    depth=prefetch)
    try:
        for batch in it:
            refs.extend(batch.references)
            images = torch.from_numpy(np.ascontiguousarray(batch.images))
            tokens = caption_fn(images.to(device))
            pending.append((tokens, int(batch.pad_mask.sum())))
            if len(pending) > 1:
                drain(pending.pop(0))
    finally:
        it.close()   # stops the loader thread if a batch raised
    for entry in pending:
        drain(entry)
    return hypos, refs
