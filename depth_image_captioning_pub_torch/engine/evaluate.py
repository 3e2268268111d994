"""Batched caption generation (counterpart of the JAX
``engine/evaluate.py``): NIC, base-soft and depth-soft, greedy, beam
search or stochastic sampling, on one device, no caches.

The hot path is ``make_caption_fn``: uint8 NHWC images -> /255 on the
device, then (a) ImageNet normalization -> frozen RGB encoder and, for a
depth kind, (b) ``depth_fn`` (the DPT: standardized depth maps) -> depth
encoder; the decoder adds (b) to (a) and runs the whole-sequence greedy
kernel, the whole-search beam kernel or the sampling loop of one-step
kernels -> token IDs. NIC's encoder is the backbone, a global pool and the
projection to the LSTM's input.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from depth_image_captioning_pub_torch.data.pipeline import (
    Prefetcher, eval_batches)
from depth_image_captioning_pub_torch.data.tokenizer import ids_to_caption
from depth_image_captioning_pub_torch.models.captioner import Captioner
from depth_image_captioning_pub_torch.ops.image_ops import (
    imagenet_normalize, to_unit_float)


def make_caption_fn(cap: Captioner, start_id: int, max_length: int = 30,
                    depth_fn: Optional[Callable] = None,
                    end_id: Optional[int] = None, beam_size: int = 1,
                    length_penalty: float = 0.0,
                    sampling: Optional[Dict] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn(images [B,H,W,3] uint8 on the captioner's device) -> tokens
    [B, max_length] int32 on that device. ``depth_fn`` (required by depth
    kinds, e.g. ``DPTDepthEstimator.depth_fn()``) maps the [0,1] images to
    standardized [B,224,224,1] depth maps. ``end_id`` (when known) turns on
    <end>-padding and the early exit of the greedy kernel; NIC's greedy
    decode ignores it and always runs ``max_length`` steps.

    ``beam_size > 1`` switches to batched beam search (it needs
    ``end_id``), ranked by score / length**``length_penalty``.

    ``sampling`` ({"temperature", "top_k", "top_p"}, defaults 1.0, 0, 1.0)
    switches to stochastic sampling (temperature / top-k / nucleus, always
    ``max_length`` steps), drawing from ``generator``: each call advances
    it, so calls give fresh captions, deterministic per its seed.
    """
    if beam_size > 1 and end_id is None:
        raise ValueError("beam search needs end_id (<end> token)")
    if sampling is not None:
        if beam_size > 1:
            raise ValueError("stochastic sampling is a greedy-loop variant "
                             "(no beam search)")
        if generator is None:
            raise ValueError("stochastic sampling needs a generator")
    encoder = cap.encoder_apply()
    depth_encoder = cap.depth_encoder_apply()
    sample = cap.sample_apply(sampling)
    if depth_encoder is not None and depth_fn is None:
        raise ValueError(f"{cap.spec.kind} needs depth_fn")

    if cap.spec.is_nic:
        @torch.inference_mode()
        def nic_caption_fn(images: torch.Tensor) -> torch.Tensor:
            feats = encoder(imagenet_normalize(to_unit_float(images)))
            if beam_size > 1:
                return cap.decoder.beam_sample(
                    feats, end_id, beam_size=beam_size,
                    max_length=max_length, length_penalty=length_penalty,
                    early_exit=True)[0]
            if sampling is not None:
                return sample(feats, generator, max_length=max_length)
            return sample(feats, max_length=max_length)
        return nic_caption_fn

    @torch.inference_mode()
    def caption_fn(images: torch.Tensor) -> torch.Tensor:
        images = to_unit_float(images)
        feats = encoder(imagenet_normalize(images))
        dep = None
        if depth_encoder is not None:
            dep = depth_encoder(depth_fn(images))
        if beam_size > 1:
            return cap.decoder.beam_sample(
                feats, start_id, end_id, dep, beam_size=beam_size,
                max_length=max_length, length_penalty=length_penalty)[0]
        if sampling is not None:
            return sample(feats, start_id, generator, dep,
                          max_length=max_length)[0]
        return sample(feats, start_id, dep, max_length=max_length,
                      end_id=end_id)

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
