"""Batched caption generation and scored evaluation (counterpart of the
JAX ``engine/evaluate.py``): every kind (NIC; base, depth and mdepth with
soft or hard attention), greedy, beam search or stochastic sampling, on
one device, no caches.

The hot path is ``make_caption_fn``: uint8 NHWC images -> /255 on the
device, then (a) ImageNet normalization -> frozen RGB encoder and, for a
depth kind, (b) ``depth_fn`` (the DPT: standardized depth maps) -> depth
encoder; the decoder fuses (b) into (a) and runs the whole-sequence greedy
kernel, the whole-search beam kernel or the sampling loop of one-step
kernels (soft attention), or its loops of PyTorch ops (hard attention, on
Gumbel region noise) -> token IDs. NIC's encoder is the backbone, a global
pool and the projection to the LSTM's input.

``evaluate`` scores checkpoint sets: for each, the trees from the loader
go into the captioner's modules, ``generate_captions`` captions the
dataset and the seven metrics of ``metrics.score`` are appended to their
lists. Hard attention draws each set's noise from a generator seeded with
the set's index, as the JAX package keys each set with
``PRNGKey(set_idx)``. The JAX package's caches of the frozen stages across
sets are not ported; it documents them as bit-identical to a recompute,
which is what each set runs here.
"""

from __future__ import annotations

import functools
import pickle
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from depth_image_captioning_pub_torch.config import ConfigEval
from depth_image_captioning_pub_torch.data.pipeline import (
    Prefetcher, eval_batches)
from depth_image_captioning_pub_torch.data.tokenizer import (
    SPECIAL, ids_to_caption)
from depth_image_captioning_pub_torch.metrics import load_textfiles, score
from depth_image_captioning_pub_torch.models.captioner import Captioner
from depth_image_captioning_pub_torch.models.decoder import AttNoise
from depth_image_captioning_pub_torch.ops.image_ops import (
    imagenet_normalize, to_unit_float)
from depth_image_captioning_pub_torch.ops.kernels.beam_seq import (
    check_beam_size)
from depth_image_captioning_pub_torch.utils.jax_bridge import params_from_jax

METRIC_KEYS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
               "CIDEr")


def make_caption_fn(cap: Captioner, start_id: int, max_length: int = 30,
                    depth_fn: Optional[Callable] = None,
                    end_id: Optional[int] = None, beam_size: int = 1,
                    length_penalty: float = 0.0,
                    sampling: Optional[Dict] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Callable[..., torch.Tensor]:
    """fn(images [B,H,W,3] uint8 on the captioner's device) -> tokens
    [B, max_length] int32 on that device. ``depth_fn`` (required by depth
    kinds, e.g. ``DPTDepthEstimator.depth_fn()``) maps the [0,1] images to
    standardized [B,224,224,1] depth maps. ``end_id`` (when known) turns on
    <end>-padding and the early exit of the greedy kernel; NIC's greedy
    decode ignores it and always runs ``max_length`` steps.

    ``beam_size > 1`` switches to batched beam search (it needs
    ``end_id``), ranked by score / length**``length_penalty``. Soft
    attention's search runs the beam kernel, whose instances on a CUDA
    device are ``beam_seq.BEAM_SIZES``: a wider beam raises here, before
    any work.

    ``sampling`` ({"temperature", "top_k", "top_p"}, defaults 1.0, 0, 1.0)
    switches to stochastic sampling (temperature / top-k / nucleus, always
    ``max_length`` steps), drawing from ``generator``: each call advances
    it, so calls give fresh captions, deterministic per its seed.

    Hard attention draws its region noise from ``generator`` too, or from
    the ``att_noise(t, shape)`` hook that a call passes (``fn(images,
    att_noise=...)``; the tests replay the JAX package's draws through it).
    """
    if beam_size > 1 and cap.spec.attention == "soft":
        check_beam_size(beam_size, cap.device)
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

    hard = cap.spec.attention == "hard"

    @torch.inference_mode()
    def caption_fn(images: torch.Tensor,
                   att_noise: Optional[AttNoise] = None) -> torch.Tensor:
        noise = {}        # hard attention's region noise
        if hard:
            if att_noise is None and generator is None:
                raise ValueError(f"{cap.spec.kind} needs a generator or an "
                                 f"att_noise hook for its region noise")
            noise = {"att_noise": att_noise}
        images = to_unit_float(images)
        feats = encoder(imagenet_normalize(images))
        dep = None
        if depth_encoder is not None:
            dep = depth_encoder(depth_fn(images))
        if sampling is not None:     # the generator draws the tokens too
            return sample(feats, start_id, generator, dep,
                          max_length=max_length, **noise)[0]
        if hard:
            noise["generator"] = generator
        if beam_size > 1:
            return cap.decoder.beam_sample(
                feats, start_id, end_id, dep, beam_size=beam_size,
                max_length=max_length, length_penalty=length_penalty,
                **noise)[0]
        return sample(feats, start_id, dep, max_length=max_length,
                      end_id=end_id, **noise)

    return caption_fn


def generate_captions(caption_fn: Callable, dataset,
                      word_to_id: Dict[str, int],
                      id_to_word: Dict[int, str], batch_size: int,
                      device, prefetch: int = 3,
                      att_noise: Optional[Callable[[int], AttNoise]] = None
                      ) -> Tuple[List[str], List[List[str]]]:
    """Caption every image of ``dataset`` (anything with ``load_image(i)``
    or ``load_images_batch``, ``captions(i)`` and ``len``); returns
    (hypotheses, references). ``att_noise(i)``, when given, is batch i's
    region-noise hook (hard attention), passed to ``caption_fn``.

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
        for i, batch in enumerate(it):
            refs.extend(batch.references)
            images = torch.from_numpy(np.ascontiguousarray(batch.images))
            kw = {} if att_noise is None else {"att_noise": att_noise(i)}
            tokens = caption_fn(images.to(device), **kw)
            pending.append((tokens, int(batch.pad_mask.sum())))
            if len(pending) > 1:
                drain(pending.pop(0))
    finally:
        it.close()   # stops the loader thread if a batch raised
    for entry in pending:
        drain(entry)
    return hypos, refs


def evaluate(kind: str, use_data: str, cap: Captioner,
             checkpoint_loader: Callable[[int], Tuple],
             dataset, word_to_id: Dict[str, int], id_to_word: Dict[int, str],
             cfg: Optional[ConfigEval] = None,
             depth_fn: Optional[Callable] = None, num_sets: int = 3,
             scores_pickle: Optional[str] = None, beam_size: int = 1,
             quiet: bool = False,
             att_noise: Optional[Callable[[int, int], AttNoise]] = None
             ) -> Dict[str, List[float]]:
    """Score ``num_sets`` checkpoint sets of one configuration (``kind``
    and ``use_data`` name it, as in the JAX package); returns, and pickles
    to ``scores_pickle``, {metric: [one score per set]}.

    ``checkpoint_loader(set_index)`` (1-based) -> (frozen encoder,
    trainable params, batch_stats) trees, e.g. ``cli.load_eval_components``.
    Each set's trees are copied into ``cap`` (``params_from_jax``) and the
    dataset is captioned on ``cap``'s device in ``cfg.batch_size`` batches
    of at most ``cfg.max_length`` tokens: greedy decode with the <end>
    exit, or beam search when ``beam_size > 1``.
    Depth kinds need ``depth_fn``, as ``make_caption_fn`` does.

    Hard attention draws set k's region noise from one ``torch.Generator``
    on ``cap.device`` seeded with k, which advances batch by batch (the
    JAX package keys set k with ``PRNGKey(k)`` and splits it once a
    batch). ``att_noise(set_idx, batch_idx)``, when given, returns each
    batch's ``att_noise(t, shape)`` hook instead (the tests feed the JAX
    split chain through it).
    """
    cfg = cfg or ConfigEval()
    generator = (torch.Generator(device=cap.device)
                 if cap.spec.attention == "hard" else None)
    caption_fn = make_caption_fn(cap, word_to_id[SPECIAL.start],
                                 cfg.max_length, depth_fn,
                                 end_id=word_to_id[SPECIAL.end],
                                 beam_size=beam_size, generator=generator)
    scores: Dict[str, List[float]] = {k: [] for k in METRIC_KEYS}
    for set_idx in range(1, num_sets + 1):
        frozen_enc, params, batch_stats = checkpoint_loader(set_idx)
        params_from_jax(cap, params, {"encoder": frozen_enc}, batch_stats)
        if generator is not None:
            generator.manual_seed(set_idx)
        hypos, refs = generate_captions(
            caption_fn, dataset, word_to_id, id_to_word, cfg.batch_size,
            cap.device, att_noise=None if att_noise is None
            else functools.partial(att_noise, set_idx))
        result = score(*load_textfiles(refs, hypos))
        if not quiet:
            print(result)
        for k, v in result.items():
            scores[k].append(v)
    if scores_pickle:
        with open(scores_pickle, "wb") as f:
            pickle.dump(scores, f)
    return scores
