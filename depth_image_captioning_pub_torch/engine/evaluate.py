"""Batched caption generation and scored evaluation (counterpart of the
JAX ``engine/evaluate.py``): every kind (NIC; base, depth and mdepth with
soft or hard attention), greedy, beam search or stochastic sampling, on
one device, with the JAX package's caches of the frozen stages across
checkpoint sets.

The hot path is ``make_caption_fn``: uint8 NHWC images -> /255 on the
device, then (a) ImageNet normalization -> frozen RGB encoder and, for a
depth kind, (b) ``depth_fn`` (the DPT: standardized depth maps) -> depth
encoder; the decoder fuses (b) into (a) and runs the whole-sequence greedy
kernel, the whole-search beam kernel or the sampling loop of one-step
kernels (soft attention), or its loops of PyTorch ops (hard attention, on
Gumbel region noise) -> token IDs. NIC's encoder is the backbone, a global
pool and the projection to the LSTM's input. The function is two stages:
``caption_fn.frozen`` (images -> an entry of the frozen stages' outputs:
``feats`` [B, 196, 2048] and, for depth kinds, ``depth_maps`` [B, 224,
224, 1] f32; NIC's ``pooled`` [B, 2048]) and ``caption_fn.decode`` (an
entry -> tokens: the trainable stages).

``evaluate`` scores checkpoint sets: for each, the trees from the loader
go into the captioner's modules, ``generate_captions`` captions the
dataset and the seven metrics of ``metrics.score`` are appended to their
lists. Hard attention draws each set's noise from a generator seeded with
the set's index, as the JAX package keys each set with
``PRNGKey(set_idx)``.

The frozen stages (the RGB encoder, the DPT) depend on the images alone,
so ``evaluate`` runs them on set 1 only: with more than one set (or a disk
store) it keeps set 1's entries on the device and replays them for the
sets after it, which then run only their trainable stages (no dataset
pass, no image decode or transfer, no encoder, no DPT: K5 does not
launch). A set whose frozen encoder differs from set 1's recomputes its
features and still replays the depth maps (the DPT is shared).
``$DCAP_EVAL_CACHE_GB`` (default 8) bounds the entries' device bytes;
above it only the depth maps are kept. ``eval_cache_dir`` also writes
the entries to disk (``engine/eval_cache_store.py``), so that a later run
replays them from there. Replayed entries are the same tensors a
recompute gives, so hypotheses and scores are equal; hard attention still
draws each set's region noise from the set's own seed.

Data parallel (the JAX ``evaluate``'s mesh over every device): in a
process group of R ranks (``parallel/multihost.initialize``, one process
per card under ``torchrun``) each batch is padded to a multiple of R and
each rank decodes and captions its contiguous rows (its kernels on its
card), the tokens are gathered, and rank 0 detokenizes, scores, prints
and writes the pickle; every rank returns rank 0's scores. Hard
attention draws the whole padded batch's noise on every rank, each
keeping its rows, so the hypotheses are one rank's. The set cache keeps
each rank's rows; its disk store holds whole batches, which rank 0 writes
(gathered from the ranks) and every rank reads its rows of.
"""

from __future__ import annotations

import functools
import os
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
from depth_image_captioning_pub_torch.ops.decode import region_noise
from depth_image_captioning_pub_torch.ops.kernels.beam_seq import (
    check_beam_size)
from depth_image_captioning_pub_torch.ops.pooling import global_avg_pool
from depth_image_captioning_pub_torch.parallel.mesh import (
    all_gather_rows, any_rank, batch_sharding, broadcast_object,
    global_rows, make_mesh, pad_batch_to_devices)
from depth_image_captioning_pub_torch.utils import tracing
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    flatten_tree, params_from_jax)

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
    att_noise=...)``; the tests replay the JAX package's draws through
    it), and sampling its token noise from the ``noise(t)`` hook [B, V]
    when a call passes one (``export.py`` feeds both as program inputs).

    The function's two stages are ``fn.frozen(images, depth_maps=None)``
    -> an entry of the frozen stages' outputs and ``fn.decode(entry,
    att_noise=None, noise=None)`` -> tokens; ``fn(images)`` is the one
    after the other.

    With ``utils/tracing`` on, the stages record their spans:
    ``frozen.rgb_encoder`` (/255, normalization, the encoder),
    ``frozen.depth`` (``depth_fn``), ``decode.depth_encoder`` and the
    decode call, ``decode``, in every mode.
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
        def nic_frozen(images: torch.Tensor) -> Dict[str, torch.Tensor]:
            with tracing.span("frozen.rgb_encoder"):
                x = imagenet_normalize(to_unit_float(images))
                return {"pooled": global_avg_pool(cap.backbone(x))}

        @torch.inference_mode()
        def nic_decode(entry: Dict[str, torch.Tensor],
                       att_noise: Optional[AttNoise] = None,
                       noise: Optional[Callable] = None) -> torch.Tensor:
            with tracing.span("decode"):
                feats = cap.projection(entry["pooled"])
                if beam_size > 1:
                    return cap.decoder.beam_sample(
                        feats, end_id, beam_size=beam_size,
                        max_length=max_length,
                        length_penalty=length_penalty, early_exit=True)[0]
                if sampling is not None:
                    return sample(feats, generator, max_length=max_length,
                                  noise=noise)
                return sample(feats, max_length=max_length)
        return _two_stage(nic_frozen, nic_decode)

    hard = cap.spec.attention == "hard"

    @torch.inference_mode()
    def frozen(images: torch.Tensor,
               depth_maps: Optional[torch.Tensor] = None
               ) -> Dict[str, Optional[torch.Tensor]]:
        """The frozen stages: {"feats", "depth_maps"} (None without
        depth); ``depth_maps`` given (a replayed set) skips the DPT."""
        with tracing.span("frozen.rgb_encoder"):
            images = to_unit_float(images)
            feats = encoder(imagenet_normalize(images))
        if depth_encoder is not None and depth_maps is None:
            with tracing.span("frozen.depth"):
                depth_maps = depth_fn(images)
        return {"feats": feats, "depth_maps": depth_maps}

    @torch.inference_mode()
    def decode(entry: Dict[str, Optional[torch.Tensor]],
               att_noise: Optional[AttNoise] = None,
               noise: Optional[Callable] = None) -> torch.Tensor:
        regions = {}      # hard attention's region noise
        if hard:
            if att_noise is None and generator is None:
                raise ValueError(f"{cap.spec.kind} needs a generator or an "
                                 f"att_noise hook for its region noise")
            regions = {"att_noise": att_noise}
        feats = entry["feats"]
        dep = None
        if depth_encoder is not None:
            with tracing.span("decode.depth_encoder"):
                dep = depth_encoder(entry["depth_maps"])
        with tracing.span("decode"):
            if sampling is not None:     # the generator draws the tokens too
                return sample(feats, start_id, generator, dep,
                              max_length=max_length, noise=noise,
                              **regions)[0]
            if hard:
                regions["generator"] = generator
            if beam_size > 1:
                return cap.decoder.beam_sample(
                    feats, start_id, end_id, dep, beam_size=beam_size,
                    max_length=max_length, length_penalty=length_penalty,
                    **regions)[0]
            return sample(feats, start_id, dep, max_length=max_length,
                          end_id=end_id, **regions)

    return _two_stage(frozen, decode)


def _two_stage(frozen: Callable, decode: Callable) -> Callable:
    """fn(images, att_noise=None, noise=None) = decode(frozen(images),
    att_noise, noise), with the two stages as ``fn.frozen`` and
    ``fn.decode``."""
    def caption_fn(images: torch.Tensor,
                   att_noise: Optional[AttNoise] = None,
                   noise: Optional[Callable] = None) -> torch.Tensor:
        return decode(frozen(images), att_noise, noise)
    caption_fn.frozen, caption_fn.decode = frozen, decode
    return caption_fn


def generate_captions(caption_fn: Callable, dataset,
                      word_to_id: Dict[str, int],
                      id_to_word: Dict[int, str], batch_size: int,
                      device, prefetch: int = 3,
                      att_noise: Optional[Callable[[int], AttNoise]] = None,
                      set_cache: Optional[Dict] = None,
                      set_cache_mode: Optional[str] = None,
                      depth_cache: Optional[List] = None,
                      depth_cache_mode: Optional[str] = None
                      ) -> Tuple[List[str], List[List[str]]]:
    """Caption every image of ``dataset`` (anything with ``load_image(i)``
    or ``load_images_batch``, ``captions(i)`` and ``len``) with
    ``caption_fn`` from ``make_caption_fn``, each batch through its
    ``frozen`` then its ``decode`` stage; returns (hypotheses,
    references). ``att_noise(i)``, when given, is batch i's region-noise
    hook (hard attention), passed to ``caption_fn.decode``.

    Batches keep one shape (the last is padded with repeated images, which
    are dropped before detokenization). Detokenizing batch i overlaps the
    device's work on batch i+1: the host waits one batch behind.

    Over several ranks (``parallel/mesh``) each batch is padded to a
    multiple of their count and each rank captions its contiguous rows
    (``att_noise(i)`` is then the whole batch's hook, drawn at its shape
    with this rank's rows kept); the tokens are gathered and rank 0 alone
    returns the hypotheses (the other ranks an empty list).

    The caches: ``set_cache``
    ({"entries": [...], "refs": ...}) in mode "fill" keeps each batch's
    frozen-stage entry and the references; in mode "use" the batches are
    its entries, through ``caption_fn.decode`` only, and the dataset is
    not read. ``depth_cache`` (a list) in mode "fill" keeps each batch's
    depth maps; in mode "use" batch i's frozen stage takes
    ``depth_cache[i]`` instead of running the DPT. Batching is
    deterministic, so batch i covers the same images on every pass.
    """
    hypos: List[str] = []
    refs: List[List[str]] = []
    pending: List[Tuple[torch.Tensor, int]] = []
    mesh = make_mesh()
    pad_to = pad_batch_to_devices(batch_size, mesh.size)

    def drain(entry):
        tokens, n_valid = entry
        tokens = all_gather_rows(tokens)
        if mesh.rank != 0:
            return
        for row in tokens.cpu().numpy()[:n_valid]:
            hypos.append(ids_to_caption(row, id_to_word))

    def noise(i):
        return {} if att_noise is None else {
            "att_noise": global_rows(att_noise(i), mesh)}

    if set_cache_mode == "use":
        for i, (entry, n_valid) in enumerate(set_cache["entries"]):
            pending.append((caption_fn.decode(entry, **noise(i)), n_valid))
            if len(pending) > 1:
                drain(pending.pop(0))
        for entry in pending:
            drain(entry)
        return hypos, [list(r) for r in set_cache["refs"]]

    it = Prefetcher(eval_batches(
        dataset, word_to_id, batch_size, pad_to=pad_to,
        shard=(mesh.rank, mesh.size)),
        depth=prefetch)
    try:
        for i, batch in enumerate(it):
            refs.extend(batch.references)
            images = torch.from_numpy(np.ascontiguousarray(
                batch.images)).to(device)
            n_valid = int(batch.pad_mask.sum())
            entry = (caption_fn.frozen(images, depth_maps=depth_cache[i])
                     if depth_cache_mode == "use"
                     else caption_fn.frozen(images))
            if set_cache_mode == "fill":
                set_cache["entries"].append((entry, n_valid))
            elif depth_cache_mode == "fill":
                depth_cache.append(entry["depth_maps"])
            pending.append((caption_fn.decode(entry, **noise(i)), n_valid))
            if len(pending) > 1:
                drain(pending.pop(0))
    finally:
        it.close()   # stops the loader thread if a batch raised
    for entry in pending:
        drain(entry)
    if set_cache_mode == "fill":
        set_cache["refs"] = [list(r) for r in refs]
    return hypos, refs


def _trees_equal(ref, other) -> bool:
    """Exact equality of two nested-dict trees of arrays: the same paths
    and every array equal (the guard of the frozen-feature cache: set k
    replays set 1's features only with an identical encoder)."""
    a, b = flatten_tree(ref), flatten_tree(other)
    return a.keys() == b.keys() and all(
        a[k].shape == b[k].shape and np.array_equal(a[k], b[k]) for k in a)


def _projected_cache_bytes(cap: Captioner, cfg, n_images: int,
                           uses_depth: bool) -> int:
    """Upper bound of the set cache's device bytes: attention kinds keep
    [regions, dim_encoder] features an image (and f32 depth maps), NIC its
    [dim_encoder] pooled features."""
    itemsize = torch.finfo(cap.encoder_dtype).bits // 8
    regions = 1 if cap.spec.is_nic else int(cfg.enc_img_size) ** 2
    per_img = regions * int(cfg.dim_encoder) * itemsize
    if uses_depth:
        per_img += 224 * 224 * 4
    return per_img * n_images


def evaluate(kind: str, use_data: str, cap: Captioner,
             checkpoint_loader: Callable[[int], Tuple],
             dataset, word_to_id: Dict[str, int], id_to_word: Dict[int, str],
             cfg: Optional[ConfigEval] = None,
             depth_fn: Optional[Callable] = None, num_sets: int = 3,
             scores_pickle: Optional[str] = None, beam_size: int = 1,
             quiet: bool = False,
             att_noise: Optional[Callable[[int, int], AttNoise]] = None,
             depth_eval_cache: bool = True,
             eval_cache_dir: Optional[str] = None
             ) -> Dict[str, List[float]]:
    """Score ``num_sets`` checkpoint sets of one configuration (``kind``
    and ``use_data`` name it, as in the JAX package); returns, and pickles
    to ``scores_pickle``, {metric: [one score per set]}.

    ``checkpoint_loader(set_index)`` (1-based) -> (frozen encoder,
    trainable params, batch_stats) trees, e.g. ``cli.load_eval_components``.
    Each set's trees are copied into ``cap`` (``params_from_jax``; the
    frozen encoder only where the set runs it and it differs from the one
    already on the card) and the dataset is captioned on ``cap``'s device
    in ``cfg.batch_size`` batches of at most ``cfg.max_length`` tokens:
    greedy decode with the <end> exit, or beam search when ``beam_size >
    1``. Depth kinds need ``depth_fn``, as ``make_caption_fn`` does.

    ``depth_eval_cache`` (with ``num_sets`` > 1 or ``eval_cache_dir``):
    set 1's frozen-stage entries replay for the later sets whose frozen
    encoder equals set 1's (``_trees_equal``), and its depth maps for every
    later set; off, every set recomputes every stage, as the reference
    does. ``$DCAP_EVAL_CACHE_GB`` (default 8) bounds the entries' device
    bytes (``_projected_cache_bytes``): above it, only depth maps are kept.
    ``eval_cache_dir`` persists set 1's entries (``eval_cache_store``),
    keyed by the dataset and the frozen weights (the DPT's through
    ``depth_fn.model``, which a depth kind's ``depth_fn`` must then carry:
    ValueError otherwise), so that a later run replays them, also with one
    set.

    Hard attention draws set k's region noise from one ``torch.Generator``
    on ``cap.device`` seeded with k, which advances batch by batch (the
    JAX package keys set k with ``PRNGKey(k)`` and splits it once a
    batch). ``att_noise(set_idx, batch_idx)``, when given, returns each
    batch's ``att_noise(t, shape)`` hook instead (the tests feed the JAX
    split chain through it).

    Over several ranks (``parallel/mesh``) the batches are sharded
    (``generate_captions``), rank 0 alone prints, scores and writes, and
    every rank returns its scores.
    """
    cfg = cfg or ConfigEval()
    mesh = make_mesh()
    quiet = quiet or mesh.rank != 0
    generator = (torch.Generator(device=cap.device)
                 if cap.spec.attention == "hard" else None)
    if mesh.sharded and generator is not None and att_noise is None:
        def att_noise(set_idx, batch_idx):
            """The generator's draws, made on every rank at the whole
            batch's shape (``generate_captions`` keeps this rank's
            rows)."""
            return region_noise(generator)
    caption_fn = make_caption_fn(cap, word_to_id[SPECIAL.start],
                                 cfg.max_length, depth_fn,
                                 end_id=word_to_id[SPECIAL.end],
                                 beam_size=beam_size, generator=generator)
    scores: Dict[str, List[float]] = {k: [] for k in METRIC_KEYS}
    uses_depth = cap.spec.uses_depth
    cache_on = depth_eval_cache and (num_sets > 1
                                     or eval_cache_dir is not None)
    set_cache: Optional[Dict] = None
    if cache_on:
        projected = _projected_cache_bytes(cap, cfg, len(dataset),
                                           uses_depth)
        limit = float(os.environ.get("DCAP_EVAL_CACHE_GB", "8")) * 2**30
        if projected <= limit:
            set_cache = {"entries": [], "refs": None}
        elif not quiet:
            print(f"eval set cache would need ~{projected / 2**30:.1f} GB "
                  f"(> DCAP_EVAL_CACHE_GB={limit / 2**30:g}); caching "
                  f"{'depth maps only' if uses_depth else 'nothing'}")
    # the depth-only fallback: the DPT is shared by every set, so its maps
    # need no equality guard
    depth_cache: Optional[List] = [] if (
        cache_on and uses_depth and set_cache is None) else None
    store = dkey = mkey = None
    if set_cache is not None and eval_cache_dir:
        from depth_image_captioning_pub_torch.engine import eval_cache_store
        dkey = eval_cache_store.data_key(
            dataset, cfg.batch_size,
            pad_batch_to_devices(cfg.batch_size, mesh.size))
        if dkey is None:
            if not quiet:
                print("eval cache dir: the dataset has no image paths to "
                      "fingerprint; disk persistence off")
        elif uses_depth and getattr(depth_fn, "model", None) is None:
            # the store's key must hold the DPT's weights, or another DPT
            # would replay these maps
            raise ValueError("eval_cache_dir with a depth kind needs the "
                             "DPT whose weights key the store as "
                             "depth_fn.model (DPTDepthEstimator.depth_fn() "
                             "sets it)")
        else:
            store = eval_cache_store
    if num_sets == 1 and store is None:
        # nothing would replay what a single set fills
        set_cache = depth_cache = None
    enc_ref = on_card = None
    for set_idx in range(1, num_sets + 1):
        frozen_enc, params, batch_stats = checkpoint_loader(set_idx)
        set_mode = depth_mode = None
        if set_idx == 1:
            if set_cache is not None:
                enc_ref, set_mode = frozen_enc, "fill"
                if store is not None:
                    mkey = store.model_key(
                        frozen_enc, depth_fn.model.state_dict()
                        if uses_depth else None,
                        cap.encoder_dtype, cfg, kind)
                    loaded = _rows_of_store(store.load(
                        eval_cache_dir, dkey, mkey, cap.device,
                        quiet=quiet), mesh)
                    if loaded is not None:
                        set_cache.update(loaded)
                        set_mode = "use"
            elif depth_cache is not None:
                depth_mode = "fill"
        elif set_cache is not None:
            if _trees_equal(enc_ref, frozen_enc):
                set_mode = "use"
            else:
                # this set's frozen encoder differs: its features are
                # recomputed, the shared DPT's maps still replay
                if not quiet:
                    print(f"set {set_idx}: encoder params differ from set "
                          f"1; frozen-feature cache skipped")
                if uses_depth:
                    depth_mode = "use"
                    depth_cache = [aux["depth_maps"]
                                   for aux, _ in set_cache["entries"]]
        elif depth_cache is not None:
            depth_mode = "use"
        # the frozen encoder goes to the card only where this set runs it
        # and the card does not hold it already
        load_encoder = set_mode != "use" and not (
            on_card is not None and _trees_equal(on_card, frozen_enc))
        params_from_jax(cap, params, {"encoder": frozen_enc}, batch_stats,
                        load_encoder=load_encoder)
        if load_encoder:
            on_card = frozen_enc
        if generator is not None:
            generator.manual_seed(set_idx)
        hypos, refs = generate_captions(
            caption_fn, dataset, word_to_id, id_to_word, cfg.batch_size,
            cap.device, att_noise=None if att_noise is None
            else functools.partial(att_noise, set_idx),
            set_cache=set_cache, set_cache_mode=set_mode,
            depth_cache=depth_cache, depth_cache_mode=depth_mode)
        if set_idx == 1 and set_mode == "fill" and store is not None:
            whole = _gathered(set_cache)
            if mesh.rank == 0:
                store.save(eval_cache_dir, dkey, mkey, whole, quiet=quiet)
        result = (score(*load_textfiles(refs, hypos)) if mesh.rank == 0
                  else None)
        result = broadcast_object(result)
        if not quiet:
            print(result)
        for k, v in result.items():
            scores[k].append(v)
    if scores_pickle and mesh.rank == 0:
        with open(scores_pickle, "wb") as f:
            pickle.dump(scores, f)
    return scores


def _rows_of_store(loaded: Optional[Dict], mesh) -> Optional[Dict]:
    """This rank's rows of each batch of a set cache read from the disk
    store (whole batches), or None when any rank missed it: all ranks
    replay, or all fill."""
    if not mesh.sharded:
        return loaded
    if any_rank(loaded is None):
        return None
    entries = [({name: None if t is None else t[batch_sharding(
        mesh, t.shape[0])] for name, t in aux.items()}, n_valid)
        for aux, n_valid in loaded["entries"]]
    return dict(loaded, entries=entries)


def _gathered(set_cache: Dict) -> Dict:
    """A filled set cache with the ranks' rows of each batch gathered into
    whole batches (the disk store's layout)."""
    entries = [({name: None if t is None else all_gather_rows(t)
                 for name, t in aux.items()}, n_valid)
               for aux, n_valid in set_cache["entries"]]
    return dict(set_cache, entries=entries)
