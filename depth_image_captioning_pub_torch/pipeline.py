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

``kind`` may also be ``"nic"``. ``CaptionPipeline(..., beam_size=5,
length_penalty=0.7)`` captions with beam search, and ``CaptionPipeline(
..., sample=True, temperature=0.8, top_k=0, top_p=0.9, seed=0)`` with
stochastic sampling: the pipeline keeps one ``torch.Generator`` on the
captioner's device, seeded from ``seed``, and every chunk draws from it,
so repeated calls give fresh captions, deterministic per seed. A depth
kind also needs the DPT that makes its depth maps:

    est = DPTDepthEstimator(device="cuda")          # models/dpt.py
    est.init(torch.Generator().manual_seed(0))      # or dpt_params_from_jax
    cap = build_captioner("depth-soft", len(word_to_id), device="cuda")
    pipe = CaptionPipeline(cap, word_to_id, id_to_word,
                           depth_fn=est.depth_fn())

A request is cut into chunks of the largest bucket, and each chunk is
padded (with repeats of its rows) to the smallest bucket that fits; padding
rows are dropped before detokenization, so captions do not depend on the
bucket. Chunk i+1 is dispatched before the host waits for chunk i's tokens.

Parameters live in the captioner's modules on its device.
``CaptionPipeline.from_experiment("base-soft", set_idx=1)`` builds the
captioner and loads one checkpoint set that the JAX trainer wrote (the
``exp_result/`` layout of ``ConfigEval``'s tables, ``cli.load_eval_
components``); ``reload_weights`` swaps trees in place and
``reload_from_experiment`` re-reads the same files. The decoders repack
their kernel weights on every call, so a swap reaches the next chunk.
Several devices wait for a later slice (ROADMAP.md), as does decoding
JPEG paths: images are uint8 [H, W, 3] arrays at ``image_hw``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from depth_image_captioning_pub_torch.data.tokenizer import (
    SPECIAL, ids_to_caption)
from depth_image_captioning_pub_torch.engine.evaluate import make_caption_fn


class CaptionPipeline:
    """Batched captioning over one captioner (nic, base-soft, or
    depth-soft with its ``depth_fn``): greedy, beam search when
    ``beam_size > 1``, or stochastic sampling when ``sample`` (greedy
    ignores ``seed``; beam search with ``sample`` raises)."""

    def __init__(self, cap, word_to_id: Dict[str, int],
                 id_to_word: Dict[int, str], *, depth_fn=None,
                 max_length: int = 30, batch_buckets=(64,),
                 image_hw=(224, 224), beam_size: int = 1,
                 length_penalty: float = 0.0, sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0):
        self.cap = cap
        self.device = cap.device
        self._experiment = None     # (save_dir, files) of from_experiment
        self.max_length = int(max_length)
        self.id_to_word = id_to_word
        self.batch_buckets = tuple(sorted({int(b) for b in batch_buckets}))
        if not self.batch_buckets or self.batch_buckets[0] < 1:
            raise ValueError(f"bad batch_buckets {batch_buckets}")
        self.batch_size = self.batch_buckets[-1]   # the chunk size
        self.image_hw = tuple(image_hw)
        self.sample = bool(sample)
        self.generator = None
        if self.sample:
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(int(seed))
        self._fn = make_caption_fn(
            cap, start_id=word_to_id[SPECIAL.start],
            max_length=self.max_length, depth_fn=depth_fn,
            end_id=word_to_id.get(SPECIAL.end), beam_size=beam_size,
            length_penalty=length_penalty,
            sampling=({"temperature": temperature, "top_k": top_k,
                       "top_p": top_p} if self.sample else None),
            generator=self.generator)

    @classmethod
    def from_experiment(cls, kind: str, use_data: str = "coco", cfg=None,
                        set_idx: int = 1, device="cuda", **kwargs
                        ) -> "CaptionPipeline":
        """The pipeline over checkpoint set ``set_idx`` (1-based) of
        ``kind`` that the evaluation would score: the vocabulary and the
        ``exp_result/`` files of ``cfg`` (a ``ConfigEval``), on ``device``.
        ``use_data="original"`` selects the original-dataset vocabulary and
        tables. $DCAP_RESNET_LAYERS shrinks the backbone; a depth kind gets
        ``cli.eval_depth_fn``'s DPT. ``kwargs`` go to the constructor."""
        from depth_image_captioning_pub_torch import cli
        from depth_image_captioning_pub_torch.config import ConfigEval
        from depth_image_captioning_pub_torch.data.vocab import load_vocab
        from depth_image_captioning_pub_torch.models.captioner import (
            build_captioner)

        cfg = cfg or ConfigEval()
        base, atten = (kind.split("-") + ["soft"])[:2]
        use_ori = use_data == "original"
        word_to_id, id_to_word = load_vocab(
            cfg.ori_word_to_id_file if use_ori else cfg.word_to_id_file)
        cap = build_captioner(kind, len(word_to_id), cfg,
                              resnet_layers=cli.resnet_layers_from_env(),
                              device=device)
        if kind == "nic":
            save_dir, tables = cfg.save_directory_nic, cfg.nic_parameter_files
        else:
            save_dir, tables = cli.eval_tables(
                cfg, atten, use_ori, base in ("depth", "mdepth"),
                encoder="mlp" if base == "mdepth" else "cnn")
        depth_fn = (cli.eval_depth_fn(cfg, device) if cap.spec.uses_depth
                    else None)
        pipe = cls(cap, word_to_id, id_to_word, depth_fn=depth_fn,
                   max_length=cfg.max_length, **kwargs)
        pipe._experiment = (save_dir, tables[set_idx])
        pipe.reload_from_experiment()
        return pipe

    def reload_weights(self, trainable=None, frozen_enc=None,
                       batch_stats=None) -> None:
        """Copy the JAX package's trees into the captioner in place; a tree
        left out keeps its current values. Not synchronized with a
        concurrent call: the caller serializes a swap with inference."""
        from depth_image_captioning_pub_torch.utils.jax_bridge import (
            params_from_jax, params_to_jax)
        if None in (trainable, frozen_enc, batch_stats):
            cur_t, cur_f, cur_s = params_to_jax(self.cap)
            trainable = cur_t if trainable is None else trainable
            frozen_enc = cur_f["encoder"] if frozen_enc is None else frozen_enc
            batch_stats = cur_s if batch_stats is None else batch_stats
        params_from_jax(self.cap, trainable, {"encoder": frozen_enc},
                        batch_stats)

    def reload_from_experiment(self) -> None:
        """Re-read the checkpoint files this pipeline was built from (after
        training rewrote them) and swap the weights; the DPT is kept."""
        if self._experiment is None:
            raise RuntimeError("pipeline was not built by from_experiment; "
                               "use reload_weights(...) directly")
        from depth_image_captioning_pub_torch import cli
        frozen_enc, trainable, stats = cli.load_eval_components(
            *self._experiment, self.cap)
        self.reload_weights(trainable, frozen_enc, stats)

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
