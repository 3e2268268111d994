"""One-call inference API: image paths or arrays in, caption strings out
(counterpart of the JAX ``pipeline.py``).

    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline

    cap = build_captioner("base-soft", len(word_to_id), device="cuda")
    cap.init(torch.Generator().manual_seed(0))      # or params_from_jax
    pipe = CaptionPipeline(cap, word_to_id, id_to_word,
                           batch_buckets=(1, 16, 64))
    pipe("dog.jpg")                      # -> "a dog runs on the beach"
    pipe(["a.png", "b.jpg", arr_hw3])    # -> list of captions

``kind`` may be any of the seven (``models/captioner.PORTED_KINDS``).
``CaptionPipeline(..., beam_size=5, length_penalty=0.7)`` captions with
beam search, and ``CaptionPipeline(..., sample=True, temperature=0.8,
top_k=0, top_p=0.9, seed=0)`` with stochastic sampling: the pipeline keeps
one ``torch.Generator`` on the captioner's device, seeded from ``seed``,
and every chunk draws from it, so repeated calls give fresh captions,
deterministic per seed. Hard attention draws its region noise from that
generator too; without ``sample`` it is re-seeded with ``seed`` before
every chunk, so a request captions the same way on every call (the JAX
pipeline's fixed key). A depth kind also needs the DPT that makes its
depth maps:

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

``devices=["cuda:0", "cuda:1", ...]`` captions over several cards (the
JAX pipeline's ``devices=``, a device may repeat): one replica of the
captioner (and of the DPT) per device, the buckets rounded up to
multiples of the device count, and each chunk split into contiguous rows,
one part per replica; every part is launched before the host waits on
any, and the tokens come back in order. The noise of a hard kind or of
sampling is drawn at the whole chunk's shape from the one generator, in
the order one device would draw it, and each replica takes its rows, so
the captions are one device's. ``reload_weights`` reaches every replica.

An image is a path, a uint8 [H, W, 3] array or a float array in [0, 1]
(or [0, 255]), of any size: paths go through the native batch decoder
(``data/native_loader.decode_batch``: libjpeg with DCT-domain scaling for
JPEG files, the port's PNG reader and Pillow's bilinear resize for the
rest, the JAX package's bytes either way), and arrays of another size are
resized with ``data/image_io.resize_u8``, Pillow's bilinear filter byte
for byte, as the JAX pipeline resizes them with Pillow. ``batch_size``
with no ``batch_buckets`` is the one bucket, as in the JAX pipeline.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from depth_image_captioning_pub_torch.data.tokenizer import (
    SPECIAL, ids_to_caption)
from depth_image_captioning_pub_torch.engine.evaluate import make_caption_fn
from depth_image_captioning_pub_torch.ops.decode import gumbel_noise
from depth_image_captioning_pub_torch.parallel.mesh import (
    pad_batch_to_devices)
from depth_image_captioning_pub_torch.utils import tracing

ImageLike = Union[str, np.ndarray]


class _SharedNoise:
    """One chunk's noise over the replicas: the draw of step t at the
    whole chunk's shape, made once, in the order the replicas ask for it
    (replica 0's whole loop first, each later one from the step where the
    earlier ones stopped: one device's order); replica r takes its
    rows."""

    def __init__(self, generator: torch.Generator, replicas: int):
        self.generator, self.replicas = generator, replicas
        self.draws: Dict = {}

    def rows(self, key, shape, r: int, device) -> torch.Tensor:
        n = shape[0]
        if key not in self.draws:
            self.draws[key] = gumbel_noise((n * self.replicas, *shape[1:]),
                                           self.generator)
        return self.draws[key][r * n:(r + 1) * n].to(device)


def row_steps(tokens: np.ndarray, end_id: Optional[int]) -> np.ndarray:
    """Per row of ``tokens``, the decode steps up to and including its
    first <end> (all of them where it has none, or ``end_id`` is None)."""
    if end_id is None:
        return np.full(len(tokens), tokens.shape[1])
    ended = tokens == end_id
    return np.where(ended.any(1), ended.argmax(1) + 1, tokens.shape[1])


def _replica(cap, device):
    """A copy of the captioner on ``device``."""
    rep = copy.deepcopy(cap).to(device)
    rep.device = torch.device(device)
    return rep


class CaptionPipeline:
    """Batched captioning over one captioner (a depth kind with its
    ``depth_fn``): greedy, beam search when ``beam_size > 1``, or
    stochastic sampling when ``sample`` (soft greedy and beam search ignore
    ``seed``; beam search with ``sample`` raises); over the ``devices``
    given, one replica each."""

    _end_id: Optional[int] = None

    def __init__(self, cap, word_to_id: Dict[str, int],
                 id_to_word: Dict[int, str], *, depth_fn=None,
                 max_length: int = 30, batch_size: int = 64,
                 batch_buckets=None, image_hw=(224, 224), beam_size: int = 1,
                 length_penalty: float = 0.0, sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0, devices=None):
        self.cap = cap
        self.device = cap.device
        self._experiment = None     # (save_dir, files) of from_experiment
        self.max_length = int(max_length)
        self.id_to_word = id_to_word
        self.devices = [torch.device(d) for d in (devices or [cap.device])]
        if self.devices[0] != cap.device:
            self.cap = cap = _replica(cap, self.devices[0])
            self.device = cap.device
        self.batch_buckets = tuple(sorted({pad_batch_to_devices(
            int(b), len(self.devices))
            for b in (batch_buckets or (batch_size,))}))
        if self.batch_buckets[0] < 1:
            raise ValueError(f"bad batch_buckets {batch_buckets}")
        self.batch_size = self.batch_buckets[-1]   # the chunk size
        self.image_hw = tuple(image_hw)
        self.sample = bool(sample)
        self.seed = int(seed)
        hard = cap.spec.attention == "hard"
        self._reseed = hard and not self.sample   # per chunk
        self.generator = None
        if self.sample or hard:
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(self.seed)
        # the decode settings, as export.py records them
        self.depth_fn = depth_fn
        self.beam_size = int(beam_size)
        self.length_penalty = float(length_penalty)
        self.sampling = ({"temperature": temperature, "top_k": top_k,
                          "top_p": top_p} if self.sample else None)
        self._end_id = word_to_id.get(SPECIAL.end)
        self.replicas = [cap] + [_replica(cap, d) for d in self.devices[1:]]
        depth_fns = {}          # the frozen DPT: one per device
        if depth_fn is not None:
            model = getattr(depth_fn, "model", None)
            depth_fns[self.device if model is None else
                      next(model.parameters()).device] = depth_fn
        self._fns = []
        for rep in self.replicas:
            if depth_fn is not None and rep.device not in depth_fns:
                from depth_image_captioning_pub_torch.models.dpt import (
                    make_depth_fn)
                depth_fns[rep.device] = make_depth_fn(
                    copy.deepcopy(depth_fn.model).to(rep.device),
                    depth_fn.image_size)
            self._fns.append(make_caption_fn(
                rep, start_id=word_to_id[SPECIAL.start],
                max_length=self.max_length,
                depth_fn=depth_fns.get(rep.device),
                end_id=word_to_id.get(SPECIAL.end), beam_size=beam_size,
                length_penalty=length_penalty, sampling=self.sampling,
                generator=self.generator))
        self._fn = self._fns[0]

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
        for rep in self.replicas:
            params_from_jax(rep, trainable, {"encoder": frozen_enc},
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
        with tracing.request("pipeline.request"):
            pending = []      # (dispatched tokens, valid) one chunk ahead
            rows = [np.zeros((0, self.max_length), np.int32)]
            for lo in range(0, arrays.shape[0], self.batch_size):
                chunk = arrays[lo:lo + self.batch_size]
                valid = chunk.shape[0]
                bucket = next(b for b in self.batch_buckets if b >= valid)
                with tracing.span("pipeline.chunk", rows=valid,
                                  bucket=bucket):
                    if valid < bucket:
                        reps = np.zeros((bucket - valid,), np.int64)
                        chunk = np.concatenate([chunk, chunk[reps]], axis=0)
                    chunk = np.ascontiguousarray(chunk)
                    images = torch.from_numpy(chunk)
                    if self._reseed:
                        self.generator.manual_seed(self.seed)
                    pending.append((self._dispatch(images), valid))
                if len(pending) > 1:
                    rows.append(self._drain(*pending.pop(0)))
            for parts, valid in pending:
                rows.append(self._drain(parts, valid))
        return np.concatenate(rows, axis=0)

    def _drain(self, parts: List[torch.Tensor], valid: int) -> np.ndarray:
        """A chunk's tokens on the host, its padding rows dropped."""
        with tracing.span("pipeline.drain"):
            tokens = np.concatenate([p.cpu().numpy() for p in parts])
        if tracing.enabled():
            self._count(tokens, valid)
        return tokens[:valid]

    def _count(self, tokens: np.ndarray, valid: int) -> None:
        """The tracer's counters of one drained chunk: its rows and, from
        its tokens, the valid rows' steps (the decode path counts the
        steps it ran)."""
        tracing.count("chunks")
        tracing.count("rows", valid)
        tracing.count("padding_rows", len(tokens) - valid)
        tracing.count("decode.row_steps",
                      int(row_steps(tokens[:valid], self._end_id).sum()))

    def _dispatch(self, images: torch.Tensor) -> List[torch.Tensor]:
        """Launch one chunk: the whole chunk on the one device, or each
        replica's contiguous rows on its device (all launched before any
        is waited on); returns the parts' token tensors in order."""
        if len(self.devices) == 1:
            with tracing.span("pipeline.h2d"):
                images = images.to(self.device)
            return [self._fn(images)]
        per = images.shape[0] // len(self.replicas)
        shared = _SharedNoise(self.generator, len(self.replicas)) \
            if self.generator is not None else None
        vocab = self.cap.decoder.vocab_size
        parts = []
        for r, (fn, rep) in enumerate(zip(self._fns, self.replicas)):
            hooks = {}
            if shared is not None:
                dev = rep.device
                if self.cap.spec.attention == "hard":
                    hooks["att_noise"] = (
                        lambda t, shape, r=r, dev=dev:
                        shared.rows(("regions", t), shape, r, dev))
                if self.sample:
                    hooks["noise"] = (
                        lambda t, r=r, dev=dev:
                        shared.rows(("tokens", t), (per, vocab), r, dev))
            with tracing.span("pipeline.h2d"):
                part = images[r * per:(r + 1) * per].to(rep.device)
            parts.append(fn(part, **hooks))
        return parts

    def _to_arrays(self, images: Sequence[ImageLike]) -> np.ndarray:
        """Paths and arrays -> [N, H, W, 3] uint8 at ``image_hw`` (the JAX
        pipeline's ``_to_arrays``, with the port's decoder and resize)."""
        from depth_image_captioning_pub_torch.data.image_io import resize_u8
        from depth_image_captioning_pub_torch.data.native_loader import (
            decode_batch)
        h, w = self.image_hw
        out = np.zeros((len(images), h, w, 3), np.uint8)
        paths = [(i, im) for i, im in enumerate(images) if isinstance(im, str)]
        if paths:
            decoded = decode_batch([p for _, p in paths], self.image_hw)
            for (i, _), arr in zip(paths, decoded):
                out[i] = arr
        for i, im in enumerate(images):
            if isinstance(im, str):
                continue
            arr = np.asarray(im)
            if arr.dtype != np.uint8:
                arr = np.clip(arr * 255.0 if arr.max() <= 1.0 else arr,
                              0, 255).astype(np.uint8)
            if arr.shape[:2] != (h, w):
                arr = resize_u8(arr, (h, w))
            out[i] = arr
        return out

    def __call__(self, images: Union[ImageLike, Sequence[ImageLike]]
                 ) -> Union[str, List[str]]:
        """One path or [H,W,3] image -> a caption; [N,H,W,3] or a list of
        paths and images -> a list of captions."""
        single = isinstance(images, (str, np.ndarray)) and (
            not isinstance(images, np.ndarray) or images.ndim == 3)
        batch: List[ImageLike] = [images] if single else list(images)
        caps = [ids_to_caption(row, self.id_to_word)
                for row in self.caption_tokens(self._to_arrays(batch))]
        return caps[0] if single else caps
