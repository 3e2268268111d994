"""The training loop (counterpart of the JAX ``engine/train.py``).

One loop trains every kind: shuffled fixed-shape batches
(``data/pipeline.train_batches``, the JAX package's batches for the same
seed), one AdamW step each (``engine/steps.py``), the mean train loss
fetched from the card once an epoch, a validation pass, the reference's
per-epoch CSV rows and a JSONL record, and the best-validation-loss
components written in the JAX trainer's files (``_save_best``), which this
package's ``evaluation.py`` and the JAX package's evaluation scripts both
read. Depth kinds take their maps from a ``depth_provider(images,
indices)`` (``engine/depth_cache.py``).

Noise: one ``torch.Generator`` on the captioner's device an epoch, seeded
from (``cfg.seed * 7919 + ext``, epoch), draws the dropout masks and hard
attention's Gumbel noise of that epoch's steps and validation. The JAX
package's keys cannot be reproduced, so two packages agree on a run only
without noise (``dropout=0``, soft attention); the tests hold the steps to
JAX on its own draws through the decoders' hooks.

Full-state checkpoints, ``resume`` and the SIGTERM save are those of the
JAX trainer, in a file format of the port's own (``train``'s docstring).
The JAX trainer's options are all here: ``feature_cache`` (the frozen
encoder's outputs cached once per image, ``engine/feature_cache.py``),
``cfg.grad_accum`` (microbatches per step, ``engine/steps.py``; batches
padded to a multiple of it), ``cfg.decoder_dtype`` ("bfloat16": the
mixed-precision decoder, f32 parameters and AdamW state) and the
profiler window (``cfg.profile_dir``, ``profile_start``, ``profile_stop``:
``utils/logging.ProfilerTrace`` over those host steps, counted across
epochs).

Data parallel (the JAX trainer's mesh): in a process group of R ranks
(``parallel/multihost.initialize``, one process per card under
``torchrun``) rank 0's weights are broadcast to every rank, every rank
builds the same shuffled order and decodes only its contiguous rows of
each global batch (padded to a multiple of R * ``grad_accum``), and the
steps combine the ranks into the single-device step
(``engine/steps.py``); the generator draws the whole batch's noise and
each rank keeps its rows. Rank 0 alone writes the logs, the best-val
files, the checkpoints and the feature cache (the others wait for it);
every rank restores on ``resume``; a preemption seen by any rank stops
all of them after the same step.
"""

from __future__ import annotations

import math
import os
import signal
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from depth_image_captioning_pub_torch.config import ConfigTrain
from depth_image_captioning_pub_torch.data.coco import CocoCaptions
from depth_image_captioning_pub_torch.data.pipeline import (
    Prefetcher, train_batches)
from depth_image_captioning_pub_torch.data.vocab import load_vocab
from depth_image_captioning_pub_torch.engine.steps import (
    attention_eval_step, attention_train_step,
    batch_to_device, check_accum_steps, frozen_features, make_optimizer,
    nic_eval_step, nic_train_step)
from depth_image_captioning_pub_torch.models.captioner import (
    Captioner, CaptionerSpec, build_captioner)
from depth_image_captioning_pub_torch.parallel.mesh import (
    any_rank, barrier, make_mesh, pad_batch_to_devices, replicate)
from depth_image_captioning_pub_torch.utils.checkpoint import (
    TrainCheckpointer, save_component)
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    encoder_from_jax, params_from_jax, params_to_jax)
from depth_image_captioning_pub_torch.utils.logging import (
    CsvLossLog, JsonlLog, ProfilerTrace, ProgressMeter)

_KIND_PREFIX = {"base-soft": "base_soft", "base-hard": "base_hard",
                "depth-soft": "depth_soft", "depth-hard": "depth_hard",
                "mdepth-soft": "mdepth_soft", "mdepth-hard": "mdepth_hard",
                "nic": "nic"}


def gumbel_temperature(epoch: int, temp_sch: int = 10) -> float:
    """Hard attention's temperature: 1.0 for the first ``temp_sch`` epochs,
    then max(cos(pi * e / 360), 0.5) at e = epoch rounded down to a
    multiple of ``temp_sch``."""
    if epoch < temp_sch:
        return 1.0
    e = (epoch // temp_sch) * temp_sch
    return float(max(math.cos(math.pi * e / 360.0), 0.5))


def _save_dir_kind(kind: str) -> str:
    return {"base-soft": "soft", "base-hard": "hard",
            "depth-soft": "depth_soft", "depth-hard": "depth_hard",
            "mdepth-soft": "depth_soft", "mdepth-hard": "depth_hard",
            "nic": "nic"}[kind]


DECODER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def decoder_dtype(cfg: ConfigTrain) -> torch.dtype:
    """``cfg.decoder_dtype`` as a torch dtype; ValueError for another
    name."""
    if cfg.decoder_dtype not in DECODER_DTYPES:
        raise ValueError(f"decoder_dtype {cfg.decoder_dtype!r} is not one "
                         f"of {sorted(DECODER_DTYPES)}")
    return DECODER_DTYPES[cfg.decoder_dtype]


def feature_providers(cap: Captioner, train_ds, val_ds, cache_dir: str,
                      batch_size: int, quiet: bool = False):
    """(train, val) providers of the frozen features, each from its
    split's cache under ``cache_dir`` (built first where missing or
    stale): ``engine/feature_cache.build_or_open``. Over several ranks
    rank 0 builds, and the others open the caches once it is done."""
    from depth_image_captioning_pub_torch.engine import feature_cache as fc
    frozen = cap.backbone if cap.spec.is_nic else cap.encoder
    probe = torch.from_numpy(np.stack([train_ds.load_image(0)])).to(
        cap.device)
    with torch.inference_mode():
        out = frozen_features(cap, probe)

    def encode(images):
        return frozen_features(cap, images)

    shape = tuple(out.shape[1:])
    digest = fc.frozen_digest(frozen, out.dtype, shape)

    def providers():
        return tuple(fc.build_or_open(
            cache_dir, split, ds, encode, frozen, shape, out.dtype,
            cap.device, batch_size=batch_size, quiet=quiet, digest=digest)
            for split, ds in (("train", train_ds), ("val", val_ds)))
    if make_mesh().rank == 0:
        built = providers()
        barrier()
        return built
    barrier()
    return providers()


def device_batch(cap: Captioner, batch, depth_provider=None,
                 feature_provider=None):
    """(device batch, cached features or None) of one host batch, as each
    train and validation step takes it: for depth kinds the
    ``depth_provider``'s maps (it reads the host pixels); with a
    ``feature_provider`` the batch's cached features and no images (the
    step does not run the frozen encoder)."""
    depth = (depth_provider(batch.images, batch.indices)
             if cap.spec.uses_depth else None)
    feats = (None if feature_provider is None else
             feature_provider(batch.indices).to(cap.device,
                                                non_blocking=True))
    return batch_to_device(batch, cap.device, depth,
                           images=feats is None), feats


def trainable_modules(cap: Captioner) -> Dict[str, torch.nn.Module]:
    """The modules whose state a train checkpoint holds: the decoder,
    NIC's projection, the depth encoder (its BN running statistics
    included). The frozen encoder is rebuilt from its file."""
    names = ["decoder", "projection" if cap.spec.is_nic else None,
             "depth_module" if cap.depth_module is not None else None]
    return {n: getattr(cap, n) for n in names if n is not None}


def train(kind: str, ext: int, use_data: str = "coco",
          cfg: Optional[ConfigTrain] = None,
          depth_provider: Optional[Callable] = None,
          val_depth_provider: Optional[Callable] = None,
          datasets=None, word_to_id=None,
          num_epochs: Optional[int] = None,
          resnet_variables=None,
          quiet: bool = False,
          resnet_layers=None,
          device="cuda",
          initial=None,
          resume: bool = False,
          checkpoint_every: int = 0,
          preempt_save: bool = True,
          preempt_event: Optional[threading.Event] = None,
          feature_cache: bool = False) -> Dict[str, float]:
    """Train one configuration on ``device``; returns summary metrics.

    kind: one of ``models.captioner.PORTED_KINDS``; ext: the run index
    (the reference trains each configuration three times); use_data:
    "coco" | "original". ``depth_provider(images, indices)`` -> [B, H, W,
    1] standardized depth maps, required by depth kinds;
    ``val_depth_provider`` serves the validation set (default: the same
    provider). ``datasets=(train_ds, val_ds)`` and ``word_to_id`` replace
    reading the config's files. ``resnet_variables``: a flax encoder tree
    for the frozen backbone. ``initial``: the JAX package's (trainable,
    frozen, batch_stats) trees to start from (the tests' JAX init);
    otherwise the weights are drawn from ``cfg.seed + ext``.

    Checkpoints (``checkpoint_every`` or ``resume``): every
    ``checkpoint_every`` epochs a full-state checkpoint
    (``utils/checkpoint.TrainCheckpointer``, ``cfg.checkpoint_keep``
    newest kept, written by a background thread) under
    ``full_state_{prefix}_{suffix}/`` of the save directory: the trainable
    modules' state (BN running statistics included), the AdamW state, the
    epoch, the best validation loss, the summary fields and, in a
    mid-epoch checkpoint, the batches consumed, the epoch's loss sum on
    the device (f32, as summed) and its generator's state. SIGTERM (on the
    main thread, with a checkpointer and ``preempt_save``), or
    ``preempt_event`` set, finishes the step in flight, saves a mid-epoch
    checkpoint (at the end of an epoch, an end-of-epoch one) and returns
    with ``"preempted": 1.0``. ``resume`` restores the latest checkpoint:
    after an end-of-epoch one the next epoch starts; after a mid-epoch one
    the same epoch continues at the next batch (the consumed batches are
    skipped without decoding their images, their caption draws replayed),
    its generator where the consumed steps left it, so the run goes on as
    a straight run would. The frozen encoder is not saved: it is rebuilt
    from ``resnet_variables`` or the seed.

    ``feature_cache``: the frozen encoder's outputs of every train and
    val image, computed once into digest-keyed memmaps under
    ``<save dir>/feat_cache`` (``engine/feature_cache.py``), feed every
    epoch's steps instead of the encoder; depth kinds still take their
    maps from ``depth_provider``. ``cfg.grad_accum`` k: each step
    accumulates over k microbatches (batches padded to a multiple of k);
    ``cfg.decoder_dtype``: "float32" or "bfloat16" (the mixed-precision
    decoder); ``cfg.profile_dir``: a ``torch.profiler`` window over host
    steps [``profile_start``, ``profile_stop``), counted from the run's
    first step across epochs (a resumed run goes on counting), closed
    early when the run ends or is preempted inside it.

    Returns {"best_val_loss", "final_train_loss", "train_seconds",
    "train_rows", "epoch_train_seconds"}: the seconds of every epoch's
    train loop (to the fetch of its loss; summed, and a list by epoch)
    and the valid (non-pad) rows it trained.
    """
    cfg = cfg or ConfigTrain()
    check_accum_steps(cfg.grad_accum)
    dec_dtype = decoder_dtype(cfg)
    if CaptionerSpec.from_kind(kind).uses_depth and depth_provider is None:
        raise ValueError(f"{kind} needs a depth_provider")
    use_ori = use_data == "original"
    if word_to_id is None:
        path = cfg.ori_word_to_id_file if use_ori else cfg.word_to_id_file
        word_to_id, _ = load_vocab(path)
    if datasets is None:
        train_anno = cfg.ori_train_anno_file if use_ori else cfg.train_anno_file
        val_anno = cfg.ori_val_anno_file if use_ori else cfg.val_anno_file
        train_ds = CocoCaptions(cfg.train_img_directory, train_anno)
        val_ds = CocoCaptions(cfg.val_img_directory, val_anno)
    else:
        train_ds, val_ds = datasets

    mesh = make_mesh()
    lead = mesh.rank == 0       # the one rank that writes and prints
    quiet = quiet or not lead
    save_directory = cfg.save_dir(_save_dir_kind(kind), use_ori)
    prefix = _KIND_PREFIX[kind]
    suffix = f"{use_data}{ext}" if kind != "nic" else f"{ext}"
    sep = "_" if kind != "nic" else ""
    train_csv = val_csv = jsonl = None
    if lead:
        os.makedirs(save_directory, exist_ok=True)
        train_csv = CsvLossLog(
            f"{save_directory}/{prefix}_train_loss{sep}{suffix}.csv")
        val_csv = CsvLossLog(
            f"{save_directory}/{prefix}_val_loss{sep}{suffix}.csv")
        jsonl = (JsonlLog(f"{save_directory}/{prefix}_metrics_{suffix}.jsonl")
                 if cfg.log_jsonl else None)

    cap = build_captioner(kind, len(word_to_id), cfg,
                          resnet_layers=resnet_layers, device=device,
                          decoder_dtype=dec_dtype)
    if initial is not None:
        params_from_jax(cap, *initial)
    else:
        cap.init(torch.Generator().manual_seed(cfg.seed + ext))
    if resnet_variables is not None:
        encoder_from_jax(cap, resnet_variables)
    replicate(mesh, [cap])
    dev = cap.device
    opt = make_optimizer(cap, cfg.lr)
    feature_provider = val_feature_provider = None
    if feature_cache:
        feature_provider, val_feature_provider = feature_providers(
            cap, train_ds, val_ds, f"{save_directory}/feat_cache",
            cfg.batch_size, quiet=quiet)
    accum = cfg.grad_accum
    # each rank's rows must split into the k microbatches
    pad_to = pad_batch_to_devices(cfg.batch_size, mesh.size * accum)
    shard = (mesh.rank, mesh.size)

    nic = cap.spec.is_nic
    alpha_reg = cfg.alpha_reg if cap.spec.attention == "soft" else 0.0
    val_provider = val_depth_provider or depth_provider

    base_seed = cfg.seed * 7919 + ext
    epochs = num_epochs if num_epochs is not None else cfg.num_epochs
    run = {"best_val": float("inf"), "train_loss": float("nan"),
           "train_rows": 0, "epoch_seconds": [], "steps": 0}
    start_epoch, mid = 0, None

    ckptr = None
    if checkpoint_every or resume:
        barrier()       # rank 0 made the save directory
        ckptr = TrainCheckpointer(
            f"{save_directory}/full_state_{prefix}_{suffix}",
            async_save=True, keep=cfg.checkpoint_keep)
        if resume and (last := ckptr.latest_step()) is not None:
            state = ckptr.restore(last)
            for name, module in trainable_modules(cap).items():
                module.load_state_dict(state["modules"][name])
            opt.load_state_dict(state["optimizer"])
            run = state["run"]
            if state["mid_epoch"]:
                start_epoch, mid = state["epoch"], state
                if not quiet:
                    print(f"resumed mid-epoch {start_epoch} at batch "
                          f"{state['batches_done']}")
            else:
                start_epoch = state["epoch"] + 1
                if not quiet:
                    print(f"resumed from epoch {state['epoch']}")

    def payload(epoch, gen=None, loss_sum=None, batches_done=0,
                seconds=0.0):
        return {"modules": {name: m.state_dict()
                            for name, m in trainable_modules(cap).items()},
                "optimizer": opt.state_dict(), "run": run, "epoch": epoch,
                "mid_epoch": gen is not None, "batches_done": batches_done,
                "loss_sum": loss_sum, "seconds": seconds,
                "generator": None if gen is None else gen.get_state()}

    # SIGTERM sets a flag that the loop reads after each step and at the
    # end of each epoch; only with a checkpointer (there is nothing to
    # save into otherwise) and only on the main thread (signal rules)
    flag = threading.Event()

    def preempted() -> bool:
        # over ranks, every rank stops once any rank was asked to
        return ckptr is not None and any_rank(flag.is_set() or (
            preempt_event is not None and preempt_event.is_set()), dev)

    trap = (ckptr is not None and preempt_save
            and threading.current_thread() is threading.main_thread())
    prev_handler = (signal.signal(signal.SIGTERM, lambda s, f: flag.set())
                    if trap else None)

    def summary(**extra):
        return dict(extra, best_val_loss=run["best_val"],
                    final_train_loss=run["train_loss"],
                    train_seconds=sum(run["epoch_seconds"]),
                    train_rows=run["train_rows"],
                    epoch_train_seconds=list(run["epoch_seconds"]))

    def finish_preempted(epoch, where, state):
        if lead:
            ckptr.save(epoch, state)
            ckptr.wait()
        if not quiet:
            print(f"preempted: checkpoint saved at {where}")
        return summary(preempted=1.0)

    trace = ProfilerTrace(cfg.profile_dir)
    try:
        for epoch in range(start_epoch, epochs):
            gen = torch.Generator(device=dev)
            gen.manual_seed(base_seed * 1_000_003 + epoch)
            loss_sum, n_steps, seconds = None, 0, 0.0
            if mid is not None:     # re-enter the preempted epoch
                gen.set_state(mid["generator"])
                n_steps, seconds = mid["batches_done"], mid["seconds"]
                loss_sum = mid["loss_sum"].to(dev)
                mid = None
            temp = gumbel_temperature(epoch, cfg.temp_sch)
            meter = ProgressMeter(cfg.moving_avg, desc=f"[epoch {epoch + 1}]",
                                  quiet=quiet)
            t0 = time.time() - seconds
            it = Prefetcher(train_batches(
                train_ds, word_to_id, cfg.batch_size, cfg.max_caption_len,
                shuffle=True, seed=cfg.seed + ext, epoch=epoch,
                pad_to=pad_to, start=n_steps, shard=shard))
            try:
                for batch in it:
                    dev_batch, feats = device_batch(
                        cap, batch, depth_provider, feature_provider)
                    host_step = run.get("steps", 0)
                    if host_step == cfg.profile_start:
                        trace.maybe_start()
                    if nic:
                        metrics = nic_train_step(
                            cap, opt, dev_batch, generator=gen,
                            features=feats, accum_steps=accum)
                    else:
                        metrics = attention_train_step(
                            cap, opt, dev_batch, temp=temp,
                            alpha_reg=alpha_reg, generator=gen,
                            features=feats, accum_steps=accum)
                    run["steps"] = host_step + 1
                    if run["steps"] == cfg.profile_stop:
                        trace.maybe_stop()
                    loss_dev = metrics["loss"]
                    loss_sum = (loss_dev if loss_sum is None
                                else loss_sum + loss_dev)
                    # the global batch's real rows
                    run["train_rows"] += min(
                        cfg.batch_size,
                        len(train_ds) - n_steps * cfg.batch_size)
                    n_steps += 1
                    meter.update_lazy(lambda ld=loss_dev: ld)
                    if preempted():
                        meter.close()
                        return finish_preempted(
                            epoch, f"batch {n_steps} of epoch {epoch}",
                            payload(epoch, gen, loss_sum, n_steps,
                                    time.time() - t0))
            finally:
                it.close()
            meter.close()
            # the epoch's one fetch from the card
            train_loss = (float(loss_sum) / n_steps if n_steps
                          else float("nan"))
            run["train_loss"] = train_loss
            run["epoch_seconds"].append(time.time() - t0)
            if lead:
                train_csv.append(epoch, train_loss)
            if not quiet:
                print(f"[epoch:{epoch}] train loss: {train_loss}")

            val_sum, n_val = None, 0
            itv = Prefetcher(train_batches(
                val_ds, word_to_id, cfg.batch_size, cfg.max_caption_len,
                shuffle=False, seed=cfg.seed, epoch=epoch, pad_to=pad_to,
                shard=shard))
            try:
                for batch in itv:
                    dev_batch, feats = device_batch(
                        cap, batch, val_provider, val_feature_provider)
                    metrics = (nic_eval_step(cap, dev_batch, features=feats)
                               if nic else
                               attention_eval_step(cap, dev_batch,
                                                   alpha_reg=alpha_reg,
                                                   generator=gen,
                                                   features=feats))
                    val_sum = (metrics["loss"] if val_sum is None
                               else val_sum + metrics["loss"])
                    n_val += 1
            finally:
                itv.close()
            val_loss = float(val_sum) / n_val if n_val else float("nan")
            if lead:
                val_csv.append(epoch, val_loss)
            if not quiet:
                print(f"[epoch:{epoch}] Validation loss: {val_loss}")
            if jsonl:
                jsonl.append({"epoch": epoch, "train_loss": train_loss,
                              "val_loss": val_loss,
                              "epoch_seconds": time.time() - t0,
                              "temp": float(np.float32(temp))})
            if val_loss < run["best_val"]:
                run["best_val"] = val_loss
                if lead:
                    _save_best(save_directory, prefix, suffix, sep, cap)
                if not quiet:
                    print("best model parameters are changed")
            if preempted():
                # raised during validation: the epoch is whole, so the
                # checkpoint is an ordinary end-of-epoch one
                return finish_preempted(epoch, f"end of epoch {epoch}",
                                        payload(epoch))
            if (lead and checkpoint_every
                    and (epoch + 1) % checkpoint_every == 0):
                ckptr.save(epoch, payload(epoch))
    finally:
        # the window outran the run, or a preemption landed inside it:
        # close it so that its trace is written
        trace.maybe_stop()
        if trap:    # None: a handler not installed from Python
            signal.signal(signal.SIGTERM, prev_handler
                          if prev_handler is not None else signal.SIG_DFL)
        if ckptr is not None:
            ckptr.close()
    return summary()


def _save_best(save_directory: str, prefix: str, suffix: str, sep: str,
               cap: Captioner) -> None:
    """The best-validation components under the reference's basenames, in
    the JAX trainer's msgpack files: encoder, decoder, NIC's
    ``enc_linear``, and the depth encoder's ``{"params",
    "batch_stats"}``."""
    trainable, frozen, stats = params_to_jax(cap)

    def name(component):
        return f"{save_directory}/{prefix}_{component}_best{sep}{suffix}.pth"

    save_component(name("encoder"), frozen["encoder"])
    save_component(name("decoder"), trainable["decoder"])
    if "enc_linear" in trainable:
        save_component(name("enc_linear"), trainable["enc_linear"])
    if "depth_encoder" in trainable:
        save_component(name("D_encoder"),
                       {"params": trainable["depth_encoder"],
                        "batch_stats": stats})
