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
Not ported yet (``ROADMAP.md``, Queue A items 7.2-7.5): the frozen-feature
cache, gradient accumulation, the bf16 decoder and the profiler window;
asking for any of them raises.
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
    TRAIN_REST_ITEM, attention_eval_step, attention_train_step,
    batch_to_device, check_accum_steps, make_optimizer, nic_eval_step,
    nic_train_step)
from depth_image_captioning_pub_torch.models.captioner import (
    Captioner, CaptionerSpec, build_captioner)
from depth_image_captioning_pub_torch.utils.checkpoint import (
    TrainCheckpointer, save_component)
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    encoder_from_jax, params_from_jax, params_to_jax)
from depth_image_captioning_pub_torch.utils.logging import (
    CsvLossLog, JsonlLog, ProgressMeter)

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


def _refuse_unported(cfg: ConfigTrain, feature_cache: bool) -> None:
    asked = []
    if cfg.grad_accum != 1:
        check_accum_steps(cfg.grad_accum)
    if feature_cache:
        asked.append(f"feature_cache ({TRAIN_REST_ITEM}.2)")
    if cfg.decoder_dtype != "float32":
        asked.append(f"decoder_dtype={cfg.decoder_dtype} "
                     f"({TRAIN_REST_ITEM}.4)")
    if cfg.profile_dir:
        asked.append(f"profile_dir ({TRAIN_REST_ITEM}.5)")
    if asked:
        raise NotImplementedError(f"{', '.join(asked)}: not ported yet")


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

    Returns {"best_val_loss", "final_train_loss", "train_seconds",
    "train_rows", "epoch_train_seconds"}: the seconds of every epoch's
    train loop (to the fetch of its loss; summed, and a list by epoch)
    and the valid (non-pad) rows it trained.
    """
    cfg = cfg or ConfigTrain()
    _refuse_unported(cfg, feature_cache)
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

    save_directory = cfg.save_dir(_save_dir_kind(kind), use_ori)
    os.makedirs(save_directory, exist_ok=True)
    prefix = _KIND_PREFIX[kind]
    suffix = f"{use_data}{ext}" if kind != "nic" else f"{ext}"
    sep = "_" if kind != "nic" else ""
    train_csv = CsvLossLog(
        f"{save_directory}/{prefix}_train_loss{sep}{suffix}.csv")
    val_csv = CsvLossLog(f"{save_directory}/{prefix}_val_loss{sep}{suffix}.csv")
    jsonl = (JsonlLog(f"{save_directory}/{prefix}_metrics_{suffix}.jsonl")
             if cfg.log_jsonl else None)

    cap = build_captioner(kind, len(word_to_id), cfg,
                          resnet_layers=resnet_layers, device=device)
    if initial is not None:
        params_from_jax(cap, *initial)
    else:
        cap.init(torch.Generator().manual_seed(cfg.seed + ext))
    if resnet_variables is not None:
        encoder_from_jax(cap, resnet_variables)
    dev = cap.device
    opt = make_optimizer(cap, cfg.lr)

    nic = cap.spec.is_nic
    alpha_reg = cfg.alpha_reg if cap.spec.attention == "soft" else 0.0
    val_provider = val_depth_provider or depth_provider

    def to_device(batch, provider):
        depth = (provider(batch.images, batch.indices)
                 if cap.spec.uses_depth else None)
        return batch_to_device(batch, dev, depth)

    base_seed = cfg.seed * 7919 + ext
    epochs = num_epochs if num_epochs is not None else cfg.num_epochs
    run = {"best_val": float("inf"), "train_loss": float("nan"),
           "train_rows": 0, "epoch_seconds": []}
    start_epoch, mid = 0, None

    ckptr = None
    if checkpoint_every or resume:
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
        return ckptr is not None and (flag.is_set() or (
            preempt_event is not None and preempt_event.is_set()))

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
        ckptr.save(epoch, state)
        ckptr.wait()
        if not quiet:
            print(f"preempted: checkpoint saved at {where}")
        return summary(preempted=1.0)

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
                start=n_steps))
            try:
                for batch in it:
                    dev_batch = to_device(batch, depth_provider)
                    if nic:
                        metrics = nic_train_step(cap, opt, dev_batch,
                                                 generator=gen)
                    else:
                        metrics = attention_train_step(
                            cap, opt, dev_batch, temp=temp,
                            alpha_reg=alpha_reg, generator=gen)
                    loss_dev = metrics["loss"]
                    loss_sum = (loss_dev if loss_sum is None
                                else loss_sum + loss_dev)
                    n_steps += 1
                    run["train_rows"] += int(batch.pad_mask.sum())
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
            train_csv.append(epoch, train_loss)
            if not quiet:
                print(f"[epoch:{epoch}] train loss: {train_loss}")

            val_sum, n_val = None, 0
            itv = Prefetcher(train_batches(
                val_ds, word_to_id, cfg.batch_size, cfg.max_caption_len,
                shuffle=False, seed=cfg.seed, epoch=epoch))
            try:
                for batch in itv:
                    dev_batch = to_device(batch, val_provider)
                    metrics = (nic_eval_step(cap, dev_batch) if nic else
                               attention_eval_step(cap, dev_batch,
                                                   alpha_reg=alpha_reg,
                                                   generator=gen))
                    val_sum = (metrics["loss"] if val_sum is None
                               else val_sum + metrics["loss"])
                    n_val += 1
            finally:
                itv.close()
            val_loss = float(val_sum) / n_val if n_val else float("nan")
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
                _save_best(save_directory, prefix, suffix, sep, cap)
                if not quiet:
                    print("best model parameters are changed")
            if preempted():
                # raised during validation: the epoch is whole, so the
                # checkpoint is an ordinary end-of-epoch one
                return finish_preempted(epoch, f"end of epoch {epoch}",
                                        payload(epoch))
            if checkpoint_every and (epoch + 1) % checkpoint_every == 0:
                ckptr.save(epoch, payload(epoch))
    finally:
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
