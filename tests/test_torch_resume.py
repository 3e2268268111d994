"""Resumable training in the port, held against the port's own straight
runs on the CPU (the pattern of ``tests/test_checkpoint_resume.py`` and
``tests/test_preempt_resume.py`` for the JAX trainer).

* ``utils/checkpoint.TrainCheckpointer``: a round trip, synchronous and
  through its writer thread (the snapshot is taken before ``save``
  returns), ``keep`` pruning, and a write cut short never becoming
  ``latest_step``.
* ``engine/train.train``: 1 epoch with ``checkpoint_every=1``, then
  ``resume`` to 2 epochs, equals a straight 2-epoch run: the CSV rows
  ``==``, the best-val files byte-equal, the final parameters, BN
  statistics and AdamW state ``array_equal``; for base-soft, base-hard
  (dropout and the Gumbel draws: the generator) and depth-soft (the depth
  CNN's trained BN). A preemption through ``preempt_event`` after a step
  saves a mid-epoch checkpoint, and the resumed run equals the straight
  one (skipped batches' images are not decoded); one raised during
  validation saves an end-of-epoch checkpoint and the resume starts the
  next epoch; a real SIGTERM (sent to this process by a step) is caught
  by the trap, which is restored afterwards.

The synthetic set: 20 in-memory 64x64 images (batch 4: 5 steps an epoch)
and 6 validation images, ResNet blocks 1,1,1,1, 10 tokens, dropout 0.5.
Every test runs on one intra-op thread: MKL may split a product over
fewer threads when the machine is busy, which sums in another order, and
two runs compared bit for bit must sum in one order.
"""

import os
import signal
import threading

import numpy as np
import pytest
import torch

from depth_image_captioning_pub_tpu.data.vocab import build_vocab
from depth_image_captioning_pub_torch.config import ConfigTrain
from depth_image_captioning_pub_torch.data.synthetic import SyntheticCaptions
from depth_image_captioning_pub_torch.engine import train as ttrain
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.utils.checkpoint import (
    TrainCheckpointer, host_copy)

LAYERS, HW, TRAIN, VAL, BATCH = (1, 1, 1, 1), 64, 20, 6, 4
STEPS = TRAIN // BATCH


class Rows:
    """Rows of an in-memory set as a dataset; counts decoded images."""

    def __init__(self, data, rows):
        self.data, self.rows, self.loads = data, list(rows), 0

    def __len__(self):
        return len(self.rows)

    def load_image(self, i):
        self.loads += 1
        return self.data.load_image(self.rows[i])

    def captions(self, i):
        return self.data.captions(self.rows[i])


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    d = SyntheticCaptions(TRAIN + VAL, image_hw=(HW, HW), seed=3)
    w2i, _ = build_vocab([c for i in range(len(d)) for c in d.captions(i)],
                         [], min_count=1)
    return d, w2i


def depth_provider(images, indices):
    """Each image's gray levels, nearest-upsampled to 224x224."""
    gray = np.asarray(images, np.float32).mean(axis=-1) / 255.0
    idx = (np.arange(224) * HW) // 224
    return gray[:, idx][:, :, idx][..., None]


class Run:
    """One ``train`` set-up under a directory of its own; ``caps`` keeps
    each run's captioner."""

    def __init__(self, root, data, kind, monkeypatch):
        self.kind, self.data, self.caps = kind, data, []
        cwd = os.getcwd()
        os.makedirs(root)
        os.chdir(root)
        try:
            self.cfg = ConfigTrain()
        finally:
            os.chdir(cwd)
        self.cfg.batch_size, self.cfg.max_caption_len = BATCH, 10
        self.train_ds = Rows(data[0], range(TRAIN))
        real = build_captioner

        def keep(*args, **kwargs):
            cap = real(*args, **kwargs)
            self.caps.append(cap)
            return cap
        monkeypatch.setattr(ttrain, "build_captioner", keep)

    def __call__(self, epochs, quiet=True, **kw):
        return ttrain.train(
            self.kind, 0, cfg=self.cfg,
            datasets=(self.train_ds, Rows(self.data[0],
                                          range(TRAIN, TRAIN + VAL))),
            word_to_id=self.data[1], num_epochs=epochs, quiet=quiet,
            resnet_layers=LAYERS, device="cpu",
            depth_provider=(depth_provider if "depth" in self.kind
                            else None), **kw)

    @property
    def save_dir(self):
        return self.cfg.save_dir(ttrain._save_dir_kind(self.kind), False)

    def files(self):
        """{name: bytes} of the run's CSV rows and best-val files."""
        return {n: open(os.path.join(self.save_dir, n), "rb").read()
                for n in sorted(os.listdir(self.save_dir))
                if n.endswith((".csv", ".msgpack"))}

    def checkpointer(self):
        prefix = ttrain._KIND_PREFIX[self.kind]
        suffix = "0" if self.kind == "nic" else "coco0"
        return TrainCheckpointer(
            f"{self.save_dir}/full_state_{prefix}_{suffix}")


def assert_same_run(got, want):
    """Equal files and equal final state (every tensor of the trainable
    modules, BN statistics included, and of AdamW)."""
    files = want.files()
    assert len(files) >= 4 and got.files() == files
    cap_g, cap_w = got.caps[-1], want.caps[-1]
    sd_g, sd_w = cap_g.state_dict(), cap_w.state_dict()
    assert list(sd_g) == list(sd_w)
    for k in sd_w:
        assert torch.equal(sd_g[k], sd_w[k]), k


def _straight(tmp_path, data, kind, monkeypatch, epochs=2):
    run = Run(tmp_path / "straight", data, kind, monkeypatch)
    run(epochs)
    return run


# ---- the checkpointer ------------------------------------------------------

def _state(x):
    return {"w": torch.full((3, 2), float(x)), "n": x, "f": 0.5 * x,
            "none": None, "list": [x, torch.arange(3) * x],
            "nested": {"s": torch.tensor(x, dtype=torch.float32)}}


def _assert_state(got, x):
    want = _state(x)
    assert got["n"] == want["n"] and got["f"] == want["f"]
    assert got["none"] is None and got["list"][0] == x
    for a, b in ((got["w"], want["w"]), (got["list"][1], want["list"][1]),
                 (got["nested"]["s"], want["nested"]["s"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpointer_round_trip(async_save, tmp_path):
    ck = TrainCheckpointer(str(tmp_path / "ck"), async_save=async_save)
    assert ck.latest_step() is None
    for step in (0, 1, 2):
        state = _state(step)
        ck.save(step, state)
        state["w"].add_(100.0)          # the next step's in-place update
        state["nested"]["s"].add_(100.0)
    assert ck.latest_step() == 2
    for step in (0, 1, 2):
        _assert_state(ck.restore(step), step)
    ck.save(2, _state(7))               # a step saved again is replaced
    _assert_state(ck.restore(2), 7)
    ck.close()
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "state_0.pt", "state_1.pt", "state_2.pt"]


def test_host_copy_is_a_copy():
    t = torch.ones(3)
    out = host_copy({"a": [t], "b": (t, 2)})
    t.add_(1.0)
    assert torch.equal(out["a"][0], torch.ones(3))
    assert isinstance(out["b"], tuple) and out["b"][1] == 2


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpointer_keep_prunes_after_a_write(async_save, tmp_path):
    ck = TrainCheckpointer(str(tmp_path), async_save=async_save, keep=2)
    for step in range(5):
        ck.save(step, _state(step))
        ck.wait()
        assert sorted(ck._steps()) == list(range(max(0, step - 1), step + 1))
    _assert_state(ck.restore(ck.latest_step()), 4)
    ck.close()


def test_a_cut_write_never_becomes_latest(tmp_path, monkeypatch):
    ck = TrainCheckpointer(str(tmp_path), async_save=True)
    ck.save(3, _state(3))
    real = torch.save

    def cut(obj, path):
        with open(path, "wb") as f:     # half a file, then the kill
            f.write(b"PK\x03\x04 partial")
        raise OSError("killed during the write")
    monkeypatch.setattr(torch, "save", cut)
    ck.save(4, _state(4))
    with pytest.raises(OSError, match="killed"):
        ck.wait()
    monkeypatch.setattr(torch, "save", real)
    assert ck.latest_step() == 3
    assert any(n.startswith("state_4.pt.tmp") for n in os.listdir(tmp_path))
    _assert_state(ck.restore(3), 3)
    (tmp_path / "state_x.pt").write_bytes(b"")       # not a step
    (tmp_path / "state_9.pt.tmp1").write_bytes(b"")  # a cut write's name
    assert ck.latest_step() == 3
    ck.close()


# ---- the trainer ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["base-soft", "base-hard", "depth-soft"])
def test_epoch_resume_equals_straight(kind, data, tmp_path, monkeypatch):
    want = _straight(tmp_path, data, kind, monkeypatch)
    run = Run(tmp_path / "resumed", data, kind, monkeypatch)
    first = run(1, checkpoint_every=1)
    assert "preempted" not in first
    state = run.checkpointer().restore(0)
    assert state["epoch"] == 0 and not state["mid_epoch"]
    assert set(state["modules"]) == set(ttrain.trainable_modules(
        run.caps[-1]))
    out = run(2, resume=True)
    assert out["train_rows"] == 2 * TRAIN
    assert len(out["epoch_train_seconds"]) == 2
    assert_same_run(run, want)


@pytest.mark.parametrize("kind,at", [("base-hard", 2), ("nic", 4)])
def test_mid_epoch_preempt_resume_equals_straight(kind, at, data, tmp_path,
                                                  monkeypatch):
    """Preempted after step ``at`` of epoch 1, resumed: the remaining steps
    draw the straight run's noise; the consumed batches are skipped
    without decoding their images."""
    want = _straight(tmp_path, data, kind, monkeypatch)
    run = Run(tmp_path / "resumed", data, kind, monkeypatch)
    event = threading.Event()
    name = "nic_train_step" if kind == "nic" else "attention_train_step"
    real, steps = getattr(ttrain, name), []

    def step(*args, **kwargs):
        out = real(*args, **kwargs)
        steps.append(1)
        if len(steps) == STEPS + at:
            event.set()
        return out
    monkeypatch.setattr(ttrain, name, step)
    out = run(2, checkpoint_every=1, preempt_event=event)
    assert out["preempted"] == 1.0
    state = run.checkpointer().restore(1)
    assert state["mid_epoch"] and state["batches_done"] == at
    assert state["loss_sum"].dtype == torch.float32
    assert state["run"]["train_rows"] == (STEPS + at) * BATCH
    event.clear()
    loads = run.train_ds.loads
    out = run(2, checkpoint_every=1, resume=True)
    assert "preempted" not in out and out["train_rows"] == 2 * TRAIN
    assert run.train_ds.loads - loads == (STEPS - at) * BATCH
    assert_same_run(run, want)


def test_epoch_end_preempt_starts_the_next_epoch(data, tmp_path,
                                                 monkeypatch, capsys):
    want = _straight(tmp_path, data, "base-soft", monkeypatch)
    run = Run(tmp_path / "resumed", data, "base-soft", monkeypatch)
    event = threading.Event()
    real = ttrain.attention_eval_step

    def eval_step(*args, **kwargs):
        event.set()                     # raised during validation
        return real(*args, **kwargs)
    monkeypatch.setattr(ttrain, "attention_eval_step", eval_step)
    out = run(2, checkpoint_every=5, preempt_event=event)
    assert out["preempted"] == 1.0 and out["train_rows"] == TRAIN
    ck = run.checkpointer()
    assert ck.latest_step() == 0
    assert not ck.restore(0)["mid_epoch"]
    monkeypatch.setattr(ttrain, "attention_eval_step", real)
    event.clear()
    run.train_ds.loads = 0
    capsys.readouterr()
    run(2, quiet=False, resume=True)
    assert "resumed from epoch 0" in capsys.readouterr().out
    assert run.train_ds.loads == TRAIN          # one epoch, not two
    assert_same_run(run, want)


def test_resume_without_a_checkpoint_and_after_the_end(data, tmp_path,
                                                       monkeypatch):
    want = _straight(tmp_path, data, "base-soft", monkeypatch)
    run = Run(tmp_path / "resumed", data, "base-soft", monkeypatch)
    run(2, resume=True)               # nothing to resume: a straight run
    assert_same_run(run, want)
    assert run.checkpointer().latest_step() is None
    run2 = Run(tmp_path / "again", data, "base-soft", monkeypatch)
    run2(2, checkpoint_every=1)
    files = run2.files()
    out = run2(2, resume=True)        # finished: nothing left to train
    assert run2.files() == files
    assert out["best_val_loss"] == min(
        float(line.split(", ")[1]) for line in
        files["base_soft_val_loss_coco0.csv"].decode().splitlines())


def test_sigterm_saves_and_the_trap_is_restored(data, tmp_path,
                                                monkeypatch):
    """A real SIGTERM to this process during epoch 1's second step: the
    step finishes, a mid-epoch checkpoint is written, ``train`` returns;
    the previous handler is back. Without a checkpointer no trap is
    installed; off the main thread neither."""
    want = _straight(tmp_path, data, "base-soft", monkeypatch)
    run = Run(tmp_path / "resumed", data, "base-soft", monkeypatch)
    real, steps = ttrain.attention_train_step, []
    seen = []

    def step(*args, **kwargs):
        steps.append(1)
        seen.append(signal.getsignal(signal.SIGTERM))
        if len(steps) == STEPS + 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(*args, **kwargs)
    monkeypatch.setattr(ttrain, "attention_train_step", step)
    before = signal.getsignal(signal.SIGTERM)
    out = run(2, checkpoint_every=1)
    assert out["preempted"] == 1.0
    assert signal.getsignal(signal.SIGTERM) is before
    assert seen[0] is not before
    state = run.checkpointer().restore(1)
    assert state["mid_epoch"] and state["batches_done"] == 2
    monkeypatch.setattr(ttrain, "attention_train_step", real)
    run(2, checkpoint_every=1, resume=True)
    assert_same_run(run, want)

    seen.clear()
    monkeypatch.setattr(ttrain, "attention_train_step", step)
    steps[:] = [1] * 100                # no further kill
    Run(tmp_path / "plain", data, "base-soft", monkeypatch)(1)
    assert seen and all(h is before for h in seen)
    seen.clear()
    thread = threading.Thread(target=lambda: Run(
        tmp_path / "thread", data, "base-soft", monkeypatch)(
            1, checkpoint_every=1))
    thread.start()
    thread.join()
    assert seen and all(h is before for h in seen)
