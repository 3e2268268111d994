"""The trainer's profiler window (``utils/logging.ProfilerTrace``, the
JAX ``--profile DIR --profile-start N --profile-stop M``): ``train`` opens
a ``torch.profiler`` window before host step N and closes it after step
M - 1, counting steps across epochs; a run that ends inside the window,
or is preempted inside it, closes it on its way out. Each window writes a
Chrome trace into DIR that names the step's ops. The training CLI's flags
reach ``cfg``: tests/test_torch_train_cli.py::test_unported_flags_exit_2.

base-soft on 4 synthetic 64x64 images, batch 2 (2 steps an epoch), f32
encoders, ResNet blocks 1,1,1,1, on the CPU; the window across epochs
runs 2 epochs, the others one.
"""

import json
import os
import threading

import pytest
import torch

from depth_image_captioning_pub_tpu.data.coco import CocoCaptions
from depth_image_captioning_pub_tpu.data.synthetic import make_synthetic_coco
from depth_image_captioning_pub_tpu.data.vocab import (
    build_vocab, captions_from_coco_json)
from depth_image_captioning_pub_torch.config import ConfigTrain
from depth_image_captioning_pub_torch.engine import train as ttrain
from depth_image_captioning_pub_torch.utils import logging as tlogging
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

LAYERS, HW = (1, 1, 1, 1), 64


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    out = tmp_path_factory.mktemp("coco")
    img_dir, ann = make_synthetic_coco(str(out), num_images=4,
                                       image_hw=(HW, HW), seed=3)
    w2i, _ = build_vocab(captions_from_coco_json(ann), [], min_count=1)
    return CocoCaptions(img_dir, ann, image_size=(HW, HW)), w2i


class Recorder(tlogging.ProfilerTrace):
    """Records the number of train steps taken at each open and close."""

    events = []
    steps = [0]

    def maybe_start(self):
        if not self.active:
            self.events.append(("start", self.steps[0]))
        super().maybe_start()

    def maybe_stop(self):
        if self.active:
            self.events.append(("stop", self.steps[0]))
        return super().maybe_stop()


def _run(coco, tmp_path, monkeypatch, start, stop, epochs=1, **kw):
    ds, w2i = coco
    Recorder.events, Recorder.steps = [], [0]
    monkeypatch.setattr(ttrain, "ProfilerTrace", Recorder)
    real = ttrain.attention_train_step

    def counted(*a, **k):
        out = real(*a, **k)
        Recorder.steps[0] += 1
        return out
    monkeypatch.setattr(ttrain, "attention_train_step", counted)
    cfg = ConfigTrain()
    cfg.batch_size, cfg.max_caption_len = 2, 10
    cfg.save_directory_soft = str(tmp_path / "run")
    cfg.profile_dir = str(tmp_path / "prof")
    cfg.profile_start, cfg.profile_stop = start, stop
    out = ttrain.train("base-soft", 0, cfg=cfg, datasets=(ds, ds),
                       word_to_id=w2i, num_epochs=epochs, quiet=True,
                       resnet_layers=LAYERS, device="cpu", **kw)
    traces = sorted(os.listdir(cfg.profile_dir)) if os.path.isdir(
        cfg.profile_dir) else []
    return out, Recorder.events, [os.path.join(cfg.profile_dir, t)
                                  for t in traces]


def test_window_spans_steps_across_epochs(coco, tmp_path, monkeypatch):
    _, events, traces = _run(coco, tmp_path, monkeypatch, 1, 3, epochs=2)
    assert events == [("start", 1), ("stop", 3)]
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(traces[0]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert any("AdamW" in n for n in names), sorted(names)[:20]


def test_window_closes_when_the_run_ends_inside_it(coco, tmp_path,
                                                   monkeypatch):
    _, events, traces = _run(coco, tmp_path, monkeypatch, 1, 100)
    assert events == [("start", 1), ("stop", 2)]      # the run's 2 steps
    assert len(traces) == 1


def test_window_closes_on_preemption(coco, tmp_path, monkeypatch):
    event = threading.Event()
    real = ttrain.attention_train_step

    def preempt_at_first(*a, **k):
        out = real(*a, **k)
        if Recorder.steps[0] == 0:      # counted() adds this step after
            event.set()
        return out
    monkeypatch.setattr(ttrain, "attention_train_step", preempt_at_first)
    out, events, traces = _run(coco, tmp_path, monkeypatch, 0, 50,
                               checkpoint_every=1, preempt_event=event)
    assert out.get("preempted") == 1.0
    assert events == [("start", 0), ("stop", 1)]    # mid-epoch, at step 1
    assert len(traces) == 1


def test_no_window_without_a_directory(tmp_path):
    trace = tlogging.ProfilerTrace(None)
    trace.maybe_start()
    assert not trace.active and trace.maybe_stop() is None
    trace = tlogging.ProfilerTrace(str(tmp_path / "p"))
    trace.maybe_start()
    torch.ones(3).sum()
    path = trace.maybe_stop()
    assert os.path.exists(path) and trace.maybe_stop() is None
