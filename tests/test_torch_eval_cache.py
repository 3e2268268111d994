"""The eval caches of the frozen stages (``engine/evaluate.evaluate``) and
their disk store (``engine/eval_cache_store.py``), in the port, on the
CPU; the JAX package's ``evaluate`` against them:
tests/test_torch_eval_cache_jax.py.

Checkpoint sets are ``tests/test_torch_evaluate.py``'s (JAX-written files
in ``eval_tables``' layout, ResNet blocks 1,1,1,1 at 64x64, f32 encoders,
the tiny DPT, 6 images in batches of 4: 2 batches a set) and a base-hard
pair written the same way. Three sets are scored: sets 1, 2 and set 1's
files again.

* Cache on == cache off (``--no-eval-cache``), for base-soft, depth-soft,
  nic and base-hard: hypotheses per set and the seven scores ``==``; with
  the cache the frozen encoder runs on set 1's 2 batches only (6 off) and
  the DPT too (depth-soft), and the frozen encoder is copied to the card
  once, on or off (the later sets' trees equal the one on the card).
* ``$DCAP_EVAL_CACHE_GB`` below the entries' size: depth maps only (the
  encoder runs every set, the DPT on set 1), the same scores.
* A set whose frozen encoder differs recomputes its features (and is
  copied), still replays the depth maps; the same scores as off.
* The store: ``data_key`` moves with an image's mtime, a caption, the
  batch; ``model_key`` with the encoder tree, the DPT's weights, a knob,
  the kind; a failed write leaves neither an entry nor a temporary
  directory; a second one-set run with ``eval_cache_dir`` replays from
  disk (no encoder, no DPT) with ``==`` hypotheses and scores; a depth
  kind's ``depth_fn`` without its DPT (``.model``) is refused.
* The entry point's flags as ``base_evaluation.py``'s: ``--no-eval-cache``
  (and ``--no-depth-eval-cache``, ``depth_evaluation.py``'s alias),
  ``--eval-cache-dir`` and ``$DCAP_EVAL_CACHE_DIR``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import base_evaluation
from depth_image_captioning_pub_tpu.utils.checkpoint import (
    save_component as jsave_component)
from depth_image_captioning_pub_torch import cli, evaluation
from depth_image_captioning_pub_torch.engine import eval_cache_store as store
from depth_image_captioning_pub_torch.engine import evaluate as teval
from depth_image_captioning_pub_torch.models import captioner as tcaptioner

from test_torch_evaluate import (
    LAYERS, _cfgs, _scale_kernels, _Recorder, coco_dir, dataset,
    experiments, tiny_dpt)
from test_torch_mdepth import _trees
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

__all__ = ["coco_dir", "dataset", "experiments", "tiny_dpt"]
SETS = (1, 2, 1)
LOAD_TEXTFILES, PARAMS_FROM_JAX = teval.load_textfiles, teval.params_from_jax


def tables(cfg, kind):
    if kind == "nic":
        return cfg.save_directory_nic, cfg.nic_parameter_files
    base, atten = kind.split("-")
    return cli.eval_tables(cfg, atten, False, base == "depth")


@pytest.fixture(scope="module")
def hard_sets(coco_dir, experiments):
    """base-hard's two sets (``test_torch_mdepth._trees``: one encoder, the
    decoders from seeds 0 and 1), and depth-soft's set 3: set 1's decoder
    and depth CNN under an encoder scaled by 1.1."""
    root, _, _, w2i, _ = coco_dir
    _, tcfg = _cfgs(root)
    save_dir, files = tables(tcfg, "base-hard")
    _, enc, first, _ = _trees("base-hard", w2i, seed=0)
    for i in (1, 2):
        trainable = first if i == 1 else _trees("base-hard", w2i, 1)[2]
        jsave_component(os.path.join(save_dir, files[i][0]), enc)
        jsave_component(os.path.join(save_dir, files[i][1]),
                        trainable["decoder"])
    save_dir, files = tables(tcfg, "depth-soft")
    for src, dst in zip(files[1], files[3]):
        shutil.copy(os.path.join(save_dir, src + ".msgpack"),
                    os.path.join(save_dir, dst + ".msgpack"))
    enc = experiments["depth-soft"][1][1][0]
    jsave_component(os.path.join(save_dir, files[3][0]),
                    _scale_kernels(enc, 1.1))
    return True


class Counts:
    """Counts the frozen encoder's batches, the DPT's batches and each
    set's ``load_encoder``."""

    def __init__(self):
        self.encoder = self.dpt = 0
        self.copies = []


OFF_RUNS = {}


def off_run(kind, coco_dir, dataset, tiny_dpt, sets=SETS):
    """``port_eval`` with the cache off, once a module per (kind, sets)."""
    key = (kind, sets)
    if key not in OFF_RUNS:
        OFF_RUNS[key] = port_eval(kind, coco_dir, dataset, tiny_dpt,
                                  sets=sets, depth_eval_cache=False)
    return OFF_RUNS[key]


def port_eval(kind, coco_dir, dataset, tiny_dpt, sets=SETS, **kw):
    """(scores, hypotheses per set, Counts) of the port's ``evaluate``
    over checkpoint files ``sets`` (one entry a set)."""
    root, _, _, w2i, i2w = coco_dir
    _, tcfg = _cfgs(root)
    save_dir, files = tables(tcfg, kind)
    cap = tcaptioner.build_captioner(kind, len(w2i), tcfg,
                                     encoder_dtype=torch.float32,
                                     resnet_layers=LAYERS, device="cpu")
    n = Counts()
    frozen = cap.backbone if kind == "nic" else cap.encoder
    frozen.register_forward_pre_hook(
        lambda *a: setattr(n, "encoder", n.encoder + 1))
    depth_fn = None
    if kind == "depth-soft":
        def depth_fn(images):
            n.dpt += 1
            return tiny_dpt[2](images)
        depth_fn.model = tiny_dpt[2].model
    def copying(*a, load_encoder=True, **k):
        n.copies.append(load_encoder)
        return PARAMS_FROM_JAX(*a, load_encoder=load_encoder, **k)
    rec = _Recorder(LOAD_TEXTFILES)
    teval.params_from_jax, teval.load_textfiles = copying, rec
    try:
        got = teval.evaluate(
            kind, "coco", cap,
            lambda i: cli.load_eval_components(save_dir, files[sets[i - 1]],
                                               cap),
            dataset, w2i, i2w, tcfg, depth_fn=depth_fn, num_sets=len(sets),
            quiet=True, **kw)
    finally:
        teval.params_from_jax, teval.load_textfiles = (PARAMS_FROM_JAX,
                                                       LOAD_TEXTFILES)
    return got, rec.hypos, n


@pytest.mark.parametrize("kind", ["base-soft", "depth-soft", "nic",
                                  "base-hard"])
def test_cache_on_equals_off(kind, coco_dir, dataset, tiny_dpt, hard_sets):
    off = off_run(kind, coco_dir, dataset, tiny_dpt)
    on = port_eval(kind, coco_dir, dataset, tiny_dpt)
    assert on[1] == off[1] and on[0] == off[0]
    assert on[1][0] != on[1][1]
    # set 3 reads set 1's files; hard attention draws set k's region
    # noise from seed k, so its captions differ even so
    assert (on[1][0] == on[1][2]) == (kind != "base-hard")
    assert (off[2].encoder, on[2].encoder) == (6, 2)
    depth = kind == "depth-soft"
    assert (off[2].dpt, on[2].dpt) == ((6, 2) if depth else (0, 0))
    assert off[2].copies == on[2].copies == [True, False, False]


def test_tiny_limit_caches_depth_maps_only(coco_dir, dataset, tiny_dpt,
                                           monkeypatch):
    off = off_run("depth-soft", coco_dir, dataset, tiny_dpt)
    monkeypatch.setenv("DCAP_EVAL_CACHE_GB", "1e-9")
    small = port_eval("depth-soft", coco_dir, dataset, tiny_dpt)
    assert small[:2] == off[:2]
    assert (small[2].encoder, small[2].dpt) == (6, 2)
    assert teval._projected_cache_bytes(
        tcaptioner.build_captioner("depth-soft", 10, resnet_layers=LAYERS,
                                   device="cpu"),
        _cfgs(coco_dir[0])[1], 4000, True) == 4000 * (196 * 2048 * 2
                                                      + 224 * 224 * 4)


def test_differing_encoder_recomputes(coco_dir, dataset, tiny_dpt, hard_sets):
    sets = (1, 3, 1)
    off = off_run("depth-soft", coco_dir, dataset, tiny_dpt, sets)
    on = port_eval("depth-soft", coco_dir, dataset, tiny_dpt, sets=sets)
    assert on[:2] == off[:2] and on[1][1] != on[1][0]
    assert (on[2].encoder, on[2].dpt) == (4, 2)
    assert on[2].copies == [True, True, False]
    assert off[2].copies == [True, True, True]


def test_store_keys_atomic_writes_and_disk_replay(coco_dir, dataset,
                                                  tiny_dpt, tmp_path,
                                                  monkeypatch):
    root_dir = str(tmp_path / "cache")
    first = port_eval("depth-soft", coco_dir, dataset, tiny_dpt,
                      sets=(1,), eval_cache_dir=root_dir)
    assert (first[2].encoder, first[2].dpt) == (2, 2)
    entries = [d for d in os.listdir(root_dir) if not d.startswith(".")]
    assert len(entries) == 1 and not [d for d in os.listdir(root_dir)
                                      if d.startswith(".fill-")]
    again = port_eval("depth-soft", coco_dir, dataset, tiny_dpt,
                      sets=(1,), eval_cache_dir=root_dir)
    assert again[:2] == first[:2]
    assert (again[2].encoder, again[2].dpt) == (0, 0)
    assert again[2].copies == [False]
    off = off_run("depth-soft", coco_dir, dataset, tiny_dpt)
    assert again[1][0] == off[1][0]
    assert {k: v[0] for k, v in again[0].items()} == {
        k: v[0] for k, v in off[0].items()}

    # data_key: an image's mtime, a caption, the batch size
    key = store.data_key(dataset, 4, 4)
    assert key == store.data_key(dataset, 4, 4)
    assert store.data_key(dataset, 2, 2) != key
    path = dataset.dataset.image_path(dataset.indices[0])
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1))
    try:
        assert store.data_key(dataset, 4, 4) != key
    finally:
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))
    caps = dataset.dataset._caps[dataset.dataset.ids[dataset.indices[0]]]
    caps.append("one more caption")
    try:
        assert store.data_key(dataset, 4, 4) != key
    finally:
        caps.pop()
    assert store.data_key(dataset, 4, 4) == key
    assert store.data_key([1, 2], 4, 4) is None

    # model_key: the encoder tree, the DPT's weights, a knob, the kind
    root, _, _, _, _ = coco_dir
    _, cfg = _cfgs(root)
    enc = {"conv": {"kernel": np.ones((2, 3), np.float32)}}
    sd = {k: v.clone() for k, v in tiny_dpt[2].model.state_dict().items()}
    mkey = store.model_key(enc, sd, torch.float32, cfg, "depth-soft")
    assert mkey == store.model_key(enc, sd, torch.float32, cfg,
                                   "depth-soft")
    other = {"conv": {"kernel": np.full((2, 3), 2.0, np.float32)}}
    name = next(iter(sd))
    bumped = dict(sd, **{name: sd[name] + 1})
    cfg2 = _cfgs(root)[1]
    cfg2.dpt_gelu = "tanh"
    assert len({mkey,
                store.model_key(other, sd, torch.float32, cfg, "depth-soft"),
                store.model_key(enc, bumped, torch.float32, cfg,
                                "depth-soft"),
                store.model_key(enc, sd, torch.bfloat16, cfg, "depth-soft"),
                store.model_key(enc, sd, torch.float32, cfg2, "depth-soft"),
                store.model_key(enc, sd, torch.float32, cfg, "depth-hard"),
                store.model_key(enc, None, torch.float32, cfg,
                                "depth-soft")}) == 7

    # an interrupted write leaves nothing readable and nothing behind
    cache = {"entries": [({"feats": torch.ones(2, 3, dtype=torch.bfloat16),
                           "depth_maps": None}, 2),
                         ({"feats": torch.zeros(2, 3), "depth_maps": None},
                          1)],
             "refs": [["a b"], ["c"], ["d"]]}
    calls = []
    real = store.tensor_bytes

    def failing(t):
        calls.append(1)
        if len(calls) == 2:
            raise OSError("disk full")
        return real(t)
    monkeypatch.setattr(store, "tensor_bytes", failing)
    bad_root = str(tmp_path / "bad")
    with pytest.raises(OSError, match="disk full"):
        store.save(bad_root, "d" * 16, "m" * 16, cache, quiet=True)
    assert os.listdir(bad_root) == []
    assert store.load(bad_root, "d" * 16, "m" * 16, "cpu") is None
    monkeypatch.setattr(store, "tensor_bytes", real)
    store.save(bad_root, "d" * 16, "m" * 16, cache, quiet=True)
    back = store.load(bad_root, "d" * 16, "m" * 16, "cpu", quiet=True)
    assert back["refs"] == cache["refs"]
    for (got, n_got), (want, n_want) in zip(back["entries"],
                                            cache["entries"]):
        assert n_got == n_want and got["depth_maps"] is None
        assert got["feats"].dtype == want["feats"].dtype
        assert torch.equal(got["feats"], want["feats"])
    assert store.load(bad_root, "d" * 16, "x" * 16, "cpu") is None


def test_store_refuses_a_depth_fn_without_its_dpt(coco_dir, dataset,
                                                  tiny_dpt, tmp_path):
    """The store keys a depth kind's maps by the DPT's weights: a
    ``depth_fn`` that does not carry its DPT as ``.model`` is refused
    before any set is read, so another DPT cannot replay stale maps."""
    root, _, _, w2i, i2w = coco_dir
    _, tcfg = _cfgs(root)
    cap = tcaptioner.build_captioner("depth-soft", len(w2i), tcfg,
                                     encoder_dtype=torch.float32,
                                     resnet_layers=LAYERS, device="cpu")

    def unread(i):
        raise AssertionError(f"set {i} read")
    with pytest.raises(ValueError, match="depth_fn.model"):
        teval.evaluate("depth-soft", "coco", cap, unread, dataset, w2i, i2w,
                       tcfg, depth_fn=lambda images: tiny_dpt[2](images),
                       num_sets=1, quiet=True,
                       eval_cache_dir=str(tmp_path / "cache"))
    assert not os.path.exists(tmp_path / "cache")


@pytest.mark.parametrize("flags,env,want", [
    ([], None, (True, None)),
    (["--no-eval-cache"], None, (False, None)),
    (["--eval-cache-dir", "D"], None, (True, "D")),
    ([], "E", (True, "E")),
    (["--eval-cache-dir", "D"], "E", (True, "D")),
    (["--no-eval-cache", "--eval-cache-dir", "D"], None, (False, "D")),
])
def test_entry_point_cache_flags_as_base_evaluation(flags, env, want,
                                                    monkeypatch):
    if env is None:
        monkeypatch.delenv("DCAP_EVAL_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("DCAP_EVAL_CACHE_DIR", env)
    seen = []
    monkeypatch.setattr(base_evaluation, "score_mode", lambda *a, **k: seen.append(
        (k["depth_eval_cache"], k["eval_cache_dir"])) or 0)
    monkeypatch.setattr(base_evaluation, "nic_mode", lambda *a, **k: seen.append(
        (k["depth_eval_cache"], k["eval_cache_dir"])) or 0)
    monkeypatch.setattr(evaluation, "score_mode", lambda *a: seen.append(
        (a[-2]["depth_eval_cache"], a[-2]["eval_cache_dir"])) or 0)
    monkeypatch.setattr(evaluation, "nic_mode", lambda *a: seen.append(
        (a[-2]["depth_eval_cache"], a[-2]["eval_cache_dir"])) or 0)
    assert base_evaluation.main(["soft", "score", "coco"] + flags) == 0
    assert base_evaluation.main(["nic"] + flags) == 0
    assert evaluation.main(["base", "soft", "score", "coco"] + flags) == 0
    assert evaluation.main(["nic"] + flags) == 0
    assert seen == [want] * 4
    if "--no-eval-cache" in flags:      # depth_evaluation.py's alias
        seen.clear()
        alias = [f if f != "--no-eval-cache" else "--no-depth-eval-cache"
                 for f in flags]
        assert evaluation.main(["depth", "soft", "score", "coco"]
                               + alias) == 0
        assert seen == [want]
