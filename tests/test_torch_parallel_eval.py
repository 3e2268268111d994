"""Data parallelism at inference (``parallel/``), on the CPU:

* the helpers: ``pad_batch_to_devices`` and ``host_shard_indices`` equal
  the JAX package's, and a rank's rows (``shard_batch``) are the
  addressable shards of the JAX ``shard_batch`` over as many devices;
  ``assert_partitioned`` and ``batch_sharding`` refuse an extent that
  does not divide;
* ``evaluate`` over two gloo ranks (``tests/torch_parallel_child.py``)
  against the JAX ``evaluate`` on its 8 virtual devices, on checkpoint
  sets written by the JAX ``save_component`` (ResNet blocks 1,1,1,1 at
  64x64, f32 encoders, 6 images, two sets): hypotheses per set and the
  seven scores exactly equal (``==``) for base-soft greedy, NIC and
  base-hard (the JAX chain of per-set keys replayed as arrays), at a
  batch of 4 (which splits over 2) and of 3 (padded to 4); base-hard on
  each set's own generator equals one rank's ``evaluate``; the eval
  cache's disk store written by rank 0 and replayed by both ranks (no
  encoder run) gives the same; in the same ranks ``global_batch`` gathers
  the ranks' rows in order and ``host_shard_indices`` reads the group's
  rank and size;
* ``CaptionPipeline(devices=["cpu", "cpu"])`` over set 1 (f32 encoders)
  against the JAX ``CaptionPipeline`` over two of its virtual devices:
  tokens equal for base-soft, depth-soft (the tests' tiny DPT, bridged)
  and nic greedy;
* ``CaptionPipeline(devices=["cpu", "cpu"])`` over those sets: tokens
  equal to one device's for greedy (base-soft, depth-soft with a DPT
  replica), sampled hard attention and hard beam search; a reload
  reaches both replicas; exporting it is refused;
* ``serve --devices 2 --device cpu`` starts, answers a caption and exits
  cleanly on SIGTERM.
"""

import io
import os
import signal
import socket
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import jax
import torch

from depth_image_captioning_pub_tpu import cli as jcli
from depth_image_captioning_pub_tpu.engine import evaluate as jeval
from depth_image_captioning_pub_tpu.pipeline import (
    CaptionPipeline as JCaptionPipeline)
from depth_image_captioning_pub_tpu.parallel import mesh as jmesh
from depth_image_captioning_pub_tpu.parallel import multihost as jmultihost
from depth_image_captioning_pub_tpu.utils.checkpoint import (
    save_component as jsave_component)
from depth_image_captioning_pub_torch import cli
from depth_image_captioning_pub_torch.config import ConfigEval
from depth_image_captioning_pub_torch.export import export_pipeline
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.parallel import mesh, multihost
from depth_image_captioning_pub_torch.pipeline import CaptionPipeline

import torch_parallel_child as child
from test_torch_evaluate import (
    HW, LAYERS, MAX_LEN, _Recorder, _cfgs, _jax_cap, _np_tree,
    _random_stats, _scale_kernels, _tables)
from test_torch_evaluate import coco_dir, tiny_dpt  # noqa: F401 (fixtures)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

N_IMAGES = 6        # test_torch_evaluate's SUBSET
BATCHES = (4, 3)    # splits over two ranks; does not (padded to 4)
K = 196


# ---- helpers ----------------------------------------------------------------

def test_helpers_equal_jax():
    for b in range(1, 20):
        for n in (1, 2, 3, 8):
            assert mesh.pad_batch_to_devices(b, n) == \
                jmesh.pad_batch_to_devices(b, n)
    for n in (1, 5, 8, 13):
        for count in (1, 2, 3, 4):
            for i in range(count):
                got = multihost.host_shard_indices(n, i, count)
                want = jmultihost.host_shard_indices(n, i, count)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, np.asarray(w))
    assert multihost.process_index() == 0 and multihost.process_count() == 1
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for ways in (2, 8):
        jm = jmesh.make_mesh(jax.devices()[:ways])
        shards = jmesh.shard_batch(jm, {"x": x, "s": np.float32(2)})
        by_device = {s.device: np.asarray(s.data)
                     for s in shards["x"].addressable_shards}
        for r, dev in enumerate(jm.devices.ravel()):
            got = mesh.shard_batch(mesh.Mesh(r, ways),
                                   {"x": torch.from_numpy(x), "s": 2.0})
            np.testing.assert_array_equal(got["x"].numpy(), by_device[dev])
            assert got["s"] == 2.0
            mesh.assert_partitioned(got["x"], 0, ways, 8)
            assert mesh.local_shard_shape(got["x"]) == (8 // ways, 3)
    with pytest.raises(AssertionError, match="not divisible by ways=3"):
        mesh.assert_partitioned(torch.zeros(2, 3), 0, 3, 8)
    with pytest.raises(AssertionError, match="not 2-way partitioned"):
        mesh.assert_partitioned(torch.zeros(8, 3), 0, 2, 8)
    with pytest.raises(AssertionError, match="not divisible"):
        mesh.batch_sharding(mesh.Mesh(0, 3), 8)
    draws = torch.arange(12.0).reshape(6, 2)
    hook = mesh.global_rows(lambda t, shape: draws[:shape[0]],
                            mesh.Mesh(1, 2))
    torch.testing.assert_close(hook(0, (3, 2)), draws[3:], rtol=0, atol=0)


# ---- evaluate over two ranks ------------------------------------------------

def _jax_init(kind, w2i):
    params, frozen, stats = _jax_cap(kind, w2i).init(jax.random.PRNGKey(0),
                                                     image_hw=(HW, HW))
    return _np_tree(params), _scale_kernels(_np_tree(frozen)["encoder"],
                                            3.0), _np_tree(stats)


@pytest.fixture(scope="module")
def sets(coco_dir):  # noqa: F811
    """Two checkpoint sets each of base-soft, base-hard, depth-soft and
    nic in the JAX trainer's files under the working directory, from two
    JAX inits (depth-soft's, whose encoder and decoder serve the other
    attention kinds, and nic's): set 2's decoder is set 1's with the vocab
    head's bias moved by seeded noise; hard attention's scorer is scaled
    down so that its region noise moves tokens (``test_torch_mdepth``'s
    sets). Returns the JAX captioners."""
    root, _, _, w2i, _ = coco_dir
    _, tcfg = _cfgs(root)
    rng = np.random.default_rng(7)
    params, enc, stats = _jax_init("depth-soft", w2i)
    hard = dict(params["decoder"],
                att_w_full=params["decoder"]["att_w_full"] * 1e-3)
    dec = dict(params["decoder"], out_b=params["decoder"]["out_b"].copy())
    dec["out_b"][w2i["<end>"]] += 1.0        # some captions end early
    depth = {"params": _scale_kernels(params["depth_encoder"], 6.0),
             "batch_stats": _random_stats(stats, rng)}
    nic_params, nic_enc, _ = _jax_init("nic", w2i)
    trees = {"base-soft": (enc, dec), "base-hard": (enc, hard),
             "depth-soft": (enc, dec, depth),
             "nic": (nic_enc, nic_params["decoder"])}
    for kind, (first, decoder, *rest) in trees.items():
        save_dir, files = (cli.eval_tables(tcfg, "hard", False, False)
                           if kind == "base-hard" else _tables(tcfg, kind))
        for i in (1, 2):
            if i == 2:
                decoder = dict(decoder, out_b=decoder["out_b"] + rng.normal(
                    0.0, 2.0, decoder["out_b"].shape).astype(np.float32))
            for name, tree in zip(files[i], (first, decoder, *rest)):
                jsave_component(os.path.join(save_dir, name), tree)
            if kind == "nic":
                jsave_component(os.path.join(save_dir, files[i][0].replace(
                    "encoder", "enc_linear")), nic_params["enc_linear"])
    return {kind: _jax_cap(kind, w2i) for kind in trees}


def jax_noise(batch, path):
    """JAX ``evaluate``'s base-hard draws at ``batch``: set s keyed with
    PRNGKey(s), split once a batch, ``gumbel(fold_in(key, t))`` at the
    port's padded batch (the JAX draws at its 8 devices' padding begin
    with the same rows); saved as [set, batch, t, rows, K]."""
    rows = mesh.pad_batch_to_devices(batch, 2)
    n_batches = -(-N_IMAGES // batch)
    table = np.zeros((2, n_batches, MAX_LEN, rows, K), np.float32)
    for s in (1, 2):
        rng = jax.random.PRNGKey(s)
        for b in range(n_batches):
            rng, key = jax.random.split(rng)
            for t in range(MAX_LEN):
                table[s - 1, b, t] = np.asarray(jax.random.gumbel(
                    jax.random.fold_in(key, t), (rows, K)))
    np.save(path, table)
    return str(path)


_CAPTION_FNS = {}


def _shared_caption_fn(cap, *args, **kwargs):
    """The JAX ``make_caption_fn``, one per captioner and settings: both
    batch sizes pad to the 8 devices' 8 rows, so one compiled program
    serves both evaluations."""
    key = (id(cap), args, tuple(sorted(kwargs.items())))
    if key not in _CAPTION_FNS:
        _CAPTION_FNS[key] = _make_caption_fn(cap, *args, **kwargs)
    return _CAPTION_FNS[key]


_make_caption_fn = jeval.make_caption_fn


def jax_evaluate(kind, batch, root, w2i, i2w, jcap, dataset):
    jcfg, tcfg = _cfgs(root)
    jcfg.batch_size = batch
    save_dir, files = (cli.eval_tables(tcfg, "hard", False, False)
                       if kind == "base-hard" else _tables(tcfg, kind))
    rec = _Recorder(jeval.load_textfiles)
    saved = jeval.load_textfiles, jeval.make_caption_fn
    jeval.load_textfiles, jeval.make_caption_fn = rec, _shared_caption_fn
    try:
        scores = jeval.evaluate(
            kind, "coco", jcap,
            lambda i: jcli.load_eval_components(save_dir, files[i], jcap,
                                                image_hw=(HW, HW)),
            dataset, w2i, i2w, jcfg, num_sets=2, quiet=True)
    finally:
        jeval.load_textfiles, jeval.make_caption_fn = saved
    return scores, rec.hypos


def test_evaluate_two_ranks_equals_jax(coco_dir, sets, tmp_path):  # noqa: F811
    root, img_dir, ann, w2i, i2w = coco_dir
    cases = [{"name": "base-hard-seeded", "kind": "base-hard", "batch": 4,
              "num_sets": 2, "max_length": MAX_LEN, "noise": None}]
    for batch in BATCHES:
        for kind in ("base-soft", "nic", "base-hard"):
            noise = (jax_noise(batch, tmp_path / f"noise{batch}.npy")
                     if kind == "base-hard" else None)
            cases.append({"name": f"{kind}/{batch}", "kind": kind,
                          "batch": batch, "num_sets": 2,
                          "max_length": MAX_LEN, "noise": noise})
    store = str(tmp_path / "store")
    cases += [{"name": name, "kind": "base-soft", "batch": 3, "num_sets": 1,
               "max_length": MAX_LEN, "noise": None, "store": store}
              for name in ("store-fill", "store-replay")]
    ranks = child.start_ranks(tmp_path, 2, "evaluate", root=str(root),
                              cases=cases)
    from depth_image_captioning_pub_tpu.data import coco as jcoco
    dataset = jcoco.Subset(jcoco.CocoCaptions(img_dir, ann,
                                              image_size=(HW, HW)),
                           jcoco.load_index_file(str(
                               root / "data_index" / "np_val_index.npy")))
    want = {f"{kind}/{batch}": jax_evaluate(kind, batch, root, w2i, i2w,
                                            sets[kind], dataset)
            for batch in BATCHES for kind in ("base-soft", "nic",
                                              "base-hard")}
    # one rank's evaluate, each set on its own generator
    one = child.task_evaluate(str(root), cases[:1])
    got = child.wait_ranks(ranks)
    for name, (scores, hypos) in want.items():
        assert got[0][name][1] == hypos, name
        assert len(hypos) == 2 and hypos[0] != hypos[1], name
        assert got[0][name][0] == got[1][name][0] == scores, name
        assert got[1][name][1] == []        # rank 0 alone detokenizes
    # the disk store: rank 0 writes whole batches once, each rank replays
    # its rows, the frozen encoder does not run
    assert len(os.listdir(store)) == 1
    for name, calls in (("store-fill", 2), ("store-replay", 0)):
        for ranked in got:
            assert ranked[name][0] == {
                k: v[:1] for k, v in want["base-soft/3"][0].items()}, name
            assert ranked[name][2] == calls, name
        assert got[0][name][1] == want["base-soft/3"][1][:1]
    for r, ranked in enumerate(got):
        np.testing.assert_array_equal(ranked["global_batch"]["rows"],
                                      np.arange(6))
        torch.testing.assert_close(ranked["global_batch"]["t"], torch.tensor(
            [[0.0, 0.0]] * 2 + [[1.0, 1.0]] * 2), rtol=0, atol=0)
        for g, w in zip(ranked["shard"], jmultihost.host_shard_indices(
                5, r, 2)):
            np.testing.assert_array_equal(g, np.asarray(w))
    assert want["base-hard/4"][1] != want["base-hard/3"][1]
    assert got[0]["base-hard-seeded"][:2] == one["base-hard-seeded"][:2]
    assert one["base-hard-seeded"][1] != want["base-hard/4"][1]
    assert len(set(want["base-soft/3"][1][0])) > 1


# ---- the pipeline over two devices ----------------------------------------

@pytest.mark.parametrize("kind", ["base-soft", "depth-soft", "nic"])
def test_pipeline_devices_equals_jax(  # noqa: F811 (fixtures)
        kind, coco_dir, sets, tiny_dpt):
    """Set 1 of ``kind`` (f32 encoders; depth-soft with the tests' tiny DPT,
    its variables bridged) as the JAX ``CaptionPipeline`` over two of its
    virtual devices and as the port's over ``["cpu", "cpu"]``, chunks of
    4 (the second padded): the tokens of 7 64x64 images equal, integer
    for integer."""
    root, _, _, w2i, i2w = coco_dir
    _, tcfg = _cfgs(root)
    save_dir, files = _tables(tcfg, kind)
    jcap = sets[kind]
    frozen, params, stats = jcli.load_eval_components(
        save_dir, files[1], jcap, image_hw=(HW, HW))
    depth = kind == "depth-soft"
    common = dict(max_length=MAX_LEN, batch_buckets=(4,),
                  image_hw=(HW, HW))
    jpipe = JCaptionPipeline(
        jcap, params, dict(encoder=frozen, **(
            {"dpt": tiny_dpt[1]} if depth else {})), stats, w2i, i2w,
        depth_fn=tiny_dpt[0] if depth else None,
        devices=jax.devices()[:2], **common)
    tcap = build_captioner(kind, len(w2i), encoder_dtype=torch.float32,
                           resnet_layers=LAYERS, device="cpu")
    tpipe = CaptionPipeline(tcap, w2i, i2w,
                            depth_fn=tiny_dpt[2] if depth else None,
                            devices=["cpu", "cpu"], **common)
    tpipe.reload_weights(params, frozen, stats)
    assert jpipe.batch_buckets == tpipe.batch_buckets == (4,)
    images = np.random.default_rng(5).integers(0, 256, (7, HW, HW, 3),
                                               dtype=np.uint8)
    want = jpipe.caption_tokens(images)
    np.testing.assert_array_equal(tpipe.caption_tokens(images), want)
    assert len({tuple(r) for r in want.tolist()}) > 1


@pytest.mark.parametrize("kind,kw", [
    ("base-soft", {}), ("depth-soft", {}),
    ("base-hard", {"sample": True, "top_p": 0.9, "seed": 3}),
    ("base-hard", {"beam_size": 3})])
def test_pipeline_devices_equals_one_device(  # noqa: F811 (coco_dir)
        kind, kw, coco_dir, sets, tmp_path, monkeypatch):
    """Set 1 of ``kind`` through ``from_experiment`` (the tests' DPT drawn
    at random for depth-soft, a replica of it on the second device) on
    one device and on ``["cpu", "cpu"]``."""
    monkeypatch.chdir(coco_dir[0])
    monkeypatch.setenv("DCAP_RESNET_LAYERS", "1,1,1,1")
    monkeypatch.setenv("DCAP_TINY_DPT", "1")
    monkeypatch.delenv("DPT_WEIGHTS", raising=False)
    images = np.random.default_rng(0).integers(0, 256, (7, 224, 224, 3),
                                               dtype=np.uint8)

    cfg = ConfigEval()
    cfg.max_length = MAX_LEN

    def pipe(devices, set_idx=1):
        return CaptionPipeline.from_experiment(
            kind, cfg=cfg, set_idx=set_idx, device="cpu",
            batch_buckets=(2, 4), devices=devices, **kw)
    one, two = pipe(None), pipe(["cpu", "cpu"])
    assert len(two.replicas) == 2 and two.replicas[0] is not \
        two.replicas[1]
    want = one.caption_tokens(images)
    np.testing.assert_array_equal(two.caption_tokens(images), want)
    assert len({tuple(r) for r in want}) > 1
    if kind != "base-soft":
        return
    # set 2's weights reach both replicas
    two._experiment = (two._experiment[0], cli.eval_tables(
        cfg, "soft", False, False)[1][2])
    two.reload_from_experiment()
    reloaded = two.caption_tokens(images)
    np.testing.assert_array_equal(reloaded,
                                  pipe(None, 2).caption_tokens(images))
    assert not np.array_equal(reloaded, want)
    with pytest.raises(ValueError, match="single-device pipeline"):
        export_pipeline(two, str(tmp_path / "export"))
    assert not (tmp_path / "export").exists()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_devices_two_starts(coco_dir, sets):  # noqa: F811
    """``serve --devices 2 --device cpu`` over base-soft's set 1: a caption
    for a PNG, then a clean SIGTERM exit."""
    from PIL import Image
    root = coco_dir[0]
    port = _free_port()
    env = dict(os.environ, DCAP_RESNET_LAYERS="1,1,1,1", OMP_NUM_THREADS="1",
               PYTHONPATH=str(child.HERE.parent))
    proc = subprocess.Popen(
        [sys.executable, "-m", "depth_image_captioning_pub_torch.serve",
         "--devices", "2", "--device", "cpu", "--port", str(port),
         "--batch-buckets", "1,2"], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert "over 2 devices" in line, line + proc.stdout.read()
        buf = io.BytesIO()
        Image.fromarray(np.random.default_rng(1).integers(
            0, 256, (48, 40, 3), dtype=np.uint8)).save(buf, format="PNG")
        req = urllib.request.Request(f"http://127.0.0.1:{port}/caption",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            assert "caption" in resp.read().decode()
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=60)[0]
        assert proc.returncode == 0 and "clean exit" in out, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
