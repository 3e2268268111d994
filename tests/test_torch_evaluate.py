"""Scored evaluation: the port == the JAX package, on the CPU.

* ``metrics.score`` (the port's copy) gives the JAX package's floats
  exactly on a seeded corpus and on edge cases (an empty hypothesis, one
  word, a repeated word).
* The port's ``CocoCaptions``/``Subset``/``load_index_file`` read the JAX
  package's synthetic COCO as the JAX package's do.
* ``evaluate``: checkpoint sets written by the JAX ``save_component`` in
  ``eval_tables``' layout (two sets whose decoders differ), read by the
  JAX ``evaluate`` and the port's, over the same dataset (ResNet blocks
  1,1,1,1 at 64x64, f32 encoders, ``max_length`` 8): identical hypotheses
  per set and exactly equal score dicts and pickles, for base-soft,
  depth-soft (the tests' tiny DPT, its variables bridged by
  ``dpt_params_from_jax``), nic and base-soft beam 3.
* ``CaptionPipeline.from_experiment`` / ``reload_from_experiment`` /
  ``reload_weights`` against the JAX ``from_experiment`` and fresh loads.
* The entry point ``python -m depth_image_captioning_pub_torch.evaluation``
  against the JAX ``base_evaluation.py`` on the same working directory
  (score pickles equal), and its refusals.

The CPU is deterministic and the seeds fixed, so tokens and scores must be
equal. Both packages' builders are made to build f32 encoders where a
test goes through a builder's default (bf16 rounds at different places in
the two frameworks' convs).
"""

import functools
import os
import pickle
import random

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import base_evaluation
from depth_image_captioning_pub_tpu import cli as jcli
from depth_image_captioning_pub_tpu.config import ConfigEval as JConfigEval
from depth_image_captioning_pub_tpu.data import coco as jcoco
from depth_image_captioning_pub_tpu.data import native_loader
from depth_image_captioning_pub_tpu.data.synthetic import make_synthetic_coco
from depth_image_captioning_pub_tpu.data.vocab import (
    build_vocab, captions_from_coco_json, save_vocab)
from depth_image_captioning_pub_tpu.engine import evaluate as jeval
from depth_image_captioning_pub_tpu.metrics import (
    load_textfiles as jload_textfiles, score as jscore)
from depth_image_captioning_pub_tpu.models import captioner as jcaptioner
from depth_image_captioning_pub_tpu.models import dpt as jdpt
from depth_image_captioning_pub_tpu.pipeline import (
    CaptionPipeline as JCaptionPipeline)
from depth_image_captioning_pub_tpu.utils.checkpoint import (
    save_component as jsave_component)
from depth_image_captioning_pub_torch import cli, evaluation
from depth_image_captioning_pub_torch.config import ConfigEval
from depth_image_captioning_pub_torch.data import coco
from depth_image_captioning_pub_torch.engine import evaluate as teval
from depth_image_captioning_pub_torch.metrics import load_textfiles, score
from depth_image_captioning_pub_torch.models import captioner as tcaptioner
from depth_image_captioning_pub_torch.models.dpt import (
    TINY_DPT, DPTDepthEstimator)
from depth_image_captioning_pub_torch.ops.kernels import (
    beam_seq, decode_seq, nic_seq)
from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
from depth_image_captioning_pub_torch.utils.checkpoint import (
    load_component, save_component)
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    dpt_params_from_jax)

LAYERS = (1, 1, 1, 1)
HW = 64
MAX_LEN = 8
BATCH = 4
SUBSET = [0, 1, 3, 5, 6, 7]
KINDS = {"base-soft": ("base-soft", 1), "depth-soft": ("depth-soft", 1),
         "nic": ("nic", 1), "base-soft-beam3": ("base-soft", 3)}
WORDS = ("a the dog cat man red blue small ball tree park street sitting "
         "running on in with two grass snow beach bike").split()


# ---- metrics ---------------------------------------------------------------

def _corpus(seed, n=40):
    rng = random.Random(seed)

    def sentence():
        return " ".join(rng.choice(WORDS) for _ in range(rng.randint(1, 12)))

    refs = [[sentence() for _ in range(5)] for _ in range(n)]
    hyps = [sentence() for _ in range(n)]
    return refs, hyps


EDGE = {
    "empty": ([["a dog runs", "the dog"]], [""]),
    "one_word": ([["a dog runs", "the dog"], ["cat"]], ["dog", "cat"]),
    "repeated_word": ([["a dog runs on the grass", "dog"]],
                      ["dog dog dog dog dog dog"]),
    "exact_and_empty": ([["a red ball", "two red balls"], ["snow"]],
                        ["a red ball", ""]),
    "stems": ([["dogs running in parks", "the runner runs"]],
              ["dog runs in the park"]),
}


@pytest.mark.parametrize("case", ["seed0", "seed1"] + sorted(EDGE))
def test_score_equals_jax(case):
    refs, hyps = (_corpus(int(case[-1])) if case.startswith("seed")
                  else EDGE[case])
    got_ref, got_hyp = load_textfiles(refs, hyps)
    want_ref, want_hyp = jload_textfiles(refs, hyps)
    assert (got_ref, got_hyp) == (want_ref, want_hyp)
    got, want = score(got_ref, got_hyp), jscore(want_ref, want_hyp)
    assert list(got) == list(teval.METRIC_KEYS)
    assert got == want
    assert all(np.isfinite(v) for v in got.values())


def test_load_textfiles_rejects_mismatch():
    with pytest.raises(ValueError, match="mismatch"):
        load_textfiles([["a"], ["b"]], ["a"])


# ---- data -------------------------------------------------------------------

@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    """A working directory with the reference's layout: the JAX package's
    synthetic COCO val set (8 JPEGs, 64x64), its vocabulary and a subset
    index."""
    root = tmp_path_factory.mktemp("evalcwd")
    base = root / "dataset" / "coco2014"
    img_dir, ann = make_synthetic_coco(str(base), num_images=8,
                                       image_hw=(HW, HW), seed=2,
                                       split="val2014")
    caps = captions_from_coco_json(ann)
    w2i, i2w = build_vocab(caps, [], min_count=1)
    save_vocab(w2i, i2w, str(base / "word_to_id.pkl"),
               str(base / "id_to_word.pkl"))
    (root / "data_index").mkdir()
    np.save(root / "data_index" / "np_val_index.npy",
            np.array(SUBSET, np.int64))
    return root, img_dir, ann, w2i, i2w


@pytest.fixture(scope="module")
def dataset(coco_dir):
    _, img_dir, ann, _, _ = coco_dir
    return coco.Subset(coco.CocoCaptions(img_dir, ann, image_size=(HW, HW)),
                       SUBSET)


def test_coco_copy_equals_jax(coco_dir):
    root, img_dir, ann, _, _ = coco_dir
    for size in ((HW, HW), (40, 52), None):
        got = coco.CocoCaptions(img_dir, ann, image_size=size)
        want = jcoco.CocoCaptions(img_dir, ann, image_size=size)
        assert len(got) == len(want) == 8 and got.ids == want.ids
        for i in range(len(got)):
            assert got.image_path(i) == want.image_path(i)
            assert got.captions(i) == want.captions(i)
            np.testing.assert_array_equal(got.load_image(i),
                                          want.load_image(i))
            np.testing.assert_array_equal(got[i][0], want[i][0])
    idx = str(root / "data_index" / "np_val_index.npy")
    assert coco.load_index_file(idx) == jcoco.load_index_file(idx) == SUBSET
    got = coco.Subset(coco.CocoCaptions(img_dir, ann), SUBSET)
    want = jcoco.Subset(jcoco.CocoCaptions(img_dir, ann), SUBSET)
    assert len(got) == len(want) == len(SUBSET)
    for i in range(len(got)):
        assert got.captions(i) == want.captions(i)
        np.testing.assert_array_equal(got.load_image(i), want.load_image(i))
        assert got[i][1] == want[i][1]


def test_coco_without_pillow(coco_dir, monkeypatch):
    _, img_dir, ann, _, _ = coco_dir
    ds = coco.CocoCaptions(img_dir, ann)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    assert ds.captions(0)
    with pytest.raises(ImportError, match="needs Pillow"):
        ds.load_image(0)


# ---- checkpoint sets --------------------------------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, dict(tree))


def _scale_kernels(tree, factor):
    """Random torch-default conv inits shrink activations layer by layer,
    which would give every image the same caption; scaling the kernels
    keeps the features image-dependent."""
    return {k: (_scale_kernels(v, factor) if isinstance(v, dict)
                else np.asarray(v) * (factor if k == "kernel" else 1.0))
            for k, v in tree.items()}


def _random_stats(stats, rng):
    return {name: {"mean": rng.normal(0.0, 0.1, s["mean"].shape)
                   .astype(np.float32),
                   "var": rng.uniform(0.5, 1.5, s["var"].shape)
                   .astype(np.float32)}
            for name, s in stats.items()}


def _cfgs(root):
    """(JAX ConfigEval, port ConfigEval) with the tests' batch and length
    and every path under ``root``."""
    cwd = os.getcwd()
    os.chdir(root)
    try:
        out = JConfigEval(), ConfigEval()
    finally:
        os.chdir(cwd)
    for cfg in out:
        cfg.batch_size = BATCH
        cfg.max_length = MAX_LEN
    return out


def _jax_cap(kind, w2i):
    return jcaptioner.build_captioner(kind, len(w2i), JConfigEval(),
                                      encoder_dtype=jnp.float32,
                                      resnet_layers=LAYERS)


def _write_sets(kind, w2i, save_dir, files, seed=0):
    """Two checkpoint sets of ``kind`` in the JAX trainer's files: one
    frozen encoder, the decoder (and NIC projection) of set i from
    PRNGKey(seed + i - 1), the depth encoder with random BN statistics.
    Returns (the JAX captioner, {set: (frozen_enc, params, stats)})."""
    end = w2i["<end>"]
    jcap = _jax_cap(kind, w2i)
    sets = {}
    for i in (1, 2):
        params, frozen, stats = jcap.init(jax.random.PRNGKey(seed + i - 1),
                                          image_hw=(HW, HW))
        params, frozen, stats = _np_tree(params), _np_tree(frozen), \
            _np_tree(stats)
        if kind == "base-soft":     # some captions end before MAX_LEN
            params["decoder"]["out_b"][end] += 1.0
        if i == 1:
            enc = _scale_kernels(frozen["encoder"],
                                 1.5 if kind == "depth-soft" else 3.0)
            dep = (_scale_kernels(params["depth_encoder"], 6.0)
                   if kind == "depth-soft" else None)
            dstats = _random_stats(stats, np.random.default_rng(4))
        trees = {"decoder": params["decoder"]}
        names = files[i]
        jsave_component(os.path.join(save_dir, names[0]), enc)
        jsave_component(os.path.join(save_dir, names[1]), params["decoder"])
        if kind == "nic":
            trees["enc_linear"] = params["enc_linear"]
            jsave_component(os.path.join(save_dir, names[0].replace(
                "encoder", "enc_linear")), params["enc_linear"])
        if kind == "depth-soft":
            trees["depth_encoder"] = dep
            jsave_component(os.path.join(save_dir, names[2]),
                            {"params": dep, "batch_stats": dstats})
        sets[i] = (enc, trees, dstats if kind == "depth-soft" else {})
    return jcap, sets


def _tables(cfg, kind):
    if kind == "nic":
        return cfg.save_directory_nic, cfg.nic_parameter_files
    return cli.eval_tables(cfg, "soft", False, kind == "depth-soft")


@pytest.fixture(scope="module")
def experiments(coco_dir):
    """Two checkpoint sets per kind, in eval_tables' layout under the
    working directory."""
    root, _, _, w2i, _ = coco_dir
    _, tcfg = _cfgs(root)
    out = {}
    for kind in ("base-soft", "depth-soft", "nic"):
        save_dir, files = _tables(tcfg, kind)
        out[kind] = _write_sets(kind, w2i, save_dir, files)
    return out


@pytest.fixture(scope="module")
def tiny_dpt():
    """The tests' tiny DPT in f32: (JAX depth_fn, variables, port
    depth_fn) on one set of variables."""
    est = jdpt.DPTDepthEstimator(dtype=jnp.float32, image_size=HW)
    est.model = jdpt.DPTDepthModel(**TINY_DPT)
    variables = _np_tree(jax.jit(est.model.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, HW, HW, 3))))
    port = DPTDepthEstimator(dtype=torch.float32, image_size=HW,
                             device="cpu", **TINY_DPT)
    dpt_params_from_jax(port, variables)
    return est.depth_fn(), variables, port.depth_fn()


class _Recorder:
    """Wraps ``load_textfiles`` to keep each set's hypotheses."""

    def __init__(self, fn):
        self.fn, self.hypos = fn, []

    def __call__(self, refs, hypos):
        self.hypos.append(list(hypos))
        return self.fn(refs, hypos)


@pytest.mark.parametrize("case", sorted(KINDS))
def test_evaluate_equals_jax(case, coco_dir, experiments, dataset, tiny_dpt,
                             tmp_path, monkeypatch):
    kind, beam = KINDS[case]
    root, _, _, w2i, i2w = coco_dir
    jcfg, tcfg = _cfgs(root)
    save_dir, files = _tables(tcfg, kind)
    jcap = experiments[kind][0]
    jrec, trec = _Recorder(jeval.load_textfiles), _Recorder(
        teval.load_textfiles)
    monkeypatch.setattr(jeval, "load_textfiles", jrec)
    monkeypatch.setattr(teval, "load_textfiles", trec)
    jdepth = dict(depth_fn=tiny_dpt[0], dpt_variables=tiny_dpt[1]) \
        if kind == "depth-soft" else {}
    want = jeval.evaluate(
        kind, "coco", jcap,
        lambda i: jcli.load_eval_components(save_dir, files[i], jcap,
                                            image_hw=(HW, HW)),
        dataset, w2i, i2w, jcfg, num_sets=2, beam_size=beam, quiet=True,
        scores_pickle=str(tmp_path / "jax.pkl"), **jdepth)

    tcap = tcaptioner.build_captioner(kind, len(w2i), tcfg,
                                      encoder_dtype=torch.float32,
                                      resnet_layers=LAYERS, device="cpu")
    launches = (decode_seq.LAUNCHES, nic_seq.LAUNCHES, beam_seq.LAUNCHES)
    got = teval.evaluate(
        kind, "coco", tcap,
        lambda i: cli.load_eval_components(save_dir, files[i], tcap),
        dataset, w2i, i2w, tcfg,
        depth_fn=tiny_dpt[2] if kind == "depth-soft" else None,
        num_sets=2, beam_size=beam, quiet=True,
        scores_pickle=str(tmp_path / "port.pkl"))
    # the CPU path runs the plain versions and launches no kernel
    assert (decode_seq.LAUNCHES, nic_seq.LAUNCHES,
            beam_seq.LAUNCHES) == launches

    assert len(trec.hypos) == len(jrec.hypos) == 2
    assert trec.hypos == jrec.hypos
    assert trec.hypos[0] != trec.hypos[1]          # the sets differ
    assert len(set(trec.hypos[0])) > 1             # captions differ
    assert got == want
    assert list(got) == list(teval.METRIC_KEYS)
    assert all(len(v) == 2 and np.all(np.isfinite(v)) for v in got.values())
    with open(tmp_path / "port.pkl", "rb") as f:
        port_pickle = pickle.load(f)
    with open(tmp_path / "jax.pkl", "rb") as f:
        assert port_pickle == pickle.load(f) == got


def test_sets_reach_the_kernels_weights(coco_dir, experiments, dataset):
    """Each set's decoder reaches the decode: the decoders repack their
    kernel weights on every call, so set 2 after set 1 captions as set 2
    alone does."""
    root, _, _, w2i, i2w = coco_dir
    _, tcfg = _cfgs(root)
    save_dir, files = _tables(tcfg, "base-soft")

    def hypos(sets):
        cap = tcaptioner.build_captioner(
            "base-soft", len(w2i), tcfg, encoder_dtype=torch.float32,
            resnet_layers=LAYERS, device="cpu")
        rec = _Recorder(load_textfiles)
        teval.load_textfiles, saved = rec, teval.load_textfiles
        try:
            teval.evaluate("base-soft", "coco", cap,
                           lambda i: cli.load_eval_components(
                               save_dir, files[sets[i - 1]], cap),
                           dataset, w2i, i2w, tcfg, num_sets=len(sets),
                           quiet=True)
        finally:
            teval.load_textfiles = saved
        return rec.hypos

    both = hypos([1, 2])
    assert both[0] != both[1]
    assert hypos([2]) == both[1:]


def test_load_eval_components_trees(coco_dir, experiments):
    root, _, _, w2i, _ = coco_dir
    _, tcfg = _cfgs(root)
    for kind in ("base-soft", "depth-soft", "nic"):
        save_dir, files = _tables(tcfg, kind)
        cap = tcaptioner.build_captioner(kind, len(w2i), tcfg,
                                         resnet_layers=LAYERS, device="cpu")
        enc, params, stats = cli.load_eval_components(save_dir, files[2],
                                                      cap)
        want_enc, want_params, want_stats = experiments[kind][1][2]
        for got, want in ((enc, want_enc), (params, want_params),
                          (stats, want_stats)):
            flat_got = jax.tree_util.tree_leaves_with_path(got)
            flat_want = jax.tree_util.tree_leaves_with_path(want)
            assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
            for (_, g), (_, w) in zip(flat_got, flat_want):
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_eval_tables_equal_jax(coco_dir):
    root = coco_dir[0]
    jcfg, tcfg = _cfgs(root)
    for use_data in ("coco", "rem_coco", "rem_original"):
        assert cli.eval_data_selection(tcfg, use_data) == \
            jcli.eval_data_selection(jcfg, use_data)
    with pytest.raises(ValueError):
        cli.eval_data_selection(tcfg, "original")
    for atten in ("soft", "hard"):
        for use_ori in (False, True):
            for depth in (False, True):
                for enc in ("cnn", "mlp"):
                    assert cli.eval_tables(tcfg, atten, use_ori, depth,
                                           enc) == jcli.eval_tables(
                        jcfg, atten, use_ori, depth, enc)


@pytest.mark.parametrize("raw,want", [(None, None), ("1,1,1,1", LAYERS),
                                      ("3,8,36,3", (3, 8, 36, 3))])
def test_resnet_layers_from_env(raw, want, monkeypatch):
    if raw is None:
        monkeypatch.delenv("DCAP_RESNET_LAYERS", raising=False)
    else:
        monkeypatch.setenv("DCAP_RESNET_LAYERS", raw)
    assert cli.resnet_layers_from_env() == jcli.resnet_layers_from_env() \
        == want


# ---- pipeline ---------------------------------------------------------------

@pytest.fixture
def f32_builders(monkeypatch):
    """Both packages' builders make f32 encoders, at ResNet blocks
    1,1,1,1 ($DCAP_RESNET_LAYERS)."""
    monkeypatch.setenv("DCAP_RESNET_LAYERS", "1,1,1,1")
    monkeypatch.setattr(jcaptioner, "build_captioner", functools.partial(
        jcaptioner.build_captioner, encoder_dtype=jnp.float32))
    monkeypatch.setattr(tcaptioner, "build_captioner", functools.partial(
        tcaptioner.build_captioner, encoder_dtype=torch.float32))
    monkeypatch.setattr(base_evaluation, "build_captioner",
                        jcaptioner.build_captioner)
    monkeypatch.setattr(evaluation, "build_captioner",
                        tcaptioner.build_captioner)


def _images(ds):
    return np.stack([ds.load_image(i) for i in range(len(ds))])


def test_from_experiment_equals_jax(coco_dir, experiments, dataset,
                                    f32_builders):
    root = coco_dir[0]
    jcfg, tcfg = _cfgs(root)
    images = _images(dataset)
    want = JCaptionPipeline.from_experiment(
        "base-soft", cfg=jcfg, set_idx=2, batch_size=BATCH,
        image_hw=(HW, HW))(list(images))
    pipe = CaptionPipeline.from_experiment(
        "base-soft", cfg=tcfg, set_idx=2, device="cpu",
        batch_buckets=(BATCH,), image_hw=(HW, HW))
    assert pipe.cap.device == torch.device("cpu")
    assert pipe(list(images)) == want
    first = CaptionPipeline.from_experiment(
        "base-soft", cfg=tcfg, set_idx=1, device="cpu",
        batch_buckets=(BATCH,), image_hw=(HW, HW))
    assert first(list(images)) != want


def test_reload_from_experiment(coco_dir, experiments, dataset, tmp_path,
                                f32_builders):
    """After set 1's decoder file is rewritten, ``reload_from_experiment``
    swaps the new weights into the same pipeline: its captions equal a
    fresh pipeline's on the new files. ``reload_weights`` with one tree
    keeps the others."""
    root = coco_dir[0]
    _, tcfg = _cfgs(root)
    src, files = _tables(tcfg, "base-soft")
    tcfg.save_directory_soft = str(tmp_path)
    for i in (1, 2):
        for name in files[i][:2]:
            save_component(str(tmp_path / name),
                           load_component(os.path.join(src, name)))
    images = list(_images(dataset))

    def pipeline(set_idx):
        return CaptionPipeline.from_experiment(
            "base-soft", cfg=tcfg, set_idx=set_idx, device="cpu",
            batch_buckets=(BATCH,), image_hw=(HW, HW))

    pipe = pipeline(1)
    caps1 = pipe(images)
    caps2 = pipeline(2)(images)
    assert caps1 != caps2
    save_component(str(tmp_path / files[1][1]),
                   load_component(str(tmp_path / files[2][1])))
    pipe.reload_from_experiment()
    assert pipe(images) == pipeline(1)(images) == caps2

    enc, params, _ = cli.load_eval_components(src, files[1], pipe.cap)
    pipe.reload_weights(trainable=params)
    assert pipe(images) == caps1
    pipe.reload_weights(frozen_enc=_scale_kernels(enc, 0.5))
    assert pipe(images) != caps1
    pipe.reload_weights(frozen_enc=enc)
    assert pipe(images) == caps1

    bare = CaptionPipeline(pipe.cap, coco_dir[3], coco_dir[4],
                           image_hw=(HW, HW))
    with pytest.raises(RuntimeError, match="from_experiment"):
        bare.reload_from_experiment()


# ---- entry point -------------------------------------------------------------

@pytest.mark.parametrize("words", [["soft", "score", "coco"], ["nic"]])
def test_entry_point_equals_jax(words, coco_dir, experiments, f32_builders,
                                monkeypatch, capsys):
    """``evaluation base soft score coco`` / ``evaluation nic`` on the CPU
    == ``base_evaluation.py`` on the same working directory (224x224
    images; the JAX package's JPEG decoder set aside for PIL's, which the
    port uses)."""
    root = coco_dir[0]
    monkeypatch.chdir(root)
    monkeypatch.setattr(native_loader, "available", lambda: False)
    pkl = (root / "exp_result" / "NIC" / "nic_scores.pkl" if words == ["nic"]
           else root / "exp_result" / "base_soft" / "coco_scores.pkl")
    assert base_evaluation.main(words + ["--num-sets", "2"]) == 0
    with open(pkl, "rb") as f:
        want = pickle.load(f)
    pkl.unlink()
    port_words = words if words == ["nic"] else ["base"] + words
    assert evaluation.main(port_words + ["--num-sets", "2", "--device",
                                         "cpu"]) == 0
    with open(pkl, "rb") as f:
        got = pickle.load(f)
    assert got == want
    assert list(got) == list(teval.METRIC_KEYS)
    assert all(len(v) == 2 for v in got.values())
    out = capsys.readouterr().out
    if words != ["nic"]:
        assert f"subset size : {len(SUBSET)}" in out


def test_entry_point_depth_soft(coco_dir, experiments, monkeypatch, capsys):
    """depth soft score with no DPT weights: the tests' DPT drawn at random,
    with the JAX warning; the pickle holds the seven metrics."""
    root = coco_dir[0]
    monkeypatch.chdir(root)
    monkeypatch.setenv("DCAP_RESNET_LAYERS", "1,1,1,1")
    monkeypatch.setenv("DCAP_TINY_DPT", "1")
    monkeypatch.delenv("DPT_WEIGHTS", raising=False)
    assert evaluation.main(["depth", "soft", "score", "coco", "--num-sets",
                            "1", "--device", "cpu", "--batch-size",
                            "3"]) == 0
    err = capsys.readouterr().err
    assert "WARNING: no DPT weights found (set --dpt-weights" in err
    with open(root / "exp_result" / "CNN_depth_soft" / "coco_scores.pkl",
              "rb") as f:
        got = pickle.load(f)
    assert list(got) == list(teval.METRIC_KEYS)
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in got.values())


def test_entry_point_refusals(coco_dir, tmp_path, monkeypatch, capsys):
    """Only ``sample`` mode is left unported (hard attention and ``--mlp``
    score: ``tests/test_torch_mdepth.py``)."""
    monkeypatch.chdir(coco_dir[0])
    assert list(evaluation.NOT_PORTED) == ["sample"]
    for argv, item in ((["base", "soft", "sample", "dog", "coco"],
                        "item 6"),
                       (["depth", "hard", "sample", "dog", "coco"],
                        "item 6")):
        assert evaluation.main(argv + ["--device", "cpu"]) == 2
        assert f"ROADMAP.md, Queue A {item})" in capsys.readouterr().err
    assert evaluation.main(["base", "soft", "score", "original",
                            "--device", "cpu"]) == 1
    assert evaluation.main(["base", "soft", "train", "coco"]) == 1


def test_entry_point_reads_dpt_weights(coco_dir, experiments, tiny_dpt,
                                       tmp_path, monkeypatch, capsys):
    """``--dpt-weights`` and $DPT_WEIGHTS name an Omnidata checkpoint (the
    tests' tiny DPT in its layout, through ``chip_smoke.py``'s inverse
    map): no random-DPT warning, and the same scores either way (the maps
    themselves are held to the JAX DPT's in
    ``tests/test_torch_pth_sets.py``)."""
    import chip_smoke
    root = coco_dir[0]
    monkeypatch.chdir(root)
    monkeypatch.setenv("DCAP_RESNET_LAYERS", "1,1,1,1")
    monkeypatch.setenv("DCAP_TINY_DPT", "1")
    monkeypatch.delenv("DPT_WEIGHTS", raising=False)
    ckpt = tmp_path / "omnidata.ckpt"
    torch.save({"state_dict": {
        "model." + k: torch.from_numpy(np.array(v)) for k, v in
        chip_smoke.ref_dpt(tiny_dpt[1]["params"]).items()}}, ckpt)
    pkl = root / "exp_result" / "CNN_depth_soft" / "coco_scores.pkl"
    argv = ["depth", "soft", "score", "coco", "--num-sets", "1", "--device",
            "cpu", "--batch-size", "3"]
    got = []
    for flags, env in ((["--dpt-weights", str(ckpt)], None),
                       ([], str(ckpt))):
        if env:
            monkeypatch.setenv("DPT_WEIGHTS", env)
        assert evaluation.main(argv + flags) == 0
        assert "WARNING: no DPT weights" not in capsys.readouterr().err
        with open(pkl, "rb") as f:
            got.append(pickle.load(f))
    assert got[0] == got[1]
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in got[0].values())