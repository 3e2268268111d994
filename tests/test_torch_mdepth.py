"""The MLP-depth kinds (mdepth-soft, mdepth-hard) and the scored evaluation
of the kinds this slice adds: the port == the JAX package, on the CPU.

* ``img_to_patch`` exactly equal to JAX's; ``DepthMLPEncoder`` within
  atol 1e-5 on bridged weights (f32 products of 256, 128 and 64 terms).
* Concat fusion: bf16 RGB and f32 depth features join as f32 [B, K, D +
  32]; the concat decoder's greedy and beam tokens integer-equal to JAX's
  with soft and hard attention (hard on JAX's own Gumbel draws, replayed
  through ``att_noise``), beam scores within 1e-5.
* The whole mdepth-soft and mdepth-hard caption programs (ResNet blocks
  1,1,1,1 at 64x64, f32 encoders, the tests' tiny DPT): tokens
  integer-equal to the JAX ``make_caption_fn``'s, greedy and beam 3.
* An mdepth set written with ``params_to_jax`` + ``save_component`` in the
  JAX trainer's layout and read back by ``load_eval_components``: every
  leaf byte-equal, the MLP's statistics empty.
* ``evaluate``: two checkpoint sets per kind written by the JAX
  ``save_component`` (as ``tests/test_torch_evaluate.py``), scored by the
  JAX ``evaluate`` and the port's: hypotheses per set and the seven scores
  exactly equal (``==``) for base-hard (greedy and beam 3; JAX keys set k
  with ``PRNGKey(k)`` and splits it once a batch, and that chain's draws
  reach the port through ``evaluate``'s ``att_noise`` hook) and
  mdepth-soft.
* The entry point scores ``hard`` and ``--mlp`` instead of refusing them.
"""

import os
import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from depth_image_captioning_pub_tpu import cli as jcli
from depth_image_captioning_pub_tpu.config import ConfigEval as JConfigEval
from depth_image_captioning_pub_tpu.config import ConfigTrain
from depth_image_captioning_pub_tpu.data.synthetic import make_synthetic_coco
from depth_image_captioning_pub_tpu.data.tokenizer import SPECIAL
from depth_image_captioning_pub_tpu.data.vocab import (
    build_vocab, captions_from_coco_json, save_vocab)
from depth_image_captioning_pub_tpu.engine import evaluate as jeval
from depth_image_captioning_pub_tpu.models import captioner as jcaptioner
from depth_image_captioning_pub_tpu.models import depth_encoders as jdenc
from depth_image_captioning_pub_tpu.models import dpt as jdpt
from depth_image_captioning_pub_tpu.models.decoder import (
    AttentionDecoder as JaxAttentionDecoder)
from depth_image_captioning_pub_tpu.utils.checkpoint import (
    save_component as jsave_component)
from depth_image_captioning_pub_torch import cli, evaluation
from depth_image_captioning_pub_torch.config import ConfigEval
from depth_image_captioning_pub_torch.data import coco
from depth_image_captioning_pub_torch.engine import evaluate as teval
from depth_image_captioning_pub_torch.models import captioner as tcaptioner
from depth_image_captioning_pub_torch.models import depth_encoders as tdenc
from depth_image_captioning_pub_torch.models.decoder import AttentionDecoder
from depth_image_captioning_pub_torch.models.dpt import (
    TINY_DPT, DPTDepthEstimator)
from depth_image_captioning_pub_torch.ops.kernels import (
    beam_seq, decode_seq, decode_step)
from depth_image_captioning_pub_torch.utils.checkpoint import save_component
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    dpt_params_from_jax, flax_state_dict, params_from_jax, params_to_jax)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

LAYERS = (1, 1, 1, 1)
HW = 64
MAX_LEN = 8
BATCH = 4
SUBSET = [0, 1, 3, 5, 6, 7]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, dict(tree))


def _gumbel_hook(key):
    """Replays the draws of JAX greedy and beam search under ``key``:
    ``gumbel(fold_in(key, t), shape)``."""
    return lambda t, shape: torch.from_numpy(np.array(jax.random.gumbel(
        jax.random.fold_in(key, t), tuple(shape))))


# ---- img_to_patch and the MLP -----------------------------------------------

@pytest.mark.parametrize("shape", [(2, 224, 224, 1), (3, 64, 32, 1)])
def test_img_to_patch_matches_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jdenc.img_to_patch(jnp.asarray(x)))
    got = tdenc.img_to_patch(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the patch order: row-major over the grid, pixels row-major inside
    np.testing.assert_array_equal(got[0, 1].numpy(), x[0, :16, 16:32, 0]
                                  .ravel())
    with pytest.raises(ValueError, match="multiples of 16"):
        tdenc.img_to_patch(torch.zeros(1, 20, 32, 1))


@pytest.mark.parametrize("seed", [0, 1])
def test_depth_mlp_encoder_matches_jax(seed):
    mlp = jdenc.DepthMLPEncoder()
    patches = np.random.default_rng(seed).standard_normal(
        (3, 196, 256)).astype(np.float32)
    variables = _np_tree(mlp.init(jax.random.PRNGKey(seed),
                                  jnp.asarray(patches)))
    assert set(variables) == {"params"}
    want = np.asarray(mlp.apply(variables, jnp.asarray(patches)))
    port = tdenc.DepthMLPEncoder(device="cpu")
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          flax_state_dict(variables["params"]).items()},
                         strict=True)
    got = port(torch.from_numpy(patches))
    assert got.dtype == torch.float32 and got.shape == (3, 196, 32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5)
    assert (want > 0).any() and (want == 0).any()     # the last ReLU
    # the port's own init: torch-default bounds 1/sqrt(fan_in)
    port.reset_parameters(torch.Generator().manual_seed(seed))
    for lin in port.layers():
        bound = lin.in_features ** -0.5
        assert lin.weight.abs().max() <= bound
        assert lin.bias.abs().max() <= bound


# ---- concat fusion in the decoder -------------------------------------------

VOCAB, K, D, DD, DIM = 37, 12, 16, 4, 8
START, END = 1, 2


def _jax_concat_decoder(kind, seed):
    dec = JaxAttentionDecoder(vocab_size=VOCAB, dim_attention=DIM,
                              dim_embedding=DIM, dim_encoder=D,
                              dim_decoder=DIM, attention_kind=kind,
                              fusion="concat", dim_depth=DD)
    params = dec.init(jax.random.PRNGKey(seed), jnp.zeros((1, K, D)),
                      jnp.zeros((1, 5), jnp.int32), jnp.zeros((1, K, DD)),
                      rng=jax.random.PRNGKey(0))["params"]
    params = _np_tree(params)
    params["out_w"] = params["out_w"] * 20.0
    params["out_b"][END] += 0.5
    return dec, params


def _port_concat_decoder(kind, params):
    dec = AttentionDecoder(VOCAB, DIM, DIM, D, DIM, fusion="concat",
                           device="cpu", attention_kind=kind, dim_depth=DD)
    assert dec.dim_enc_eff == D + DD
    dec.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()},
                        strict=True)
    return dec


def test_concat_fuse_promotes_to_f32():
    dec = AttentionDecoder(VOCAB, DIM, DIM, D, DIM, fusion="concat",
                           device="cpu", dim_depth=DD)
    rgb = torch.randn(2, K, D).to(torch.bfloat16)
    dep = torch.randn(2, K, DD)
    fused = dec.fuse(rgb, dep)
    want = np.asarray(jnp.concatenate(
        [jnp.asarray(rgb.float().numpy()).astype(jnp.bfloat16),
         jnp.asarray(dep.numpy())], axis=-1))
    assert fused.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(fused.numpy(), want)


@pytest.mark.parametrize("beam", [1, 3])
@pytest.mark.parametrize("kind", ["soft", "hard"])
def test_concat_decoder_matches_jax(kind, beam):
    jdec, params = _jax_concat_decoder(kind, seed=2)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((5, K, D)).astype(np.float32)
    dep = rng.standard_normal((5, K, DD)).astype(np.float32) * 4.0
    key = jax.random.PRNGKey(4)
    hard = {"att_noise": _gumbel_hook(key)} if kind == "hard" else {}
    port = _port_concat_decoder(kind, params)
    args = (jnp.asarray(feats), START)
    targs = (torch.from_numpy(feats), START)
    if beam == 1:
        want, _ = jdec.apply({"params": params}, *args, jnp.asarray(dep),
                             max_length=9, rng=key, end_id=END,
                             method=JaxAttentionDecoder.greedy_sample)
        got = port.greedy_sample(*targs, torch.from_numpy(dep),
                                 max_length=9, end_id=END, **hard)
    else:
        want, want_s = jdec.apply(
            {"params": params}, *args, END, jnp.asarray(dep), beam_size=3,
            max_length=9, rng=key, early_exit=True,
            method=JaxAttentionDecoder.beam_sample)
        got, got_s = port.beam_sample(*targs, END, torch.from_numpy(dep),
                                      beam_size=3, max_length=9, **hard)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len({tuple(r) for r in np.asarray(want)}) > 1


# ---- the mdepth slices ------------------------------------------------------

def _scale_kernels(tree, factor):
    return {k: (_scale_kernels(v, factor) if isinstance(v, dict)
                else np.asarray(v) * (factor if k == "kernel" else 1.0))
            for k, v in tree.items()}


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


def _jax_cap(kind, n_words):
    return jcaptioner.build_captioner(kind, n_words, JConfigEval(),
                                      encoder_dtype=jnp.float32,
                                      resnet_layers=LAYERS)


_TREES = {}


def _trees(kind, w2i, seed):
    """A checkpoint set of ``kind`` as the JAX trainer would hold it:
    (frozen encoder, trainable, stats), scaled so that the features are
    image-dependent, the depth features count beside the RGB ones and the
    attention scores are of order 1 (hard attention's noise matters).
    One JAX init per kind, vocabulary size and seed, shared by the cases,
    which only read it."""
    key = (kind, len(w2i), seed)
    if key not in _TREES:
        _TREES[key] = _init_trees(kind, len(w2i), seed)
    return _TREES[key]


def _init_trees(kind, n_words, seed):
    jcap = _jax_cap(kind, n_words)
    params, frozen, stats = jcap.init(jax.random.PRNGKey(seed),
                                      image_hw=(HW, HW))
    trainable = _np_tree(params)
    dec = dict(trainable["decoder"])
    if kind.endswith("hard"):
        dec["att_w_full"] = dec["att_w_full"] * 1e-3
    trainable["decoder"] = dec
    if "depth_encoder" in trainable:
        trainable["depth_encoder"] = _scale_kernels(
            trainable["depth_encoder"], 8.0)
    enc = _scale_kernels(_np_tree(frozen)["encoder"], 3.0)
    return jcap, enc, trainable, _np_tree(stats)


@pytest.fixture(scope="module")
def vocab():
    words = ["a", "dog", "runs", "in", "park", "cat", "sits", "on", "mat",
             "man", "rides", "bike", "red", "blue"]
    words += [SPECIAL.start, SPECIAL.end, SPECIAL.unk, SPECIAL.null]
    w2i = {w: i for i, w in enumerate(words)}
    return w2i, {i: w for w, i in w2i.items()}


@pytest.mark.parametrize("beam", [1, 3])
@pytest.mark.parametrize("kind", ["mdepth-soft", "mdepth-hard"])
def test_mdepth_slice_matches_jax(kind, beam, vocab, tiny_dpt):
    w2i, _ = vocab
    jcap, enc, trainable, stats = _trees(kind, w2i, seed=0)
    assert stats == {}
    images = np.random.default_rng(5).integers(0, 256, (6, HW, HW, 3),
                                               dtype=np.uint8)
    start, end = w2i[SPECIAL.start], w2i[SPECIAL.end]
    key = jax.random.PRNGKey(6)
    jfn = jeval.make_caption_fn(jcap, start, max_length=MAX_LEN,
                                depth_fn=tiny_dpt[0], end_id=end,
                                beam_size=beam)
    frozen = {"encoder": enc, "dpt": tiny_dpt[1]}
    want = np.asarray(jfn(*(jax.tree_util.tree_map(jnp.asarray, t)
                            for t in (frozen, trainable, stats)),
                          jnp.asarray(images), key))
    cap = tcaptioner.build_captioner(kind, len(w2i), ConfigTrain(),
                                     encoder_dtype=torch.float32,
                                     resnet_layers=LAYERS, device="cpu")
    assert isinstance(cap.depth_module, tdenc.DepthMLPEncoder)
    params_from_jax(cap, trainable, {"encoder": enc}, stats)
    fn = teval.make_caption_fn(cap, start, MAX_LEN, tiny_dpt[2],
                               end_id=end, beam_size=beam)
    launches = (decode_seq.LAUNCHES, beam_seq.LAUNCHES, decode_step.LAUNCHES)
    kw = {"att_noise": _gumbel_hook(key)} if kind.endswith("hard") else {}
    got = fn(torch.from_numpy(images), **kw)
    assert (decode_seq.LAUNCHES, beam_seq.LAUNCHES,
            decode_step.LAUNCHES) == launches
    np.testing.assert_array_equal(got.numpy(), want)
    assert len({tuple(r) for r in want}) > 1
    # the depth branch reaches the decoder: the features are [B, 196, 2080]
    x = torch.from_numpy(images)
    from depth_image_captioning_pub_torch.ops.image_ops import to_unit_float
    dep = cap.depth_encoder_apply()(tiny_dpt[2](to_unit_float(x)))
    assert dep.shape == (6, 196, 32) and dep.dtype == torch.float32


def test_mdepth_set_round_trip(vocab, tmp_path):
    """``params_to_jax`` -> ``save_component`` in the JAX trainer's mdepth
    layout -> ``load_eval_components``: every leaf byte-equal, the MLP's
    statistics {} and its bundle read; loaded back, the weights equal."""
    w2i, _ = vocab
    cap = tcaptioner.build_captioner("mdepth-hard", len(w2i), ConfigTrain(),
                                     resnet_layers=LAYERS, device="cpu")
    cap.init(torch.Generator().manual_seed(3))
    trainable, frozen, stats = params_to_jax(cap)
    assert stats == {} and set(trainable["depth_encoder"]) == {"l1", "l2",
                                                                "l3"}
    assert trainable["depth_encoder"]["l1"]["kernel"].shape == (256, 128)
    cfg = ConfigEval()
    cfg.save_directory_Cdep_hard = str(tmp_path)
    save_dir, files = cli.eval_tables(cfg, "hard", False, True, "mlp")
    names = files[1]
    assert names[2].startswith("mdepth_")
    save_component(os.path.join(save_dir, names[0]), frozen["encoder"])
    save_component(os.path.join(save_dir, names[1]), trainable["decoder"])
    save_component(os.path.join(save_dir, names[2]),
                   {"params": trainable["depth_encoder"],
                    "batch_stats": stats})
    enc, params, got_stats = cli.load_eval_components(save_dir, names, cap)
    assert got_stats == {}
    for got, want in ((enc, frozen["encoder"]), (params, trainable)):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (_, g), (_, w) in zip(flat_got, flat_want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    other = tcaptioner.build_captioner("mdepth-hard", len(w2i),
                                       ConfigTrain(), resnet_layers=LAYERS,
                                       device="cpu")
    params_from_jax(other, params, {"encoder": enc}, got_stats)
    for (name, a), (_, b) in zip(cap.state_dict().items(),
                                 other.state_dict().items()):
        assert torch.equal(a, b), name
    with pytest.raises(KeyError, match="no batch statistics"):
        params_from_jax(other, params, {"encoder": enc},
                        {"bn1": {"mean": np.zeros(1)}})


# ---- evaluate ---------------------------------------------------------------

EVAL_KINDS = {"base-hard": ("base-hard", 1), "base-hard-beam3":
              ("base-hard", 3), "mdepth-soft": ("mdepth-soft", 1)}


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
    w2i, i2w = build_vocab(captions_from_coco_json(ann), [], min_count=1)
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


def _cfgs(root):
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


def _tables(cfg, kind):
    base, atten = kind.split("-")
    return cli.eval_tables(cfg, atten, False, base == "mdepth",
                           "mlp" if base == "mdepth" else "cnn")


@pytest.fixture(scope="module")
def experiments(coco_dir):
    """Two checkpoint sets of base-hard and of mdepth-soft, written by the
    JAX ``save_component`` in ``eval_tables``' layout under the working
    directory: one encoder (and depth MLP), the decoders of set i from
    PRNGKey(i - 1)."""
    root, _, _, w2i, _ = coco_dir
    _, tcfg = _cfgs(root)
    out = {}
    for kind in ("base-hard", "mdepth-soft"):
        save_dir, files = _tables(tcfg, kind)
        jcap, enc, first, stats = _trees(kind, w2i, seed=0)
        for i in (1, 2):
            trainable = first if i == 1 else _trees(kind, w2i, seed=1)[2]
            names = files[i]
            jsave_component(os.path.join(save_dir, names[0]), enc)
            jsave_component(os.path.join(save_dir, names[1]),
                            trainable["decoder"])
            if kind == "mdepth-soft":
                jsave_component(os.path.join(save_dir, names[2]),
                                {"params": first["depth_encoder"],
                                 "batch_stats": stats})
        out[kind] = jcap
    return out


class _Recorder:
    """Wraps ``load_textfiles`` to keep each set's hypotheses."""

    def __init__(self, fn):
        self.fn, self.hypos = fn, []

    def __call__(self, refs, hypos):
        self.hypos.append(list(hypos))
        return self.fn(refs, hypos)


def jax_eval_noise(set_idx, batch_idx):
    """Batch ``batch_idx``'s draws in JAX ``evaluate``'s set ``set_idx``:
    ``PRNGKey(set_idx)`` split once a batch."""
    rng = jax.random.PRNGKey(set_idx)
    for _ in range(batch_idx + 1):
        rng, key = jax.random.split(rng)
    return _gumbel_hook(key)


def _port_eval(kind, beam, coco_dir, dataset, tiny_dpt, **kw):
    root, _, _, w2i, i2w = coco_dir
    _, tcfg = _cfgs(root)
    save_dir, files = _tables(tcfg, kind)
    cap = tcaptioner.build_captioner(kind, len(w2i), tcfg,
                                     encoder_dtype=torch.float32,
                                     resnet_layers=LAYERS, device="cpu")
    rec = _Recorder(teval.load_textfiles)
    saved, teval.load_textfiles = teval.load_textfiles, rec
    try:
        got = teval.evaluate(
            kind, "coco", cap,
            lambda i: cli.load_eval_components(save_dir, files[i], cap),
            dataset, w2i, i2w, tcfg,
            depth_fn=tiny_dpt[2] if kind == "mdepth-soft" else None,
            num_sets=2, beam_size=beam, quiet=True, **kw)
    finally:
        teval.load_textfiles = saved
    return got, rec.hypos


@pytest.mark.parametrize("case", sorted(EVAL_KINDS))
def test_evaluate_equals_jax(case, coco_dir, experiments, dataset, tiny_dpt,
                             monkeypatch):
    kind, beam = EVAL_KINDS[case]
    root, _, _, w2i, i2w = coco_dir
    jcfg, tcfg = _cfgs(root)
    save_dir, files = _tables(tcfg, kind)
    jcap = experiments[kind]
    jrec = _Recorder(jeval.load_textfiles)
    monkeypatch.setattr(jeval, "load_textfiles", jrec)
    jdepth = dict(depth_fn=tiny_dpt[0], dpt_variables=tiny_dpt[1]) \
        if kind == "mdepth-soft" else {}
    want = jeval.evaluate(
        kind, "coco", jcap,
        lambda i: jcli.load_eval_components(save_dir, files[i], jcap,
                                            image_hw=(HW, HW)),
        dataset, w2i, i2w, jcfg, num_sets=2, beam_size=beam, quiet=True,
        **jdepth)
    hard = kind.endswith("hard")
    got, hypos = _port_eval(kind, beam, coco_dir, dataset, tiny_dpt,
                            att_noise=jax_eval_noise if hard else None)
    assert hypos == jrec.hypos and len(hypos) == 2
    assert hypos[0] != hypos[1] and len(set(hypos[0])) > 1
    assert got == want
    assert list(got) == list(teval.METRIC_KEYS)
    if hard:
        # the noise reaches the captions: other draws, other hypotheses
        _, other = _port_eval(kind, beam, coco_dir, dataset, tiny_dpt,
                              att_noise=lambda s, b: jax_eval_noise(s + 7,
                                                                    b))
        assert other != hypos


def test_evaluate_hard_is_seeded_per_set(coco_dir, experiments, dataset,
                                         tiny_dpt):
    """Without a hook, set k draws from a generator seeded with k: two
    runs give the same hypotheses."""
    first = _port_eval("base-hard", 1, coco_dir, dataset, tiny_dpt)
    again = _port_eval("base-hard", 1, coco_dir, dataset, tiny_dpt)
    assert first == again
    assert all(np.isfinite(v).all() for v in first[0].values())


@pytest.mark.parametrize("argv,pkl", [
    (["base", "hard", "score", "coco"], "base_hard/coco_scores.pkl"),
    (["depth", "soft", "score", "coco", "--mlp"],
     "CNN_depth_soft/mdepth_coco_scores.pkl"),
])
def test_entry_point_scores_hard_and_mlp(argv, pkl, coco_dir, experiments,
                                         monkeypatch):
    """``evaluation ... hard`` and ``--mlp`` score (224x224 images, the
    tests' DPT drawn at random); the mdepth pickle gets its prefix."""
    root = coco_dir[0]
    monkeypatch.chdir(root)
    monkeypatch.setenv("DCAP_RESNET_LAYERS", "1,1,1,1")
    monkeypatch.setenv("DCAP_TINY_DPT", "1")
    monkeypatch.delenv("DPT_WEIGHTS", raising=False)
    assert evaluation.main(argv + ["--num-sets", "2", "--device", "cpu",
                                   "--batch-size", "3"]) == 0
    with open(root / "exp_result" / pkl, "rb") as f:
        got = pickle.load(f)
    assert list(got) == list(teval.METRIC_KEYS)
    assert all(len(v) == 2 and np.all(np.isfinite(v)) for v in got.values())


@pytest.mark.parametrize("kind", ["base-hard", "depth-hard", "mdepth-soft",
                                  "mdepth-hard"])
def test_cli_caption_new_kinds(kind, capsys):
    """``cli caption --kind`` takes the four kinds; seeded weights and
    draws caption the same way on every run."""
    args = ["caption", "--kind", kind, "--random", "2", "--device", "cpu",
            "--vocab-size", "30", "--resnet-layers", "1,1,1,1",
            "--image-size", "64", "--tiny-dpt", "--max-length", "5",
            "--batch-buckets", "2"]
    capsys.readouterr()
    cli.main(args)
    first = capsys.readouterr().out.splitlines()
    cli.main(args)
    assert capsys.readouterr().out.splitlines() == first
    assert len(first) == 2
