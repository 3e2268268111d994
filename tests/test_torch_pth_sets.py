"""Reference ``.pth`` checkpoint sets and the Omnidata DPT in the port ==
in the JAX package, on the CPU.

* ``evaluate`` over checkpoint sets in the reference's own files (the
  ``.pth`` state dicts of ``eval_tables``' basenames, no msgpack twin):
  two sets each of base-soft, depth-soft (the depth CNN's ``.pth`` holds
  its BN statistics) and nic (the encoder ``.pth`` bundles the backbone
  and the projection), written from the JAX package's init trees through
  ``chip_smoke.py``'s inverse maps (reference key names, checked against
  the JAX tests' twins in ``tests/test_torch_bridge.py``). The JAX
  ``evaluate`` reads the same files; hypotheses per set and the seven
  scores must be equal (f32 encoders, ResNet blocks 1,1,1,1: the JAX
  bridge's ResNet-152 block counts are cut to the tiny backbone's).
* ``CaptionPipeline.from_experiment`` / ``reload_from_experiment`` over a
  ``.pth`` set caption as a pipeline over the same trees loaded directly.
* A tiny Omnidata ``.ckpt`` (``{"state_dict": {"model." + k}}`` and a
  pickled object beside it) through ``cli.eval_depth_fn`` ($DPT_WEIGHTS,
  $DCAP_TINY_DPT, the DPT in f32) and through
  ``DPTDepthEstimator.load_weights`` at a 224x224 input (position
  embeddings resized 24 -> 14): depth maps within 1e-4 of the JAX DPT's
  on the JAX bridge's tree; ``utils.convert --kind dpt``'s msgpack loads
  to the same maps.
"""

import functools
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import chip_smoke
from depth_image_captioning_pub_tpu import cli as jcli
from depth_image_captioning_pub_tpu.engine import evaluate as jeval
from depth_image_captioning_pub_tpu.models import dpt as jdpt
from depth_image_captioning_pub_tpu.utils import torch_bridge as jtb
from depth_image_captioning_pub_torch import cli
from depth_image_captioning_pub_torch.engine import evaluate as teval
from depth_image_captioning_pub_torch.models import captioner as tcaptioner
from depth_image_captioning_pub_torch.models import dpt as tdpt
from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
from depth_image_captioning_pub_torch.utils import convert as tconvert
from depth_image_captioning_pub_torch.utils import torch_bridge as ttb
from depth_image_captioning_pub_torch.utils.jax_bridge import params_from_jax

from test_dpt import _make_tiny_sd
from test_torch_evaluate import (  # noqa: F401 (fixtures)
    BATCH, HW, LAYERS, _cfgs, _jax_cap, _np_tree, _random_stats,
    _Recorder, _scale_kernels, _tables, coco_dir, dataset, tiny_dpt)

ATOL = 1e-4       # the tiny DPT twin's (tests/test_torch_dpt.py)
DPT_TINY = dict(resnet_layers=(1, 1, 1), vit_blocks=3)


def _save_pth(path, sd):
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               path)


def _write_pth_sets(kind, w2i, save_dir, files):
    """Two sets of ``kind`` as the reference's ``.pth`` files (encoder
    shared, decoders from PRNGKey(0) and (1), the depth CNN with random BN
    statistics); returns (the JAX captioner, {set: trees})."""
    jcap = _jax_cap(kind, w2i)
    os.makedirs(save_dir, exist_ok=True)
    sets = {}
    for i in (1, 2):
        params, frozen, stats = (_np_tree(t) for t in jcap.init(
            jax.random.PRNGKey(i - 1), image_hw=(HW, HW)))
        if kind == "base-soft":     # some captions end before MAX_LEN
            params["decoder"]["out_b"][w2i["<end>"]] += 1.0
        if i == 1:
            enc = _scale_kernels(frozen["encoder"],
                                 1.5 if kind == "depth-soft" else 3.0)
            dstats = _random_stats(stats, np.random.default_rng(4))
        names = [os.path.join(save_dir, n) for n in files[i]]
        trees = {"decoder": params["decoder"]}
        if kind == "nic":
            trees["enc_linear"] = params["enc_linear"]
            _save_pth(names[0], chip_smoke.ref_nic_encoder(
                enc, params["enc_linear"]))
            _save_pth(names[1], chip_smoke.ref_nic_decoder(params["decoder"]))
        else:
            _save_pth(names[0], chip_smoke.ref_encoder(enc))
            _save_pth(names[1], chip_smoke.ref_decoder(params["decoder"]))
        if kind == "depth-soft":
            trees["depth_encoder"] = _scale_kernels(params["depth_encoder"],
                                                    6.0)
            _save_pth(names[2], chip_smoke.ref_depth_cnn(
                trees["depth_encoder"], dstats))
        sets[i] = (enc, trees, dstats if kind == "depth-soft" else {})
    return jcap, sets


@pytest.fixture(scope="module")
def pth_sets(coco_dir):
    root, _, _, w2i, _ = coco_dir
    _, tcfg = _cfgs(root)
    return {kind: _write_pth_sets(kind, w2i, *_tables(tcfg, kind))
            for kind in ("base-soft", "depth-soft", "nic")}


@pytest.fixture
def tiny_jax_bridge(monkeypatch):
    """The JAX bridge's ResNet at the tiny backbone's block counts (its
    callers pass ResNet-152's)."""
    resnet = jtb.resnet_to_flax
    monkeypatch.setattr(jtb, "resnet_to_flax",
                        lambda sd, layers=None: resnet(sd, LAYERS))


@pytest.mark.parametrize("kind", ["base-soft", "depth-soft", "nic"])
def test_pth_sets_score_as_jax(kind, coco_dir, pth_sets, dataset, tiny_dpt,
                               tiny_jax_bridge, tmp_path, monkeypatch):
    root, _, _, w2i, i2w = coco_dir
    jcfg, tcfg = _cfgs(root)
    save_dir, files = _tables(tcfg, kind)
    assert not [n for n in os.listdir(save_dir) if n.endswith(".msgpack")]
    jcap = pth_sets[kind][0]
    jrec, trec = (_Recorder(jeval.load_textfiles),
                  _Recorder(teval.load_textfiles))
    monkeypatch.setattr(jeval, "load_textfiles", jrec)
    monkeypatch.setattr(teval, "load_textfiles", trec)
    depth = kind == "depth-soft"
    want = jeval.evaluate(
        kind, "coco", jcap,
        lambda i: jcli.load_eval_components(save_dir, files[i], jcap,
                                            image_hw=(HW, HW)),
        dataset, w2i, i2w, jcfg, num_sets=2, quiet=True,
        **(dict(depth_fn=tiny_dpt[0], dpt_variables=tiny_dpt[1])
           if depth else {}))
    tcap = tcaptioner.build_captioner(kind, len(w2i), tcfg,
                                      encoder_dtype=torch.float32,
                                      resnet_layers=LAYERS, device="cpu")
    got = teval.evaluate(
        kind, "coco", tcap,
        lambda i: cli.load_eval_components(save_dir, files[i], tcap),
        dataset, w2i, i2w, tcfg, depth_fn=tiny_dpt[2] if depth else None,
        num_sets=2, quiet=True)
    assert len(trec.hypos) == len(jrec.hypos) == 2
    assert trec.hypos == jrec.hypos
    assert trec.hypos[0] != trec.hypos[1] and len(set(trec.hypos[0])) > 1
    assert got == want
    assert all(len(v) == 2 and np.all(np.isfinite(v)) for v in got.values())


@pytest.mark.parametrize("kind", ["base-soft", "depth-soft", "nic"])
def test_pth_set_trees(kind, coco_dir, pth_sets):
    """``load_eval_components`` on a ``.pth`` set gives the trees that were
    written, bit for bit (the bridge's f32 leaves)."""
    root, _, _, w2i, _ = coco_dir
    _, tcfg = _cfgs(root)
    save_dir, files = _tables(tcfg, kind)
    cap = tcaptioner.build_captioner(kind, len(w2i), tcfg,
                                     resnet_layers=LAYERS, device="cpu")
    got = cli.load_eval_components(save_dir, files[2], cap)
    want = pth_sets[kind][1][2]
    for g, w in zip(got, want):
        flat_g = jax.tree_util.tree_leaves_with_path(g)
        flat_w = jax.tree_util.tree_leaves_with_path(w)
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        for (_, a), (_, b) in zip(flat_g, flat_w):
            assert np.array_equal(a, np.asarray(b, np.float32))


def test_nic_set_without_projection_raises(coco_dir, pth_sets, tmp_path):
    """A NIC set with neither the ``enc_linear`` msgpack nor the bundled
    encoder ``.pth`` (ROADMAP.md's deliberate divergence 2)."""
    root, _, _, w2i, _ = coco_dir
    _, tcfg = _cfgs(root)
    save_dir, files = _tables(tcfg, "nic")
    cap = tcaptioner.build_captioner("nic", len(w2i), tcfg,
                                     resnet_layers=LAYERS, device="cpu")
    enc = cli.load_eval_components(save_dir, files[1], cap)[0]
    from depth_image_captioning_pub_torch.utils.checkpoint import (
        save_component)
    save_component(str(tmp_path / files[1][0]), enc)
    os.symlink(os.path.join(save_dir, files[1][1]), tmp_path / files[1][1])
    with pytest.raises(FileNotFoundError, match="enc_linear"):
        cli.load_eval_components(str(tmp_path), files[1], cap)


def test_from_experiment_reads_pth_sets(coco_dir, pth_sets, dataset,
                                        tmp_path, monkeypatch):
    """``from_experiment`` over a ``.pth`` set, then
    ``reload_from_experiment`` (the server's ``/reload``) after the set's
    decoder ``.pth`` is replaced by set 2's: the captions of a pipeline
    over the written trees loaded directly."""
    root, _, _, w2i, i2w = coco_dir
    _, tcfg = _cfgs(root)
    src, files = _tables(tcfg, "base-soft")
    tcfg.save_directory_soft = str(tmp_path)
    for name in files[1]:
        os.symlink(os.path.join(src, name), tmp_path / name)
    monkeypatch.setenv("DCAP_RESNET_LAYERS", "1,1,1,1")
    monkeypatch.setattr(tcaptioner, "build_captioner", functools.partial(
        tcaptioner.build_captioner, encoder_dtype=torch.float32))
    images = [dataset.load_image(i) for i in range(len(dataset))]

    def direct(set_idx):
        enc, trees, stats = pth_sets["base-soft"][1][set_idx]
        cap = tcaptioner.build_captioner("base-soft", len(w2i), tcfg,
                                         resnet_layers=LAYERS, device="cpu")
        params_from_jax(cap, trees, {"encoder": enc}, stats)
        return CaptionPipeline(cap, w2i, i2w, max_length=tcfg.max_length,
                               batch_buckets=(BATCH,),
                               image_hw=(HW, HW))(images)

    pipe = CaptionPipeline.from_experiment(
        "base-soft", cfg=tcfg, set_idx=1, device="cpu",
        batch_buckets=(BATCH,), image_hw=(HW, HW))
    first = direct(1)
    assert pipe(images) == first
    os.unlink(tmp_path / files[1][1])
    os.symlink(os.path.join(src, files[2][1]), tmp_path / files[1][1])
    pipe.reload_from_experiment()
    assert pipe(images) == direct(2) != first


@pytest.fixture(scope="module")
def omnidata_ckpt(tmp_path_factory):
    """The path of a tiny DPT-hybrid checkpoint in Omnidata's layout."""
    model = jdpt.DPTDepthModel(**tdpt.TINY_DPT)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    # small weights: random normal ones grow the activations layer by layer
    sd = {k: (v * 0.25).astype(np.float32)
          for k, v in _make_tiny_sd(shapes, seed=7).items()}
    path = str(tmp_path_factory.mktemp("omnidata") / "omnidata_tiny.ckpt")
    torch.save({"state_dict": {"model." + k: torch.from_numpy(v)
                               for k, v in sd.items()},
                "hyper_parameters": {"lr": 1e-4}, "epoch": 3}, path)
    return path


def _images(size=64, n=2):
    return np.random.default_rng(11).integers(0, 256, (n, size, size, 3),
                                              dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_maps(omnidata_ckpt):
    """size -> the JAX DPT's maps of ``_images()`` at that input side, on
    the JAX bridge's tree of the checkpoint (one compile a size)."""
    variables = jtb.dpt_to_flax(jtb.load_state_dict(omnidata_ckpt),
                                **DPT_TINY)
    cache = {}

    def maps(size):
        if size not in cache:
            est = jdpt.DPTDepthEstimator(dtype=jnp.float32, image_size=size)
            est.model = jdpt.DPTDepthModel(**tdpt.TINY_DPT)
            cache[size] = np.asarray(est.depth_fn()(
                variables, jnp.asarray(_images())))
        return cache[size]
    return maps


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=ATOL * max(1.0, np.abs(want).max()))


def test_eval_depth_fn_reads_omnidata(omnidata_ckpt, jax_maps, monkeypatch,
                                      capsys):
    monkeypatch.setenv("DCAP_TINY_DPT", "1")
    monkeypatch.setenv("DPT_WEIGHTS", omnidata_ckpt)
    monkeypatch.setattr(tdpt, "DPTDepthEstimator", functools.partial(
        tdpt.DPTDepthEstimator, dtype=torch.float32))
    images = _images()
    got = cli.eval_depth_fn(cli.ConfigEval(), device="cpu")(
        torch.from_numpy(images))
    assert "WARNING" not in capsys.readouterr().err
    want = jax_maps(64)
    assert got.shape == want.shape == (2, 224, 224, 1)
    _close(got, want)


@pytest.mark.parametrize("route", ["ckpt", "msgpack"])
def test_load_weights_at_224(route, omnidata_ckpt, jax_maps, tmp_path,
                             monkeypatch):
    path = omnidata_ckpt
    if route == "msgpack":
        monkeypatch.setattr(ttb, "dpt_to_flax", functools.partial(
            ttb.dpt_to_flax, **DPT_TINY))
        tconvert.main(["--kind", "dpt", "--src", path, "--out",
                       str(tmp_path / "dpt.msgpack")])
        path = str(tmp_path / "dpt.msgpack")
    est = tdpt.DPTDepthEstimator(dtype=torch.float32, image_size=224,
                                 device="cpu", **tdpt.TINY_DPT)
    est.load_weights(path)
    images = _images()
    _close(est.depth_fn()(torch.from_numpy(images)), jax_maps(224))
