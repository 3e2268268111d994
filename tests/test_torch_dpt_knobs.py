"""The DPT's knobs in the port == in the JAX package, on the CPU.

The JAX package sets its knobs as module globals (``models/dpt.
GELU_APPROXIMATE``, ``HEAD_LOW_RES``), which ``cli.make_depth_fn`` sets
from ``cfg.dpt_gelu`` and ``cfg.dpt_head``; the port takes them as
constructor arguments (``gelu=``, ``head=``), and ``cli.make_depth_fn`` /
``eval_depth_fn`` read the same ``cfg`` fields, and ``dpt_image_size``.
On the tests' tiny DPT in f32, on bridged variables:

* each knob (tanh GELU, the low-resolution head, a 224x224 input with the
  position embeddings resized 24 -> 14, and all three) gives the JAX
  package's depth maps within the tiny DPT twin's atol 1e-4
  (``tests/test_torch_dpt.py``), and each changes the maps;
* the CLI layer: ``make_depth_fn(cfg=...)`` against the JAX
  ``make_depth_fn(cfg)``, the JAX messages for a bad GELU or head, and the
  flags of ``evaluation``, ``cli caption``, ``serve`` and ``caption``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from depth_image_captioning_pub_tpu import cli as jcli
from depth_image_captioning_pub_tpu.config import ConfigEval as JConfigEval
from depth_image_captioning_pub_tpu.models import dpt as jdpt
from depth_image_captioning_pub_torch import caption, cli, evaluation, serve
from depth_image_captioning_pub_torch.config import ConfigEval
from depth_image_captioning_pub_torch.models import dpt as tdpt
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    dpt_params_from_jax)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

TINY = tdpt.TINY_DPT
ATOL = 1e-4          # the tiny DPT twin's (tests/test_torch_dpt.py)
KNOBS = {"erf_full": ("erf", "full", 64), "tanh": ("tanh", "full", 64),
         "lowres": ("erf", "lowres", 64), "size224": ("erf", "full", 224),
         "all": ("tanh", "lowres", 224)}


def _close(got, want, atol=ATOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=atol * max(1.0, np.abs(want).max()),
                               rtol=0)


@pytest.fixture(scope="module")
def variables():
    """The tiny DPT's flax variables with random norm scales and biases
    (as the twin test perturbs them), so every tensor is exercised."""
    model = jdpt.DPTDepthModel(**TINY)
    params = jax.tree_util.tree_map(np.asarray, dict(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))))["params"]
    rng = np.random.default_rng(1)

    def perturb(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = perturb(v)
            elif k == "scale":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("bias", "cls_token"):
                out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v, np.float32)
        return out
    return {"params": perturb(params)}


def _jax_maps(monkeypatch, variables, gelu, head, size, images):
    monkeypatch.setattr(jdpt, "GELU_APPROXIMATE", gelu == "tanh")
    monkeypatch.setattr(jdpt, "HEAD_LOW_RES", head == "lowres")
    est = jdpt.DPTDepthEstimator(dtype=jnp.float32, image_size=size)
    est.model = jdpt.DPTDepthModel(**TINY)
    return np.asarray(est.depth_fn()(variables, jnp.asarray(images)))


def _port_maps(variables, gelu, head, size, images):
    est = tdpt.DPTDepthEstimator(dtype=torch.float32, image_size=size,
                                 device="cpu", gelu=gelu, head=head, **TINY)
    dpt_params_from_jax(est, variables)
    return est.depth_fn()(torch.from_numpy(images))


IMAGES = np.random.default_rng(2).integers(0, 256, (2, 48, 56, 3),
                                           dtype=np.uint8)


@pytest.mark.parametrize("case", sorted(KNOBS))
def test_knob_equals_jax(case, variables, monkeypatch):
    gelu, head, size = KNOBS[case]
    want = _jax_maps(monkeypatch, variables, gelu, head, size, IMAGES)
    got = _port_maps(variables, gelu, head, size, IMAGES)
    assert tuple(got.shape) == want.shape == (2, 224, 224, 1)
    _close(got, want)
    if case != "erf_full":
        # the knob moves the maps by more than ten times the two packages'
        # difference
        err = np.abs(got.numpy() - want).max()
        default = _port_maps(variables, "erf", "full", 64, IMAGES)
        assert (got - default).abs().max().item() > 10 * err


def test_knobs_change_the_model_not_its_weights(variables):
    """The knobs reorder or swap operations: the parameter set is the one
    the bridge fills; 224 gives the ViT 197 tokens."""
    names = set(tdpt.DPTDepthModel(**TINY).state_dict())
    for gelu, head, size in KNOBS.values():
        model = tdpt.DPTDepthModel(gelu=gelu, head=head, **TINY)
        assert set(model.state_dict()) == names
    seen = []
    plain = tdpt.vit_attention.fused_attention

    def spy(q, k, v, **kw):
        seen.append(q.shape[1])
        return plain(q, k, v, **kw)

    tdpt.vit_attention.fused_attention, saved = spy, plain
    try:
        _port_maps(variables, "erf", "full", 224, IMAGES[:1])
    finally:
        tdpt.vit_attention.fused_attention = saved
    assert seen == [197] * TINY["vit_blocks"]


@pytest.mark.parametrize("bad", [("gelu", "bogus"), ("head", "sideways")])
def test_bad_knob_raises_jax_message(bad, monkeypatch):
    field, value = bad
    jcfg, cfg = JConfigEval(), ConfigEval()
    setattr(jcfg, f"dpt_{field}", value)
    setattr(cfg, f"dpt_{field}", value)
    monkeypatch.setenv("DCAP_TINY_DPT", "1")
    with pytest.raises(ValueError) as want:
        jcli.make_depth_fn(jcfg)
    with pytest.raises(ValueError) as got:
        cli.make_depth_fn(cfg=cfg, tiny=True, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=f"dpt_{field} must be"):
        cli.eval_depth_fn(cfg, device="cpu")
    with pytest.raises(ValueError, match=f"dpt_{field} must be"):
        tdpt.DPTDepthModel(**{field: value}, **TINY)


@pytest.mark.parametrize("gelu,head", [("tanh", "full"), ("erf", "lowres"),
                                       ("tanh", "lowres")])
def test_make_depth_fn_reads_cfg_as_jax(gelu, head, variables, monkeypatch):
    """cfg.dpt_gelu / dpt_head through both packages' make_depth_fn (the
    tests' DPT via $DCAP_TINY_DPT in JAX, ``tiny=True`` here, on one set
    of variables): the same maps, and other maps than the defaults."""
    monkeypatch.setenv("DCAP_TINY_DPT", "1")
    monkeypatch.setattr(jdpt, "GELU_APPROXIMATE", False)
    monkeypatch.setattr(jdpt, "HEAD_LOW_RES", False)
    jcfg, cfg = JConfigEval(), ConfigEval()
    jcfg.dpt_gelu, jcfg.dpt_head = gelu, head
    cfg.dpt_gelu, cfg.dpt_head = gelu, head
    jfn, _ = jcli.make_depth_fn(jcfg, dtype=jnp.float32)
    want = np.asarray(jfn(variables, jnp.asarray(IMAGES)))

    built = []

    class F32Estimator(tdpt.DPTDepthEstimator):
        def __init__(self, **kw):
            built.append(kw)
            super().__init__(dtype=torch.float32, **kw)

    monkeypatch.setattr(tdpt, "DPTDepthEstimator", F32Estimator)
    fn = cli.make_depth_fn(variables, cfg=cfg, tiny=True, device="cpu")
    got = fn(torch.from_numpy(IMAGES))
    _close(got, want)
    assert built[0]["gelu"] == gelu and built[0]["head"] == head
    assert built[0]["image_size"] == 64          # tiny overrides the size
    default = cli.make_depth_fn(variables, tiny=True, device="cpu")(
        torch.from_numpy(IMAGES))
    err = np.abs(got.numpy() - want).max()
    assert (got - default).abs().max().item() > 10 * err


def test_eval_depth_fn_reads_every_dpt_field(monkeypatch):
    """eval_depth_fn hands cfg's size, GELU and head to the estimator."""
    built = []

    class Recorder:
        def __init__(self, **kw):
            built.append(kw)

        def init(self, generator):
            pass

        def depth_fn(self):
            return "fn"

    monkeypatch.setattr(tdpt, "DPTDepthEstimator", Recorder)
    monkeypatch.delenv("DCAP_TINY_DPT", raising=False)
    monkeypatch.delenv("DPT_WEIGHTS", raising=False)
    cfg = ConfigEval()
    cfg.dpt_image_size, cfg.dpt_gelu, cfg.dpt_head = 224, "tanh", "lowres"
    assert cli.eval_depth_fn(cfg, device="cpu") == "fn"
    assert built == [dict(device="cpu", image_size=224, gelu="tanh",
                          head="lowres")]


def _captured_cfg(monkeypatch, module, argv):
    seen = {}

    def fake_from_experiment(kind, use_data, **kw):
        seen.update(kw)
        raise SystemExit(0)

    monkeypatch.setattr(
        "depth_image_captioning_pub_torch.pipeline.CaptionPipeline."
        "from_experiment", staticmethod(fake_from_experiment))
    with pytest.raises(SystemExit):
        module.main(argv)
    return seen["cfg"]


@pytest.mark.parametrize("module", ["serve", "caption"])
def test_serving_flags_reach_cfg(module, monkeypatch, tmp_path):
    mod = {"serve": serve, "caption": caption}[module]
    img = tmp_path / "x.png"
    img.write_bytes(b"x")
    head = [str(img)] if module == "caption" else []
    cfg = _captured_cfg(monkeypatch, mod, head + [
        "--kind", "depth-soft", "--dpt-size", "224", "--gelu", "tanh",
        "--dpt-head", "lowres"])
    assert (cfg.dpt_image_size, cfg.dpt_gelu, cfg.dpt_head) == (
        224, "tanh", "lowres")
    cfg = _captured_cfg(monkeypatch, mod, head + ["--kind", "depth-soft"])
    assert (cfg.dpt_image_size, cfg.dpt_gelu, cfg.dpt_head) == (
        384, "erf", "full")


def test_evaluation_flags_reach_cfg(monkeypatch):
    seen = {}
    monkeypatch.setattr(evaluation, "score_mode",
                        lambda atten, use_data, cfg, *a: seen.update(
                            cfg=cfg) or 0)
    assert evaluation.main(["depth", "soft", "score", "coco", "--dpt-size",
                            "224", "--gelu", "tanh", "--dpt-head",
                            "lowres"]) == 0
    cfg = seen["cfg"]
    assert (cfg.dpt_image_size, cfg.dpt_gelu, cfg.dpt_head) == (
        224, "tanh", "lowres")
    assert evaluation.main(["depth", "soft", "score", "coco"]) == 0
    assert (seen["cfg"].dpt_image_size, seen["cfg"].dpt_gelu,
            seen["cfg"].dpt_head) == (384, "erf", "full")
    with pytest.raises(SystemExit):
        evaluation.main(["depth", "soft", "score", "coco", "--gelu", "x"])


def test_cli_caption_flags_reach_the_dpt(monkeypatch):
    """``cli caption --kind depth-soft --tiny-dpt --gelu tanh --dpt-head
    lowres`` builds its DPT with the knobs."""
    built = []
    real = tdpt.DPTDepthEstimator

    class Recorder(real):
        def __init__(self, **kw):
            built.append(kw)
            super().__init__(**kw)

    monkeypatch.setattr(tdpt, "DPTDepthEstimator", Recorder)
    lines = cli.caption(cli_args(["--random", "1", "--kind", "depth-soft",
                                  "--tiny-dpt", "--gelu", "tanh",
                                  "--dpt-head", "lowres"]))
    assert len(lines) == 1
    assert built[0]["gelu"] == "tanh" and built[0]["head"] == "lowres"


def cli_args(extra):
    import argparse
    seen = {}

    def grab(args):
        seen["args"] = args
        return []

    real = cli.caption
    cli.caption = grab
    try:
        cli.main(["caption", "--device", "cpu", "--resnet-layers",
                  "1,1,1,1", "--image-size", "64", "--vocab-size", "20",
                  "--max-length", "4", *extra])
    finally:
        cli.caption = real
    assert isinstance(seen["args"], argparse.Namespace)
    return seen["args"]
