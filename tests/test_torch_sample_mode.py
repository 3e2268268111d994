"""Sample mode: ``python -m depth_image_captioning_pub_torch.evaluation
{base|depth} {soft|hard} sample <pic> {coco|original}`` == the JAX
``sample_mode`` (``base_evaluation.py`` / ``depth_evaluation.py``), on the
CPU, over checkpoint sets the JAX ``save_component`` wrote
(``tests/test_torch_evaluate.py``'s ``experiments``; ResNet blocks
1,1,1,1 and f32 encoders in both packages; the tests' tiny f32 DPT on one
set of variables) and one ``sample_pic`` set of two images (a JPEG and a
PNG of other sizes):

* base-soft and depth-soft greedy through both CLIs: the same
  ``caption.txt`` bytes, the same words per image and each word's
  attention weights within 2e-5 (both packages' overlay writers are
  replaced by recorders);
* base-hard greedy (JAX's fixed ``PRNGKey(0)`` region draws) and base-soft
  ``--stochastic`` (JAX's ``fold_in(PRNGKey(seed), i)`` token draws),
  replayed through ``sample_mode``'s ``att_noise`` / ``noise`` hooks: the
  same captions;
* the port's own draws: a rerun with one seed repeats its captions, and
  the file layout of the base, depth, ``--mlp``, hard and ``--stochastic``
  forms is the JAX module's (``<sample_dir>/<prefix>_<atten>/<stem>/
  NN_<word>.png``, ``input.png``, ``caption.txt``);
* ``AttentionDecoder.greedy_alphas``: the tokens of ``greedy_sample``
  (soft, K1 per step; hard, on one noise hook) and softmax or one-hot
  alpha rows.
"""

import os
import shutil

import numpy as np
import pytest
import jax
import torch
from PIL import Image

import base_evaluation
import depth_evaluation
from depth_image_captioning_pub_tpu.engine import visualize as jvis
from depth_image_captioning_pub_torch import cli, evaluation
from depth_image_captioning_pub_torch.config import ConfigEval
from depth_image_captioning_pub_torch.engine import visualize as tvis
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.ops.kernels import decode_step
from depth_image_captioning_pub_torch.utils.checkpoint import (
    load_component, save_component)
from depth_image_captioning_pub_torch.utils.jax_bridge import params_to_jax

from test_torch_evaluate import (  # noqa: F401 (module-scoped fixtures)
    _scale_kernels, coco_dir, experiments, f32_builders, tiny_dpt)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

ALPHA_ATOL = 2e-5
PIC = "dog"


@pytest.fixture(scope="module")
def sample_cwd(coco_dir, experiments):
    """The evaluation working directory with ``sample_pic/dog`` (two
    images) and, beside the JAX-written base-soft and depth-soft sets,
    base-hard and depth-hard sets (the soft sets' files under the hard
    tables' names) and an mdepth-soft set the port wrote."""
    root, img_dir = coco_dir[0], coco_dir[1]
    pics = root / "sample_pic" / PIC
    pics.mkdir(parents=True)
    first = sorted(os.listdir(img_dir))[0]
    shutil.copy(os.path.join(img_dir, first), pics / "dog.jpg")
    rng = np.random.default_rng(5)
    Image.fromarray(rng.integers(0, 256, (150, 100, 3), np.uint8)).save(
        pics / "other.png")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        cfg = ConfigEval()
    finally:
        os.chdir(cwd)
    end = coco_dir[3]["<end>"]
    for depth in (False, True):
        src, soft = cli.eval_tables(cfg, "soft", False, depth)
        _retune(src, soft[1], end, None if depth else 2.0 / 3.0)
        dst, hard = cli.eval_tables(cfg, "hard", False, depth)
        for a, b in zip(soft[1], hard[1]):
            save_component(os.path.join(dst, b),
                           load_component(os.path.join(src, a)))
    cap = build_captioner("mdepth-soft", len(coco_dir[3]), cfg,
                          resnet_layers=(1, 1, 1, 1), device="cpu")
    cap.init(torch.Generator().manual_seed(3))
    trainable, frozen, _ = params_to_jax(cap)
    save_dir, files = cli.eval_tables(cfg, "soft", False, True,
                                      encoder="mlp")
    for name, tree in zip(files[1], (
            frozen["encoder"], trainable["decoder"],
            {"params": trainable["depth_encoder"], "batch_stats": {}})):
        save_component(os.path.join(save_dir, name), tree)
    return root


def _retune(save_dir, names, end, encoder_factor):
    """Set 1 of ``tests/test_torch_evaluate.py``'s ``experiments``, tuned
    for 224x224 images (its sets are tuned for 64x64): base-soft's encoder
    kernels x2 a layer in place of x3 (features near 1e3 at most, not
    2e5, whose f32 rounding moved alphas by 3e-4 in both packages alike),
    the decoder's feature paths x3 and base-soft's <end> bias back to
    its init, so that the two images get long captions of their own."""
    if encoder_factor is not None:
        enc = load_component(os.path.join(save_dir, names[0]))
        save_component(os.path.join(save_dir, names[0]),
                       _scale_kernels(enc, encoder_factor))
    dec = {k: np.array(v) for k, v in load_component(
        os.path.join(save_dir, names[1])).items()}
    for key in ("init_w", "att_w_enc", "f_beta_w"):
        dec[key] *= 3.0
    if encoder_factor is not None:
        dec["out_b"][end] -= 1.0
    save_component(os.path.join(save_dir, names[1]), dec)


class Recorder:
    """Stands in for a package's ``render_attention_overlays``: keeps
    (image stem, words, alphas) of each call and writes nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, image_01, words, alphas, out_dir, grid=14):
        self.calls.append((os.path.basename(out_dir), list(words),
                           np.asarray(alphas, np.float64)))
        return []


@pytest.fixture
def recorders(monkeypatch):
    jrec, trec = Recorder(), Recorder()
    monkeypatch.setattr(jvis, "render_attention_overlays", jrec)
    monkeypatch.setattr(tvis, "render_attention_overlays", trec)
    return jrec, trec


@pytest.fixture
def tiny_depth(monkeypatch, tiny_dpt):
    """Both CLIs' DPT is the tests' tiny f32 DPT on one set of variables
    (bf16 DPTs round differently in the two frameworks)."""
    monkeypatch.setattr(depth_evaluation, "make_depth_fn",
                        lambda cfg: (tiny_dpt[0], tiny_dpt[1]))
    monkeypatch.setattr(cli, "eval_depth_fn",
                        lambda cfg, device="cuda": tiny_dpt[2])


def _out_dir(root, prefix):
    return root / "sample_pic" / PIC / prefix


def _caption_txt(root, prefix):
    return (_out_dir(root, prefix) / "caption.txt").read_bytes()


@pytest.mark.parametrize("base", ["base", "depth"])
def test_greedy_sample_mode_equals_jax(base, sample_cwd, f32_builders,
                                       tiny_depth, recorders, monkeypatch,
                                       capsys):
    jrec, trec = recorders
    monkeypatch.chdir(sample_cwd)
    jmain = base_evaluation.main if base == "base" else depth_evaluation.main
    assert jmain(["soft", "sample", PIC, "coco"]) == 0
    want = _caption_txt(sample_cwd, f"{base}_soft")
    launches = decode_step.LAUNCHES
    assert evaluation.main([base, "soft", "sample", PIC, "coco",
                            "--device", "cpu"]) == 0
    assert decode_step.LAUNCHES == launches      # the CPU: plain versions
    assert _caption_txt(sample_cwd, f"{base}_soft") == want
    assert len(trec.calls) == len(jrec.calls) == 2
    for (stem, words, alphas), (jstem, jwords, jalphas) in zip(
            trec.calls, jrec.calls):
        assert (stem, words) == (jstem, jwords)
        assert alphas.shape == (len(words), 196)
        np.testing.assert_allclose(alphas, jalphas, atol=ALPHA_ATOL, rtol=0)
    assert len({tuple(w) for _, w, _ in trec.calls}) == 2  # images differ
    out = capsys.readouterr().out
    assert "dog.jpg: " in out and "other.png: " in out


def _replay_hard(seed_unused):
    """JAX greedy's region draws: ``fold_in(PRNGKey(0), t)`` for every
    image."""
    key = jax.random.PRNGKey(0)
    return lambda i: (lambda t, shape: torch.from_numpy(np.array(
        jax.random.gumbel(jax.random.fold_in(key, t), tuple(shape)))))


def _replay_tokens(seed, vocab):
    """JAX stochastic sample mode's token draws: image i's key is
    ``fold_in(PRNGKey(seed), i)``, step t's ``split(fold_in(key, t))[1]``."""
    base = jax.random.PRNGKey(seed)

    def image(i):
        key = jax.random.fold_in(base, i)
        return lambda t: torch.from_numpy(np.array(jax.random.gumbel(
            jax.random.split(jax.random.fold_in(key, t))[1], (1, vocab))))
    return image


@pytest.mark.parametrize("case", ["base-hard", "base-soft-stochastic"])
def test_replayed_draws_equal_jax(case, sample_cwd, coco_dir, f32_builders,
                                  recorders, monkeypatch):
    jrec, trec = recorders
    monkeypatch.chdir(sample_cwd)
    atten = "hard" if case == "base-hard" else "soft"
    sampling = (None if case == "base-hard"
                else {"temperature": 1.3, "top_k": 0, "top_p": 0.9})
    assert base_evaluation.sample_mode(
        atten, PIC, "coco", base_evaluation.ConfigEval(), sampling=sampling,
        seed=4) == 0
    want = _caption_txt(sample_cwd, f"base_{atten}")
    hooks = ({"att_noise": _replay_hard(4)} if case == "base-hard"
             else {"noise": _replay_tokens(4, len(coco_dir[3]))})
    assert evaluation.sample_mode(atten, PIC, "coco", ConfigEval(), False,
                                  "cnn", "cpu", sampling=sampling, seed=4,
                                  **hooks) == 0
    assert _caption_txt(sample_cwd, f"base_{atten}") == want
    assert len(trec.calls) == 2                  # both images have words
    assert [c[:2] for c in trec.calls] == [c[:2] for c in jrec.calls]


@pytest.mark.parametrize("argv, prefix", [
    (["base", "soft"], "base_soft"),
    (["base", "hard", "--seed", "2"], "base_hard"),
    (["depth", "soft", "--stochastic", "--top-k", "5"], "depth_soft"),
    (["depth", "hard"], "depth_hard"),
    (["depth", "soft", "--mlp"], "mdepth_soft"),
])
def test_port_layout_and_repeats(argv, prefix, sample_cwd, f32_builders,
                                 tiny_depth, monkeypatch, capsys):
    """The port's own draws: the JAX module's layout, one overlay per word,
    readable PNGs, one caption line per image, and the same captions on a
    rerun."""
    monkeypatch.chdir(sample_cwd)
    words, flags = argv[:2], argv[2:]
    run = words + ["sample", PIC, "coco", "--device", "cpu"] + flags
    out_dir = _out_dir(sample_cwd, prefix)
    shutil.rmtree(out_dir, ignore_errors=True)
    assert evaluation.main(run) == 0
    first = (out_dir / "caption.txt").read_text()
    lines = first.splitlines()
    assert [ln.split(": ")[0] for ln in lines] == ["dog.jpg", "other.png"]
    assert all(ln.split(": ", 1)[1] for ln in lines)     # words to draw
    for line in lines:
        stem = os.path.splitext(line.split(": ")[0])[0]
        caption = line.split(": ", 1)[1].split()
        names = sorted(os.listdir(out_dir / stem))
        assert names == sorted(["input.png"] + [
            f"{t:02d}_{w}.png" for t, w in enumerate(caption)])
        for name in names:
            with Image.open(out_dir / stem / name) as im:
                im.load()
    assert evaluation.main(run) == 0
    assert (out_dir / "caption.txt").read_text() == first
    capsys.readouterr()


def _decoder(attention, seed=0):
    from depth_image_captioning_pub_torch.models.decoder import (
        AttentionDecoder)
    dec = AttentionDecoder(29, dim_attention=8, dim_embedding=8,
                           dim_encoder=16, dim_decoder=12, device="cpu",
                           attention_kind=attention)
    dec.reset_parameters(torch.Generator().manual_seed(seed))
    return dec


@pytest.mark.parametrize("attention", ["soft", "hard"])
def test_greedy_alphas_tokens_equal_greedy_sample(attention):
    dec = _decoder(attention)
    feats = torch.randn(3, 196, 16, generator=torch.Generator().manual_seed(1))
    noise = [torch.randn(3, 196, generator=torch.Generator().manual_seed(t))
             for t in range(12)]
    hook = {"att_noise": lambda t, shape: noise[t]} if attention == "hard" \
        else {}
    tokens, alphas = dec.greedy_alphas(feats, 0, max_length=12, **hook)
    want = dec.greedy_sample(feats, 0, max_length=12, **hook)
    assert torch.equal(tokens, want) and tokens.dtype == torch.int32
    assert alphas.shape == (3, 12, 196) and alphas.dtype == torch.float32
    torch.testing.assert_close(alphas.sum(-1), torch.ones(3, 12))
    if attention == "hard":
        assert bool(((alphas == 0) | (alphas == 1)).all())
    else:
        sampled = dec.stochastic_sample(feats, 0, None, max_length=12,
                                        top_k=1,
                                        noise=lambda t: torch.zeros(3, 29))
        assert torch.equal(sampled[0], tokens)
        torch.testing.assert_close(sampled[1], alphas, rtol=0, atol=0)
