"""The AOT export (``depth_image_captioning_pub_torch/export.py``) on the
CPU, each case of ``tests/test_export.py`` on the port, and more:

* export -> load round trips whose captions equal the live pipeline's:
  greedy over buckets 2 and 4 (the files, ``meta``, one image padded to
  the small bucket), beam 2, sampling with one seed (the loader's
  generator advances per call as the pipeline's does), depth-soft with
  the DPT in the program, base-hard greedy and beam (the region noise as
  a program input, the generator re-seeded per chunk), NIC greedy;
* a program exported on one device and loaded on the CPU through
  ``move_to_device_pass``; serving over HTTP from the artifact; the
  refusals (a bf16 decoder; a soft beam width without a kernel instance
  on a CUDA device); the format-version guard;
* ``export.main`` then ``caption.main --export-dir`` == the live caption
  CLI, on a working directory with a base-soft experiment;
* the six kernels as operators: ``torch.library.opcheck`` of each
  (schema, fake rule, dispatch), and a soft artifact's graph calls
  ``dcap::greedy_decode`` once (K2 is one node, not an unrolled plain
  loop) where a sampled one calls ``dcap::decode_step`` once a step.

Tiny shapes: ResNet blocks 1,1,1,1 on 64x64 images, ``max_length`` 8
(the graphs unroll the sampling and hard loops). No JAX: the parity with
the JAX artifact is ``tests/test_torch_export_jax.py``.
"""

import io
import json
import os
import pickle
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from depth_image_captioning_pub_torch import caption as caption_cli
from depth_image_captioning_pub_torch import cli
from depth_image_captioning_pub_torch import export as export_mod
from depth_image_captioning_pub_torch.config import ConfigEval
from depth_image_captioning_pub_torch.export import (
    ExportedPipeline, export_pipeline)
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.models.decoder import AttentionDecoder
from depth_image_captioning_pub_torch.models.nic import NICDecoder
from depth_image_captioning_pub_torch.ops.kernels import decode_seq
from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
from depth_image_captioning_pub_torch.serve import serve
from depth_image_captioning_pub_torch.utils.checkpoint import save_component
from depth_image_captioning_pub_torch.utils.jax_bridge import params_to_jax
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

LAYERS = (1, 1, 1, 1)
HW = 64
MAX_LEN = 8


def _vocab():
    w2i = {f"w{i}": i for i in range(16)}
    w2i.update({"<start>": 16, "<end>": 17, "<unk>": 18, "<null>": 19})
    return w2i, {i: w for w, i in w2i.items()}


def _captioner(kind, seed=0):
    w2i, _ = _vocab()
    cap = build_captioner(kind, len(w2i), ConfigEval(), resnet_layers=LAYERS,
                          device="cpu")
    cap.init(torch.Generator().manual_seed(seed))
    return cap


def _pipeline(kind="base-soft", depth_fn=None, **kw):
    w2i, i2w = _vocab()
    kw.setdefault("max_length", MAX_LEN)
    return CaptionPipeline(_captioner(kind), w2i, i2w, depth_fn=depth_fn,
                           image_hw=(HW, HW), **kw)


def _imgs(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (n, HW, HW, 3), dtype=np.uint8)


def _round_trip(pipe, path, imgs, **load):
    """(live captions, loaded pipeline, its captions): the live call comes
    first, so both generators start from the seed."""
    want = pipe(list(imgs))
    export_pipeline(pipe, str(path))
    loaded = ExportedPipeline.load(str(path), **load)
    return want, loaded, loaded(list(imgs))


def test_export_roundtrip_greedy(tmp_path):
    pipe = _pipeline(batch_buckets=(2, 4))
    imgs = _imgs(3)
    want = pipe(list(imgs))
    out = tmp_path / "art"
    meta = export_pipeline(pipe, str(out))
    assert sorted(meta["buckets"]) == [2, 4]
    assert sorted(os.listdir(out)) == ["meta.json", "program_b2.pt2",
                                       "program_b4.pt2", "variables.msgpack"]
    on_disk = json.loads((out / "meta.json").read_text())
    assert on_disk == meta
    assert on_disk["kind"] == "base-soft" and on_disk["beam_size"] == 1
    assert on_disk["device"] == "cpu" and not on_disk["sample"]
    assert on_disk["torch_version"] == torch.__version__
    assert on_disk["id_to_word"]["17"] == "<end>"
    # the weights are written once, not in each program
    assert all(os.path.getsize(out / f"program_b{b}.pt2")
               < os.path.getsize(out / "variables.msgpack") / 10
               for b in (2, 4))

    loaded = ExportedPipeline.load(str(out))
    assert loaded.batch_buckets == (2, 4) and loaded.max_length == MAX_LEN
    assert loaded(list(imgs)) == want
    assert loaded(imgs[0]) == want[0]          # one image, padded to 2
    assert len(set(want)) > 1


def test_export_beam(tmp_path):
    want, loaded, got = _round_trip(
        _pipeline(batch_size=4, beam_size=2), tmp_path / "a", _imgs(3, 1))
    assert loaded.meta["beam_size"] == 2
    assert got == want


def test_export_sampling_same_seed(tmp_path):
    """The noise rides as a program input drawn from the loader's own
    generator in the live loop's order: the same captions as the live
    pipeline for the same seed, call after call."""
    pipe = _pipeline(batch_size=4, sample=True, temperature=1.5, seed=7)
    imgs = _imgs(3, 2)
    want, loaded, got = _round_trip(pipe, tmp_path / "a", imgs, seed=7)
    assert loaded.sample is True and got == want
    state = loaded.generator.get_state().clone()
    second = loaded(list(imgs))
    assert not torch.equal(loaded.generator.get_state(), state)
    assert second == pipe(list(imgs)) and second != got   # fresh draws


def test_export_depth(tmp_path):
    """depth-soft: the program holds the DPT -> depth CNN -> decode chain;
    the DPT's weights ride in the artifact's frozen tree."""
    depth_fn = cli.make_depth_fn(tiny=True, device="cpu", seed=1)
    want, loaded, got = _round_trip(
        _pipeline("depth-soft", depth_fn=depth_fn, batch_size=2),
        tmp_path / "a", _imgs(2, 3))
    assert any(k.startswith("dpt.") for k in loaded.frozen)
    assert loaded.batch_stats                   # the depth CNN's BN
    assert loaded.meta["dpt_image_size"] == 64
    assert (loaded.meta["dpt_gelu"], loaded.meta["dpt_head"]) == (
        "erf", "full")
    assert got == want


@pytest.mark.parametrize("beam", [1, 3])
def test_export_hard(beam, tmp_path):
    """base-hard: the region noise is a program input ([T, B, K], or [T,
    B*W, K] for beam search), re-drawn from the seed for every chunk, so
    every call captions alike, as the live pipeline's do."""
    pipe = _pipeline("base-hard", batch_buckets=(2,), beam_size=beam,
                     seed=5)
    imgs = _imgs(3, 4)
    want, loaded, got = _round_trip(pipe, tmp_path / "a", imgs, seed=5)
    assert got == want
    assert loaded(list(imgs)) == want
    shapes = export_mod.noise_spec(loaded.meta, 2)
    assert shapes == {"regions": (2, 196) if beam == 1 else (2, 3, 196)}


def test_export_nic(tmp_path):
    want, loaded, got = _round_trip(_pipeline("nic", batch_size=2),
                                    tmp_path / "a", _imgs(3, 5))
    assert loaded.meta["attention"] is None and got == want


def test_export_load_on_cpu(tmp_path):
    """A program exported on another device goes through
    ``move_to_device_pass`` when loaded on the CPU (here the artifact says
    "cuda": the pass rewrites its device-bound nodes)."""
    pipe = _pipeline(batch_size=2)
    imgs = _imgs(2, 4)
    want = pipe(list(imgs))
    export_pipeline(pipe, str(tmp_path / "a"))
    meta_path = tmp_path / "a" / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta["device"] = "cuda"
    meta_path.write_text(json.dumps(meta))
    loaded = ExportedPipeline.load(str(tmp_path / "a"), device="cpu")
    assert loaded.device == torch.device("cpu")
    assert loaded(list(imgs)) == want


def test_export_serve_http(tmp_path):
    """The caption server over an artifact: an HTTP round trip through
    ``ExportedPipeline`` captions as the loaded pipeline does."""
    pipe = _pipeline(batch_size=2)
    export_pipeline(pipe, str(tmp_path / "a"))
    loaded = ExportedPipeline.load(str(tmp_path / "a"))
    httpd = serve(loaded, host="127.0.0.1", port=0, batch_window_ms=50.0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        img = _imgs(1, 5)[0]
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/caption",
            data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())["caption"]
        assert got == loaded(img)
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.stop()


def test_export_refusals(tmp_path):
    w2i, i2w = _vocab()
    cap = build_captioner("base-soft", len(w2i), ConfigEval(),
                          resnet_layers=LAYERS, device="cpu",
                          decoder_dtype=torch.bfloat16)
    pipe = CaptionPipeline(cap, w2i, i2w, batch_size=2, image_hw=(HW, HW))
    with pytest.raises(ValueError, match="float32 decoder"):
        export_pipeline(pipe, str(tmp_path / "a"))
    assert not (tmp_path / "a").exists()
    # beam 9 has no instance of the beam kernel: a CPU artifact does not
    # load on a CUDA device
    export_pipeline(_pipeline(batch_size=2, beam_size=9),
                    str(tmp_path / "b"))
    with pytest.raises(ValueError, match="beam sizes"):
        ExportedPipeline.load(str(tmp_path / "b"), device="cuda")
    assert ExportedPipeline.load(str(tmp_path / "b")).meta["beam_size"] == 9


def test_export_format_version_guard(tmp_path):
    export_pipeline(_pipeline(batch_size=2), str(tmp_path / "a"))
    meta_path = tmp_path / "a" / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta["format_version"] = 99
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="newer"):
        ExportedPipeline.load(str(tmp_path / "a"))


def _write_experiment(root):
    """A working directory with a vocabulary and a base-soft checkpoint set
    1 in ``eval_tables``' layout, written by the port."""
    w2i, i2w = _vocab()
    base = root / "dataset" / "coco2014"
    base.mkdir(parents=True)
    with open(base / "word_to_id.pkl", "wb") as f:
        pickle.dump(w2i, f)
    with open(base / "id_to_word.pkl", "wb") as f:
        pickle.dump(i2w, f)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        cfg = ConfigEval()
    finally:
        os.chdir(cwd)
    save_dir, files = cli.eval_tables(cfg, "soft", False, False)
    trainable, frozen, _ = params_to_jax(_captioner("base-soft", seed=3))
    save_component(os.path.join(save_dir, files[1][0]), frozen["encoder"])
    save_component(os.path.join(save_dir, files[1][1]), trainable["decoder"])
    paths = []
    for i, img in enumerate(_imgs(3, 6)):
        paths.append(str(root / f"img{i}.png"))
        Image.fromarray(img).save(paths[-1])
    return paths


def test_export_cli_e2e(tmp_path, monkeypatch, capsys):
    """``export.main`` on an experiment, then ``caption.main --export-dir``:
    the captions of the live caption CLI."""
    paths = _write_experiment(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DCAP_RESNET_LAYERS", "1,1,1,1")
    art = tmp_path / "artifact"
    assert export_mod.main([str(art), "--kind", "base-soft",
                            "--batch-buckets", "1,2", "--device",
                            "cpu"]) == 0
    assert "exported base-soft" in capsys.readouterr().out
    assert json.loads((art / "meta.json").read_text())["buckets"] == [1, 2]
    assert caption_cli.main(paths + ["--device", "cpu"]) == 0
    live = [ln.split("\t")[1] for ln in
            capsys.readouterr().out.strip().splitlines()]
    assert caption_cli.main(paths + ["--export-dir", str(art), "--device",
                                     "cpu"]) == 0
    exported = [ln.split("\t")[1] for ln in
                capsys.readouterr().out.strip().splitlines()]
    assert len(exported) == 3 and exported == live


# ---- the operators ----------------------------------------------------------

def _op_cases():
    from depth_image_captioning_pub_torch.ops.kernels import library
    library.register_all()
    g = torch.Generator().manual_seed(0)
    dec = AttentionDecoder(23, dim_attention=8, dim_embedding=8,
                           dim_encoder=16, dim_decoder=12, device="cpu")
    dec.reset_parameters(g)
    dec.requires_grad_(False)
    feats, proj, h, c = dec._prepare(torch.randn(3, 196, 16, generator=g),
                                     None)
    w = dec.seq_weights()
    nic = NICDecoder(23, dim_embedding=8, dim_hidden=12, num_layers=2,
                     device="cpu")
    nic.reset_parameters(g)
    nic.requires_grad_(False)
    nw = nic.seq_weights()
    q = torch.randn(4, 10, 32, generator=g)
    x = torch.randn(2, 3, 5, 64, generator=g)
    return {
        "decode_step": (feats, proj, w.embed[torch.tensor([1, 2, 3])], h, c,
                        list(w.step)),
        "greedy_decode": (feats, proj, h, c, decode_seq.seq_list(w), 6, 1,
                          2),
        "nic_greedy_decode": (torch.randn(3, 8, generator=g),
                              [*nw.layer_mats, nw.w_out, nw.b_out, nw.embed],
                              6),
        "beam_decode": (feats, proj, h, c, decode_seq.seq_list(w), 3, 6, 1,
                        2),
        "vit_attention": (q, q.flip(1).contiguous(), q * 0.5, 0.125, 8),
        "group_norm_nhwc": (x, 1 + 0.1 * torch.randn(64, generator=g),
                            0.1 * torch.randn(64, generator=g),
                            x.flip(1).contiguous(), 32, 1e-5, True),
    }


@pytest.mark.parametrize("name", ["decode_step", "greedy_decode",
                                  "nic_greedy_decode", "beam_decode",
                                  "vit_attention", "group_norm_nhwc"])
def test_operator_opcheck(name):
    args = _op_cases()[name]
    result = torch.library.opcheck(getattr(torch.ops.dcap, name).default,
                                   args)
    assert set(result.values()) == {"SUCCESS"}, result


def _dcap_calls(path):
    graph = torch.export.load(str(path)).graph
    targets = [str(n.target) for n in graph.nodes
               if n.op == "call_function"]
    return [t for t in targets if t.startswith("dcap.")], len(targets)


def test_soft_artifacts_call_the_operators(tmp_path):
    export_pipeline(_pipeline(batch_size=2), str(tmp_path / "greedy"))
    ops, nodes = _dcap_calls(tmp_path / "greedy" / "program_b2.pt2")
    assert ops == ["dcap.greedy_decode.default"]
    # the encoder and the decoder's set-up; an unrolled greedy loop of
    # plain ops would add ~20 nodes a step
    assert nodes < 200
    export_pipeline(_pipeline(batch_size=2, sample=True),
                    str(tmp_path / "sample"))
    ops, _ = _dcap_calls(tmp_path / "sample" / "program_b2.pt2")
    assert ops == ["dcap.decode_step.default"] * MAX_LEN


def test_wrappers_dispatch_through_the_operators():
    """On CPU tensors each public wrapper calls its operator, whose CPU
    implementation is the plain version (no kernel launch)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from depth_image_captioning_pub_torch.ops.kernels import (
        beam_seq, decode_step, group_norm, nic_seq, vit_attention)
    from depth_image_captioning_pub_torch.ops.kernels.nic_seq import (
        NICSeqWeights)

    seen = []

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    cases = _op_cases()
    feats, proj, emb, h, c, step = cases["decode_step"]
    w = decode_seq.seq_weights(cases["greedy_decode"][4])
    x0, nws, _ = cases["nic_greedy_decode"]
    q, k, v, scale, n_valid = cases["vit_attention"]
    x, gw, gb, r, groups, eps, _ = cases["group_norm_nhwc"]
    calls = {
        "decode_step": lambda: decode_step.fused_decode_core(
            feats, proj, emb, h, c, w.step),
        "greedy_decode": lambda: decode_seq.fused_greedy_decode(
            feats, proj, h, c, w, max_length=6, start_id=1, end_id=2),
        "nic_greedy_decode": lambda: nic_seq.fused_nic_greedy_decode(
            x0, NICSeqWeights(tuple(nws[:-3]), *nws[-3:]), max_length=6),
        "beam_decode": lambda: beam_seq.fused_beam_decode(
            feats, proj, h, c, w, beam_size=3, max_length=6, start_id=1,
            end_id=2),
        "vit_attention": lambda: vit_attention.fused_attention(
            q, k, v, scale=scale, n_valid=n_valid),
        "group_norm_nhwc": lambda: group_norm.group_norm_nhwc(
            x, gw, gb, groups=groups, eps=eps, relu=True, residual=r),
    }
    mods = (decode_step, decode_seq, nic_seq, beam_seq, vit_attention,
            group_norm)
    launches = [m.LAUNCHES for m in mods]
    for name, call in calls.items():
        seen.clear()
        with Mode():
            out = call()
        assert seen[0] == f"dcap.{name}.default", (name, seen[:3])
        want = getattr(torch.ops.dcap, name)(*cases[name])
        for a, b in zip(out if isinstance(out, tuple) else [out],
                        want if isinstance(want, tuple) else [want]):
            assert torch.equal(a, b)
    assert [m.LAUNCHES for m in mods] == launches
