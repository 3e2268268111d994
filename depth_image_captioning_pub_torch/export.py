"""Ahead-of-time export of the caption program (the port's counterpart of
the JAX ``export.py``): ``torch.export`` traces a pipeline's whole caption
step once per batch bucket, and ``ExportedPipeline`` captions from the
artifact without the model code. The artifact is a directory:

    meta.json           buckets, image size, vocab (id -> word), the decode
                        settings, the DPT knobs, versions
    variables.msgpack   {"frozen", "params", "batch_stats"}: the weights,
                        flat maps of the program's parameter names
    program_b{B}.pt2    one ``torch.export`` program per batch bucket

A program is the pipeline's caption function (uint8 images -> /255 ->
frozen encoder, for a depth kind the DPT and the depth encoder -> greedy,
beam or sampled decode -> token IDs) with the weights as inputs:
``program(frozen, params, batch_stats, images [B, H, W, 3] uint8, noise)``,
the JAX export's ``(frozen, params, stats, images, rng)``. ``noise``
replaces the JAX ``rng``: {"tokens": [T, B, V]} for sampling and
{"regions": [T, B, K]} ([T, B*W, K] for beam search) for hard attention,
standard Gumbel draws, {} otherwise. ``ExportedPipeline`` draws them from
its own ``torch.Generator`` in the order the live loop draws them (step
by step, the region before the token), so a sampled or hard artifact
captions as the live pipeline does for the same seed; like the live
pipeline it re-seeds the generator before each chunk of a hard greedy or
beam program.

The kernels stay in the programs. K1-K5 are the operators
``dcap::decode_step``, ``dcap::greedy_decode``, ``dcap::nic_greedy_decode``,
``dcap::beam_decode`` and ``dcap::vit_attention``
(``ops/kernels/library.py``), each a single node of the graph with a CPU
implementation (the plain version) and a CUDA one (the hand kernel): one
artifact runs the kernels on the card and the plain versions on the CPU,
and ``load(device=...)`` moves a program exported on one to the other.
Loading needs PyTorch and this package's operators, not the model code.
A program runs under ``ops/precision.full_f32`` (TF32 off): a graph
records no global flags, so it runs under the loader's, and the live
pipeline's f32 work pins TF32 off.

Refused: a bf16 decoder (no decode path takes one), and on a CUDA device
a soft-attention beam width the beam kernel has no instance for.

CLI:

    python -m depth_image_captioning_pub_torch.export out_dir \\
        --kind base-soft --batch-buckets 1,4,16 [--beam W] [--sample ...] \\
        [--gelu tanh] [--device cuda|cpu]
    python -m depth_image_captioning_pub_torch.caption img.png \\
        --export-dir out_dir
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn as nn

from depth_image_captioning_pub_torch.pipeline import CaptionPipeline

META_NAME = "meta.json"
VARS_NAME = "variables.msgpack"
FORMAT_VERSION = 1

Tensors = Dict[str, torch.Tensor]


def _program_name(bucket: int) -> str:
    return f"program_b{int(bucket)}.pt2"


class CaptionProgram(nn.Module):
    """A pipeline's caption function as a module: the captioner (and the
    DPT of a depth kind) as submodules, so that ``functional_call`` can
    swap their weights for the program's inputs."""

    def __init__(self, pipe: CaptionPipeline):
        super().__init__()
        self.cap = pipe.cap
        self.dpt = getattr(pipe.depth_fn, "model", None)
        object.__setattr__(self, "_fn", pipe._fn)   # not a submodule

    def forward(self, images: torch.Tensor, noise: Tensors) -> torch.Tensor:
        tokens, regions = noise.get("tokens"), noise.get("regions")
        return self._fn(
            images,
            att_noise=None if regions is None
            else (lambda t, shape: regions[t].reshape(shape)),
            noise=None if tokens is None else (lambda t: tokens[t]))


class _Program(nn.Module):
    """(frozen, params, batch_stats, images, noise) -> tokens: the
    ``CaptionProgram`` on the weights it is given (held outside the module
    tree, so the export keeps no weights of its own)."""

    def __init__(self, program: CaptionProgram):
        super().__init__()
        object.__setattr__(self, "_program", program)

    def forward(self, frozen: Tensors, params: Tensors, stats: Tensors,
                images: torch.Tensor, noise: Tensors) -> torch.Tensor:
        return torch.func.functional_call(
            self._program, {**frozen, **params, **stats}, (images, noise))


def split_variables(program: CaptionProgram) -> Dict[str, Tensors]:
    """The program's weights as {"frozen", "params", "batch_stats"}: the
    RGB encoder and the DPT are frozen; the decoder, NIC's projection and
    the depth encoder's parameters are the trained ones; the depth
    encoder's buffers are its batch statistics."""
    out: Dict[str, Tensors] = {"frozen": {}, "params": {},
                               "batch_stats": {}}
    trained = ("cap.decoder.", "cap.projection.", "cap.depth_module.")
    for name, t in program.named_parameters():
        out["params" if name.startswith(trained) else "frozen"][name] = (
            t.detach())
    for name, t in program.named_buffers():
        out["batch_stats" if name.startswith("cap.depth_module.")
            else "frozen"][name] = t
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    from depth_image_captioning_pub_torch.utils.msgpack_codec import (
        BFloat16Bits)
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(BFloat16Bits)
    return t.numpy()


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    from depth_image_captioning_pub_torch.utils.msgpack_codec import (
        BFloat16Bits, bf16_tensor)
    if isinstance(arr, BFloat16Bits):
        return bf16_tensor(arr).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def noise_spec(meta: Dict, bucket: int) -> Dict[str, tuple]:
    """The shapes of a program's noise inputs at ``bucket`` rows: the draws
    of one step, {"tokens": (B, V)} for sampling and {"regions": (B, K)}
    ((B, W, K) for beam search) for hard attention."""
    spec = {}
    if meta["attention"] == "hard":
        beam = meta["beam_size"]
        spec["regions"] = ((bucket, meta["regions"]) if beam == 1
                           else (bucket, beam, meta["regions"]))
    if meta["sample"]:
        spec["tokens"] = (bucket, meta["vocab_size"])
    return spec


def draw_noise(meta: Dict, bucket: int, generator: torch.Generator
               ) -> Tensors:
    """A program's noise, drawn from ``generator`` in the live loop's order:
    for each of the ``max_length`` steps the region noise, then the token
    noise (``ops/decode.gumbel_noise``, one call per step and kind, as the
    decoders call it). Beam search's [T, B, W, K] regions are passed as
    [T, B*W, K]."""
    from depth_image_captioning_pub_torch.ops.decode import gumbel_noise
    spec = noise_spec(meta, bucket)
    draws: Dict[str, list] = {name: [] for name in spec}
    for _ in range(meta["max_length"]):
        for name in ("regions", "tokens"):
            if name in spec:
                draws[name].append(gumbel_noise(spec[name], generator))
    out = {name: torch.stack(d) for name, d in draws.items()}
    if "regions" in out and out["regions"].dim() == 4:
        t, b, w, k = out["regions"].shape
        out["regions"] = out["regions"].reshape(t, b * w, k)
    return out


def check_exportable(pipe: CaptionPipeline) -> None:
    """The refusals: a pipeline over several devices (the JAX export's:
    serving over several devices splits its chunks around the loaded
    program), and the port's own: a bf16 decoder and, on a CUDA device, a
    soft-attention beam width with no kernel instance (the live pipeline
    refuses the latter too)."""
    from depth_image_captioning_pub_torch.ops.kernels.beam_seq import (
        check_beam_size)
    if len(pipe.devices) > 1:
        raise ValueError(
            "export a single-device pipeline (pass devices=[one device]); "
            "serve-side data parallelism splits the chunks around the "
            "loaded program")
    if pipe.cap.decoder.dtype != torch.float32:
        raise ValueError(f"a {pipe.cap.decoder.dtype} decoder cannot "
                         f"decode: export a float32 decoder on the same "
                         f"parameters")
    if pipe.beam_size > 1 and pipe.cap.spec.attention == "soft":
        check_beam_size(pipe.beam_size, pipe.device)


def export_pipeline(pipe: CaptionPipeline, out_dir: str) -> Dict:
    """Export ``pipe``'s caption program (one per batch bucket), weights and
    vocabulary to ``out_dir``, on the pipeline's device. Returns the meta
    dict written. Raises for what ``check_exportable`` refuses."""
    from depth_image_captioning_pub_torch.ops.precision import full_f32
    from depth_image_captioning_pub_torch.utils.msgpack_codec import packb

    check_exportable(pipe)
    os.makedirs(out_dir, exist_ok=True)
    program = CaptionProgram(pipe)
    variables = split_variables(program)
    spec = pipe.cap.spec
    h, w = pipe.image_hw
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": spec.kind,
        "buckets": [int(b) for b in pipe.batch_buckets],
        "programs": {},
        "image_hw": [int(h), int(w)],
        "max_length": pipe.max_length,
        "beam_size": pipe.beam_size,
        "length_penalty": pipe.length_penalty,
        "sample": pipe.sample,
        "sampling": pipe.sampling,
        "attention": spec.attention,
        "regions": (None if spec.is_nic
                    else pipe.cap.encoder.enc_img_size ** 2),
        "vocab_size": pipe.cap.decoder.vocab_size,
        "device": pipe.device.type,
        "torch_version": torch.__version__,
        "id_to_word": {str(i): wd for i, wd in pipe.id_to_word.items()},
    }
    if program.dpt is not None:
        meta.update(dpt_image_size=int(pipe.depth_fn.image_size),
                    dpt_gelu=program.dpt.gelu, dpt_head=program.dpt.head)
    exporter = _Program(program)
    for bucket in pipe.batch_buckets:
        images = torch.zeros((bucket, h, w, 3), dtype=torch.uint8,
                             device=pipe.device)
        noise = draw_noise(meta, bucket, torch.Generator(pipe.device))
        with torch.no_grad(), full_f32():
            exported = torch.export.export(
                exporter, (variables["frozen"], variables["params"],
                           variables["batch_stats"], images, noise))
        exported.example_inputs = None     # the weights: variables.msgpack
        torch.export.save(exported,
                          os.path.join(out_dir, _program_name(bucket)))
        meta["programs"][str(bucket)] = _program_name(bucket)
    with open(os.path.join(out_dir, VARS_NAME), "wb") as f:
        f.write(packb({group: {k: _numpy(t) for k, t in tree.items()}
                       for group, tree in variables.items()}))
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f)
    return meta


class ExportedPipeline(CaptionPipeline):
    """A ``CaptionPipeline`` whose device program comes from an export
    instead of the model code. It inherits the host side (decode and
    resize of paths and arrays, bucket padding, the chunks' pipelining,
    detokenization); ``_fn`` draws the chunk's noise and runs the
    program of its bucket."""

    def __init__(self, calls: Dict[int, Callable], variables: Dict[str,
                 Tensors], meta: Dict, device, seed: int = 0):
        self._calls = dict(calls)
        self.frozen = variables["frozen"]
        self.params = variables["params"]
        self.batch_stats = variables["batch_stats"]
        self.meta = meta
        self.device = torch.device(device)
        self.devices = [self.device]
        self._experiment = None
        self.id_to_word = {int(i): w for i, w in meta["id_to_word"].items()}
        self.image_hw = tuple(meta["image_hw"])
        self.batch_buckets = tuple(sorted(int(b) for b in meta["buckets"]))
        self.batch_size = self.batch_buckets[-1]
        self.max_length = int(meta["max_length"])
        self.beam_size = int(meta["beam_size"])
        self.sample = bool(meta["sample"])
        self.seed = int(seed)
        hard = meta["attention"] == "hard"
        self._reseed = hard and not self.sample
        self.generator = None
        if self.sample or hard:
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(self.seed)

    def _fn(self, images: torch.Tensor) -> torch.Tensor:
        from depth_image_captioning_pub_torch.ops.precision import full_f32
        bucket = int(images.shape[0])
        noise = (draw_noise(self.meta, bucket, self.generator)
                 if self.generator is not None else {})
        with torch.no_grad(), full_f32():
            return self._calls[bucket](self.frozen, self.params,
                                       self.batch_stats, images, noise)

    @classmethod
    def load(cls, export_dir: str, device=None, seed: int = 0
             ) -> "ExportedPipeline":
        """The artifact in ``export_dir`` on ``device`` (default: the one
        it was exported on); a program exported on another device is moved
        (``torch.export.passes.move_to_device_pass``). A newer
        ``format_version`` raises, as does a soft-attention beam width
        without a kernel instance on a CUDA device."""
        from torch.export.passes import move_to_device_pass
        from depth_image_captioning_pub_torch.ops.kernels import library
        from depth_image_captioning_pub_torch.ops.kernels.beam_seq import (
            check_beam_size)
        from depth_image_captioning_pub_torch.utils.msgpack_codec import (
            unpackb)

        with open(os.path.join(export_dir, META_NAME)) as f:
            meta = json.load(f)
        if meta.get("format_version", 0) > FORMAT_VERSION:
            raise ValueError(
                f"artifact format {meta['format_version']} is newer than "
                f"this loader ({FORMAT_VERSION})")
        device = torch.device(device or meta["device"])
        if meta["beam_size"] > 1 and meta["attention"] == "soft":
            check_beam_size(meta["beam_size"], device)
        library.register_all()
        with open(os.path.join(export_dir, VARS_NAME), "rb") as f:
            tree = unpackb(f.read())
        variables = {group: {k: _tensor(a, device) for k, a in leaves.items()}
                     for group, leaves in tree.items()}
        calls = {}
        for bucket, name in meta["programs"].items():
            exported = torch.export.load(os.path.join(export_dir, name))
            if device.type != meta["device"]:
                exported = move_to_device_pass(exported, device)
            module = exported.module()
            # _fn builds every input at its bucket's shapes: the module's
            # own check of them, a walk over the ~800 weight tensors each
            # call (~20 ms of host time for ResNet-152), is left out
            module.validate_inputs = False
            calls[int(bucket)] = module
        return cls(calls, variables, meta, device, seed=seed)


def build_parser() -> argparse.ArgumentParser:
    from depth_image_captioning_pub_torch import cli
    p = argparse.ArgumentParser(
        prog="python -m depth_image_captioning_pub_torch.export",
        description="Export a trained experiment's caption program to an "
                    "AOT artifact (torch.export programs + weights + "
                    "vocab).")
    p.add_argument("out_dir", help="artifact directory to write")
    p.add_argument("--kind", default="base-soft",
                   help="model configuration (nic, base-soft, base-hard, "
                        "depth-soft, depth-hard, mdepth-soft, mdepth-hard)")
    p.add_argument("--use-data", default="coco", choices=("coco", "original"))
    p.add_argument("--set-idx", type=int, default=1)
    p.add_argument("--beam", type=int, default=1,
                   help="beam width baked into the program (1 = greedy)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--batch-buckets", default=None,
                   help="comma list, e.g. 1,4,16: one program per bucket")
    p.add_argument("--sample", action="store_true",
                   help="export the stochastic-decoding program")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: where the program is "
                        "traced and its weights live")
    cli.add_dpt_flags(p)
    return p


def main(argv=None) -> int:
    from depth_image_captioning_pub_torch import cli
    args = build_parser().parse_args(argv)
    buckets = (tuple(int(b) for b in args.batch_buckets.split(","))
               if args.batch_buckets else None)
    pipe = CaptionPipeline.from_experiment(
        args.kind, args.use_data, cfg=cli.dpt_cfg(args), set_idx=args.set_idx,
        device=args.device, beam_size=args.beam, batch_size=args.batch_size,
        batch_buckets=buckets, sample=args.sample,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p)
    meta = export_pipeline(pipe, args.out_dir)
    total = sum(os.path.getsize(os.path.join(args.out_dir, f))
                for f in os.listdir(args.out_dir))
    print(f"exported {args.kind} (buckets {meta['buckets']}, device "
          f"{meta['device']}) to {args.out_dir} ({total / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
