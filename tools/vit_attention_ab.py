#!/usr/bin/env python3
"""A/B timing of the ViT attention kernel's bf16 route (K5) on one CUDA
card: tile shapes of ``csrc/vit_attention.cu`` against each other, and
against other copies of the source (an earlier commit's, a variant).

    python3 tools/vit_attention_ab.py [--source NAME=OTHER.cu ...] \\
        [--variants 4,1,64,2 4,2,32,2 ...] [--out FILE.json]

A variant ``W,B,K,S`` is ``csrc/vit_attention.cu`` with the bf16 route's
``kWarps = W``, ``kBlocks = B`` (blocks of 16 query rows per warp),
``kKeys = K`` and ``kStages = S``.
Each variant, and each ``--source``, is built by nvcc (all at the same
time) into a shared library of its own under ``build/vit_attention_ab/``
and called
through its C entry point ``dcap_vit_attention``. Every library is checked
against the plain PyTorch version (one bf16 ulp of max|v|) and timed with
CUDA events at the DPT's shape (Z = 64 images x 12 heads, N = 577, d = 64)
and at d = 32 and 128, in turns (A B C ... C B A, twice). Prints ptxas'
register and spill lines and a table of times; ``--out`` also writes them
as JSON.
"""

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
SRC = REPO / "depth_image_captioning_pub_torch" / "csrc" / "vit_attention.cu"
OUT_DIR = REPO / "build" / "vit_attention_ab"
SHAPES = ((768, 577, 64), (96, 577, 32), (96, 577, 128))   # Z, N, d
CONSTS = ("kWarps", "kBlocks", "kKeys", "kStages")
ITERS = 20          # launches per timing


def variant_source(text, values):
    """The source with the bf16 route's tile constants set to values."""
    for name, value in zip(CONSTS, values):
        text, count = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
        if count != 1:
            raise ValueError(f"{name} is defined {count} times in {SRC}")
    return text


def build_all(sources):
    """nvcc every (name, source text) at once; {name: (library, ptxas)}."""
    from depth_image_captioning_pub_torch.ops.kernels import _build
    nvcc = _build.nvcc_path()
    procs = {}
    for name, text in sources:
        d = OUT_DIR / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "vit_attention.cu").write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "vit_attention.cu")]
        procs[name] = (d / "lib.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (lib, [ln.strip() for ln in log.splitlines()
                             if "attention_bf16_kernel" in ln
                             or "registers" in ln or "spill" in ln])
    return built


def load(lib_path):
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.dcap_vit_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def cuda_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main():
    import torch
    from depth_image_captioning_pub_torch.ops.kernels.vit_attention import (
        fused_attention_plain)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH", help="another vit_attention.cu")
    ap.add_argument("--variants", nargs="*",
                    default=["4,1,64,2", "8,1,64,2", "4,1,32,2", "4,1,64,3",
                             "4,2,32,2", "4,2,64,2"])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("vit_attention_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    text = SRC.read_text()
    sources = [(f"w{w}_b{b}_k{k}_s{s}", variant_source(text, (w, b, k, s)))
               for w, b, k, s in (v.split(",") for v in args.variants)]
    for spec in args.source:
        name, path = spec.split("=", 1)
        sources.append((name, Path(path).read_text()))
    built = build_all(sources)
    fns = {name: load(lib) for name, (lib, _) in built.items()}
    for name, (_, lines) in built.items():
        for line in lines:
            print(f"[ptxas] {name}: {line}", flush=True)

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(6)
    results = {}
    for z, n, d in SHAPES:
        q, k, v = (torch.from_numpy(rng.standard_normal((z, n, d)).astype(
            np.float32)).to(dev, torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        want = fused_attention_plain(q, k, v, scale=scale, n_valid=n).float()
        tol = 2.0 ** (math.floor(math.log2(v.abs().max().item())) - 7)
        out = torch.empty_like(v)

        def call(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), 1, z, n, d, n, scale, stream)
            if err:
                raise RuntimeError(f"dcap_vit_attention: CUDA error {err}")

        shape = f"Z={z} N={n} d={d}"
        errs = {}
        for name, fn in fns.items():
            out.zero_()
            call(fn)
            torch.cuda.synchronize()
            diff = (out.float() - want).abs()
            errs[name] = (diff.max().item(), diff.mean().item())
        times = {name: [] for name in fns}
        order = list(fns) + list(fns)[::-1]
        for name in order + order:
            times[name].append(cuda_ms(lambda fn=fns[name]: call(fn), ITERS))
        for name in fns:
            ok = errs[name][0] <= tol
            results.setdefault(name, {})[shape] = {
                "ms": min(times[name]), "ms_all": times[name],
                "max_abs_err": errs[name][0], "mean_abs_err": errs[name][1],
                "tol": tol, "ok": ok}
            print(f"[ab] {shape} bf16 {name}: {min(times[name]):.4f} ms "
                  f"(runs {', '.join(f'{t:.4f}' for t in times[name])}); "
                  f"max abs err {errs[name][0]:.3e} (tol {tol:.3e}), mean "
                  f"{errs[name][1]:.3e} "
                  f"{'ok' if ok else 'WRONG'} [{smi}]", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "results": results,
                                        "ptxas": {n: l for n, (_, l) in
                                                  built.items()}}, indent=1))
    if not all(r["ok"] for per in results.values() for r in per.values()):
        raise SystemExit("vit_attention_ab: a variant disagrees with the "
                         "plain version")


if __name__ == "__main__":
    main()
