#!/usr/bin/env python3
"""A/B timing of the NIC greedy kernel (K3) on one CUDA card: the kernel,
its variants and other copies of the source (an earlier commit's
one-CTA-per-row kernel, say), in turns in one process.

    python3 tools/nic_seq_ab.py [--source NAME=OTHER.cu ...] \\
        [--units 1 2] [--batches 1 16 64] [--out FILE.json]

The parent's file, for ``--source parent=build/parent/nic_seq.cu``, comes
from git (the card's copy of the repository has no ``.git``):

    mkdir -p build/parent
    git show HEAD~1:depth_image_captioning_pub_torch/csrc/nic_seq.cu \\
        > build/parent/nic_seq.cu

"kernel" is ``csrc/nic_seq.cu`` as it is: G_0 resolves its rows' tokens
from the CTAs' candidates. "r_phase" is a copy with the first design's
phase R, a phase of its own with a grid barrier after it, from which G_0
reads the tokens (``R_PHASE``). ``--units U`` adds each of them planned
with U hidden units per CTA at every B (the planner's ``unit_choices``
replaced). A ``--source`` copy without ``dcap_nic_max_ctas`` is taken as
the parent's kernel (the C entry of one CTA per row); any other copy must
have this kernel's C entry. Each source is built by nvcc (all at the same time,
``decode_phases.cuh`` written into the copy) under ``build/nic_seq_ab/``,
checked against the plain PyTorch version (token agreement >= 0.99) and
timed with CUDA events at full width (E=300, H=128, 2 layers, V=9956, 30
steps) at each B, in turns (A B C ... C B A, twice); the least of the four
timings is shown, and whether each kernel's tokens equal the first's.

The kernel and the r_phase copy are also built as traced copies, into which
the tool writes SM-clock stamps (``clock64``) as each CTA starts, when its
weights are loaded, and as it arrives at and leaves each grid barrier. One
run of each (and of its ``--units`` plans) at each B gives each phase's
critical path per step (the slowest CTA's work between two barriers: each
G_l, H, and r_phase's R; the last R ends the kernel and is not counted),
the load, and the barriers' own latency (the least wait).
Prints ptxas' lines, the tables and the card's ``nvidia-smi`` name and
power limit; ``--out`` also writes them as JSON.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
CSRC = REPO / "depth_image_captioning_pub_torch" / "csrc"
SRC = CSRC / "nic_seq.cu"
OUT_DIR = REPO / "build" / "nic_seq_ab"
E, H, LAYERS, V = 300, 128, 2, 9956
MAX_LEN = 30
ITERS = 10          # launches per timing
_P, _I = ctypes.c_void_p, ctypes.c_int
NEW_ARGS = [_P] * 19 + [_I] * 11 + [_P]
OLD_ARGS = [_P] * 17 + [_I] * 6 + [_P]

# The r_phase copy: phase R with a grid barrier of its own before G_0 (the
# first design), G_0 reading the tokens from the records. (old, new)
# replacements in csrc/nic_seq.cu, each old text found once.
R_PHASE = (
    ("    for (int l = 0; l < q.layers; ++l) {\n      // layer l's h",
     "    if (t > 0) {\n      resolve_rows(q, x, t - 1);\n"
     "      grid_sync(q);\n    }\n"
     "    for (int l = 0; l < q.layers; ++l) {\n      // layer l's h"),
    ("tokens ? s_tok[(gi - base) * kGR + min(k, rows - 1)] : row[k];",
     "tokens ? __ldcg(q.tokens + (size_t)row[k] * q.max_length + t - 1)\n"
     "                     : row[k];"),
)
R_BLOCK = ("    if (tokens) {\n", "    if (active) {\n")  # dropped by r_phase

# The traced copy: (anchor, text put before it); each anchor occurs once.
TRACE_INSERTS = (
    ("// Grid-wide barrier on a counter",
     "// SM-clock stamps: [2 + 2 x barriers, ctas] int64\n"
     "__device__ long long* dcap_trace;\n"
     "__shared__ int t_slot;  // barriers passed\n\n"),
    ("    volatile int* gen = bar + 1;",
     "    dcap_trace[(2 + 2L * t_slot) * q.ctas + blockIdx.x] = clock64();\n"),
    ("  }\n  __syncthreads();\n}\n\n// 16 bytes of features",
     "    dcap_trace[(3 + 2L * t_slot) * q.ctas + blockIdx.x] = clock64();\n"
     "    ++t_slot;\n"),
    ("  load_nic_slices(q, s);\n",
     "  if (threadIdx.x == 0) {\n"
     "    dcap_trace[blockIdx.x] = clock64();\n"
     "    t_slot = 0;\n  }\n"),
    ("  const HOut out{nullptr",
     "  if (threadIdx.x == 0) dcap_trace[q.ctas + blockIdx.x] = clock64();\n"),
)
TRACE_SETTER = """
extern "C" int dcap_trace_set(void* p) {
  return static_cast<int>(
      cudaMemcpyToSymbol(dcap::seq::dcap_trace, &p, sizeof(p)));
}
"""


def _replace_once(text, old, new, what):
    if text.count(old) != 1:
        raise ValueError(f"{what} {old[:60]!r} occurs {text.count(old)} "
                         f"times in {SRC} with decode_phases.cuh")
    return text.replace(old, new)


def inline_phases(text):
    """The source with decode_phases.cuh written in place of its include,
    so that one file holds every anchor."""
    header = (CSRC / "decode_phases.cuh").read_text()
    return text.replace('#include "decode_phases.cuh"\n',
                        header.replace("#pragma once\n", ""), 1)


def r_phase_source(text):
    for old, new in R_PHASE:
        text = _replace_once(text, old, new, "R_PHASE text")
    lo, hi = text.index(R_BLOCK[0]), text.index(R_BLOCK[1])
    return text[:lo] + text[hi:]


def traced_source(text):
    text = inline_phases(text)
    for anchor, insert in TRACE_INSERTS:
        text = _replace_once(text, anchor, insert + anchor, "trace anchor")
    return text + TRACE_SETTER


def build_all(sources):
    """nvcc every (name, text) at once; {name: (library, ptxas lines)}."""
    from depth_image_captioning_pub_torch.ops.kernels import _build
    nvcc = _build.nvcc_path()
    procs = {}
    for name, text in sources:
        d = OUT_DIR / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "nic_seq.cu").write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(CSRC), "-shared",
               "-o", str(d / "lib.so"), str(d / "nic_seq.cu")]
        procs[name] = (d / "lib.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines, keep = [], False
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                keep = "nic" in ln
            if keep and ("registers" in ln or "spill" in ln):
                lines.append(ln.split(":")[-1].strip())
        built[name] = (lib, lines)
    return built


class Kernel:
    """One library's NIC entry, called like ``fused_nic_greedy_decode``;
    ``units`` fixes the hidden units per CTA."""

    def __init__(self, lib_path, units=None):
        self.lib = ctypes.CDLL(str(lib_path))
        self.new = hasattr(self.lib, "dcap_nic_max_ctas")
        fn = self.lib.dcap_nic_greedy_decode
        fn.argtypes = NEW_ARGS if self.new else OLD_ARGS
        fn.restype = ctypes.c_int
        self.fn, self.units = fn, units
        self.plans = {}

    def plan(self, bsz):
        import torch
        from depth_image_captioning_pub_torch.ops.kernels import nic_seq
        if bsz not in self.plans:
            ctas = torch.cuda.get_device_properties(0).multi_processor_count
            units = nic_seq.unit_choices
            if self.units:
                def units(*_):
                    return (self.units,)
            with mock.patch.object(nic_seq, "unit_choices", units):
                self.plans[bsz] = nic_seq.plan_nic.__wrapped__(
                    bsz, E, H, LAYERS, V, ctas)
        return self.plans[bsz]

    def __call__(self, x0, w):
        import torch
        bsz, dev = x0.shape[0], x0.device
        ptrs = [t.data_ptr() for t in (x0, *w.layer_mats)]
        ptrs += [None] * (3 * (4 - LAYERS))
        ptrs += [t.data_ptr() for t in (w.w_out, w.b_out, w.embed)]
        tokens = torch.empty((bsz, MAX_LEN), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        if not self.new:
            err = self.fn(*ptrs, tokens.data_ptr(), bsz, LAYERS, E, H, V,
                          MAX_LEN, stream)
        else:
            p = self.plan(bsz)
            fscr = torch.empty(p.scratch_floats, dtype=torch.float32,
                               device=dev)
            iscr = torch.empty(p.scratch_ints, dtype=torch.int32, device=dev)
            err = self.fn(*ptrs, tokens.data_ptr(), fscr.data_ptr(),
                          iscr.data_ptr(), bsz, LAYERS, E, H, V, MAX_LEN,
                          p.ctas, p.h_cols, p.units, p.h_rows, p.smem_bytes,
                          stream)
        if err:
            raise RuntimeError(f"dcap_nic_greedy_decode: CUDA error {err}")
        return tokens


def make_case(bsz, seed=8):
    import torch
    from depth_image_captioning_pub_torch.models.nic import NICDecoder
    dev = torch.device("cuda")
    dec = NICDecoder(V, dim_embedding=E, dim_hidden=H, num_layers=LAYERS,
                     device=dev)
    dec.reset_parameters(torch.Generator().manual_seed(seed))
    x0 = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (bsz, E)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        return x0, dec.seq_weights()


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


def phase_labels(r_phase):
    """The phase that ends at each grid barrier, in order."""
    labels = []
    for t in range(MAX_LEN):
        if r_phase and t > 0:
            labels.append("R")
        labels += [f"G{l}" for l in range(LAYERS)] + ["H"]
    return labels


def phase_breakdown(kern, case, r_phase, mhz):
    """Each phase's critical path per step, the load and the barriers'
    latency, in µs, from one traced run of the traced kernel ``kern``."""
    import torch
    x0, w = case
    ctas = kern.plan(x0.shape[0]).ctas
    labels = phase_labels(r_phase)
    buf = torch.zeros((2 + 2 * len(labels)) * ctas, dtype=torch.int64,
                      device="cuda")
    set_trace = kern.lib.dcap_trace_set
    set_trace.argtypes = [_P]
    if set_trace(buf.data_ptr()):
        raise RuntimeError("dcap_trace_set failed")
    kern(x0, w)
    torch.cuda.synchronize()
    tr = buf.cpu().numpy().reshape(2 + 2 * len(labels), ctas)
    start, loaded, arrive, leave = tr[0], tr[1], tr[2::2], tr[3::2]
    spans = dict.fromkeys(labels, 0.0)
    wait = 0.0
    for b, kind in enumerate(labels):
        before = loaded if b == 0 else leave[b - 1]
        spans[kind] += (arrive[b] - before).max() / mhz
        wait += (leave[b] - arrive[b]).min() / mhz
    per_step = {k: v / labels.count(k) for k, v in spans.items()}
    return {"barriers": len(labels), "per_step_us": per_step,
            "load_us": (loaded - start).max() / mhz,
            "barriers_us": wait, "barrier_us_each": wait / len(labels)}


def main():
    import torch
    from depth_image_captioning_pub_torch.ops.kernels.nic_seq import (
        fused_nic_greedy_decode_plain)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH", help="another nic_seq.cu")
    ap.add_argument("--units", nargs="*", type=int, default=[],
                    choices=(1, 2))
    ap.add_argument("--batches", nargs="*", type=int, default=[1, 16, 64])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("nic_seq_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    text = SRC.read_text()
    variants = {"kernel": text, "r_phase": r_phase_source(text)}
    sources = [(name, inline_phases(t)) for name, t in variants.items()]
    sources += [(f"trace_{name}", traced_source(t))
                for name, t in variants.items()]
    for spec in args.source:
        name, path = spec.split("=", 1)
        sources.append((name, inline_phases(Path(path).read_text())))
    built = build_all(sources)
    for name, (_, lines) in built.items():
        for line in lines:
            print(f"[ptxas] {name}: {line}", flush=True)
    kernels = {name: Kernel(lib) for name, (lib, _) in built.items()
               if not name.startswith("trace_")}
    traced = {name: Kernel(built[f"trace_{name}"][0]) for name in variants}
    for name in variants:
        for u in args.units:
            traced[f"{name}_units{u}"] = Kernel(built[f"trace_{name}"][0],
                                                units=u)
    for name in variants:
        for u in args.units:
            kernels[f"{name}_units{u}"] = Kernel(built[name][0], units=u)

    results, breakdown = {}, {}
    ok = True
    for bsz in args.batches:
        key = f"B={bsz}"
        case = make_case(bsz)
        with torch.inference_mode():
            want = fused_nic_greedy_decode_plain(*case, max_length=MAX_LEN)
            outs = {}
            for name, kern in kernels.items():
                outs[name] = kern(*case)
                torch.cuda.synchronize()
            times = {name: [] for name in kernels}
            order = list(kernels) + list(kernels)[::-1]
            for name in order + order:
                times[name].append(cuda_ms(
                    lambda k=kernels[name]: k(*case), ITERS))
            mhz = float(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True).stdout.split()[0])
            breakdown[key] = {
                name: phase_breakdown(kern, case, name.startswith("r_phase"),
                                      mhz)
                for name, kern in traced.items()}
            breakdown[key]["sm_mhz"] = mhz
        for name in kernels:
            agree = (outs[name] == want).float().mean().item()
            good = agree >= 0.99
            ok = ok and good
            same = torch.equal(outs[name], outs["kernel"])
            plan = kernels[name].plans.get(bsz) if kernels[name].new else None
            results.setdefault(name, {})[key] = {
                "ms": min(times[name]), "ms_all": times[name],
                "token_agreement": agree, "same_tokens_as_kernel": same,
                "ok": good, "plan": None if plan is None else {
                    "ctas": plan.ctas, "units": plan.units,
                    "h_rows": plan.h_rows, "h_cols": plan.h_cols,
                    "smem_bytes": plan.smem_bytes}}
            print(f"[ab] {key} {name}: {min(times[name]):.4f} ms (runs "
                  f"{', '.join(f'{t:.4f}' for t in times[name])}); token "
                  f"agreement {agree:.4f} {'ok' if good else 'WRONG'}; "
                  f"tokens {'=' if same else '!='} kernel's"
                  + (f"; plan {plan.ctas} CTAs, {plan.units} unit(s), "
                     f"h tile {plan.h_rows}, {plan.smem_bytes} B"
                     if plan else "") + f" [{smi}]", flush=True)
        for name in traced:
            b = breakdown[key][name]
            print(f"[trace] {key} {name} (SM clock {mhz:.0f} MHz), µs per "
                  f"step: " + "; ".join(
                      f"{k} {v:.2f}" for k, v in b["per_step_us"].items())
                  + f"; load {b['load_us']:.1f} µs once; {b['barriers']} "
                  f"barriers {b['barriers_us']:.1f} µs "
                  f"({b['barrier_us_each']:.2f} each) [{smi}]", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({
            "card": smi, "results": results, "trace": breakdown,
            "ptxas": {n: l for n, (_, l) in built.items()}}, indent=1))
    if not ok:
        raise SystemExit("nic_seq_ab: a kernel disagrees with the plain "
                         "version")


if __name__ == "__main__":
    main()
