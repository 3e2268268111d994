#!/usr/bin/env python3
"""A/B timing of the decode-step kernel (K1) on one CUDA card: the kernel
against other copies of its source (an earlier commit's one-CTA-per-row
kernel, say), in turns in one process, with a per-phase trace.

    python3 tools/decode_step_ab.py [--source NAME=DIR ...] \\
        [--units 1 2] [--batches 1 16 64] [--out FILE.json]

Each ``--source`` directory holds a ``decode_step.cu`` and the headers it
includes. The parent commit's, from git (the card's copy of the
repository has no ``.git``):

    mkdir -p build/parent
    git archive HEAD~1 depth_image_captioning_pub_torch/csrc \\
        | tar -x -C build/parent
    # then --source parent=build/parent/depth_image_captioning_pub_torch/csrc

A copy without ``dcap_step_max_ctas`` is taken as the one-CTA-per-row
kernel (its C entry has no plan or scratch arguments); any other copy must
have this kernel's C entry. "kernel" is ``csrc/decode_step.cu`` as it is,
with ``decode_phases.cuh`` written in; ``--units U`` adds it planned with U
hidden units per CTA at every B (the planner's ``STEP_TWO_UNITS_FROM``
moved past or below B). Every library is built by nvcc (all
at the same time) under ``build/decode_step_ab/``, checked against the
plain PyTorch version (h', c' and alpha within 1e-4) and timed with CUDA
events at full width (K=196, D=2048 bf16 features, A=E=H=128) at each B,
in turns (A B ... B A, twice), each timing ``ITERS`` launches queued behind
a spin kernel, so that the card runs them back to back whatever the
host's rate (the launches' own time, each with its barrier memset); the
least of the four timings is shown, with the largest difference from the
kernel's outputs.

The kernel is also built as a traced copy, into which the tool writes
SM-clock stamps (``clock64``) as each CTA starts, when its weight slices
are loaded, as it arrives at and leaves each grid barrier, and at its end.
One run at each B (and with each ``--units``) gives each phase's critical
path (the slowest CTA's span between two stamps of its own: the load, H,
A, G), the two barriers' own latency (the least wait) and the slowest
CTA's whole span (SM clocks are not synchronised across SMs, so spans are
per CTA). Prints
ptxas' lines, the tables and the card's ``nvidia-smi`` name and power
limit; ``--out`` also writes them as JSON.
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
SRC = CSRC / "decode_step.cu"
OUT_DIR = REPO / "build" / "decode_step_ab"
K, D, A, E, H = 196, 2048, 128, 128, 128
ATOL = 1e-4
ITERS = 50          # launches per timing
SPIN_CYCLES = 20_000_000   # the spin kernel before them: ~10 ms
_P, _I = ctypes.c_void_p, ctypes.c_int
NEW_ARGS = [_P, _I] + [_P] * 19 + [_I] * 12 + [_P]
OLD_ARGS = [_P, _I] + [_P] * 17 + [_I] * 6 + [_P]

# The traced copy: (anchor, text put before it); each anchor occurs once.
# Stamps [7, ctas]: start, loaded, arrive/leave barrier 0, arrive/leave
# barrier 1, end.
TRACE_INSERTS = (
    ("// Grid-wide barrier on a counter",
     "__device__ long long* dcap_trace;\n"
     "__shared__ int t_slot;  // barriers passed\n\n"),
    ("    volatile int* gen = bar + 1;",
     "    dcap_trace[(2 + 2L * t_slot) * q.ctas + blockIdx.x] = clock64();\n"),
    ("  }\n  __syncthreads();\n}\n\n// 16 bytes of features",
     "    dcap_trace[(3 + 2L * t_slot) * q.ctas + blockIdx.x] = clock64();\n"
     "    ++t_slot;\n"),
    ("  load_slices(q, s);\n",
     "  if (threadIdx.x == 0) {\n"
     "    dcap_trace[blockIdx.x] = clock64();\n"
     "    t_slot = 0;\n  }\n"),
    ("  const HOut out{",
     "  if (threadIdx.x == 0) dcap_trace[q.ctas + blockIdx.x] = clock64();\n"),
    ("}\n\n// The grid must be co-resident",
     "  if (threadIdx.x == 0) dcap_trace[6L * q.ctas + blockIdx.x] = "
     "clock64();\n"),
)
TRACE_SETTER = """
extern "C" int dcap_trace_set(void* p) {
  return static_cast<int>(
      cudaMemcpyToSymbol(dcap::seq::dcap_trace, &p, sizeof(p)));
}
"""


def inline_phases(text):
    """The source with decode_phases.cuh written in place of its include,
    so that one file holds every anchor."""
    header = (CSRC / "decode_phases.cuh").read_text()
    return text.replace('#include "decode_phases.cuh"\n',
                        header.replace("#pragma once\n", ""), 1)


def traced_source(text):
    text = inline_phases(text)
    for anchor, insert in TRACE_INSERTS:
        if text.count(anchor) != 1:
            raise ValueError(f"trace anchor {anchor[:60]!r} occurs "
                             f"{text.count(anchor)} times in {SRC} with "
                             f"decode_phases.cuh")
        text = text.replace(anchor, insert + anchor)
    return text + TRACE_SETTER


def build_all(sources):
    """nvcc every (name, text, include dir) at once; {name: (library,
    ptxas lines)}."""
    from depth_image_captioning_pub_torch.ops.kernels import _build
    nvcc = _build.nvcc_path()
    procs = {}
    for name, text, include in sources:
        d = OUT_DIR / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "decode_step.cu").write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(include), "-shared",
               "-o", str(d / "lib.so"), str(d / "decode_step.cu")]
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
                keep = "step" in ln and "bfloat16" in ln
            if keep and ("registers" in ln or "spill" in ln):
                lines.append(ln.split(":")[-1].strip())
        built[name] = (lib, lines)
    return built


class Kernel:
    """One library's step entry, called like ``fused_decode_core`` on bf16
    features."""

    def __init__(self, lib_path, units=None):
        self.lib = ctypes.CDLL(str(lib_path))
        self.new = hasattr(self.lib, "dcap_step_max_ctas")
        fn = self.lib.dcap_decode_step
        fn.argtypes = NEW_ARGS if self.new else OLD_ARGS
        fn.restype = ctypes.c_int
        self.fn = fn
        self.units = units
        self.plans = {}
        self.buffers = {}

    def plan(self, bsz):
        import torch
        from depth_image_captioning_pub_torch.ops.kernels import decode_step
        if bsz not in self.plans:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            two_from = {None: decode_step.STEP_TWO_UNITS_FROM, 1: bsz + 1,
                        2: 0}[self.units]
            with mock.patch.object(decode_step, "STEP_TWO_UNITS_FROM",
                                   two_from):
                p = decode_step.plan_step.__wrapped__(bsz, K, D, A, E, H,
                                                      sms)
                fits = self.lib.dcap_step_max_ctas(1, p.smem_bytes)
                if fits < p.ctas:
                    p = decode_step.plan_step.__wrapped__(bsz, K, D, A, E, H,
                                                          fits)
            self.plans[bsz] = p
        return self.plans[bsz]

    def __call__(self, feats, proj, emb, h, c, w):
        """Launch on the inputs; the outputs are buffers of this kernel's,
        reused by its next call at the same B (the timing loops launch
        with nothing but the C call on the host)."""
        import torch
        bsz, dev = feats.shape[0], feats.device
        if bsz not in self.buffers:
            outs = (torch.empty_like(h), torch.empty_like(c),
                    torch.empty((bsz, K), dtype=torch.float32, device=dev))
            scratch = ()
            if self.new:
                p = self.plan(bsz)
                scratch = (torch.empty(p.scratch_floats, dtype=torch.float32,
                                       device=dev),
                           torch.empty(p.scratch_ints, dtype=torch.int32,
                                       device=dev))
            self.buffers[bsz] = (outs, scratch)
        outs, scratch = self.buffers[bsz]
        ptrs = [t.data_ptr() for t in (feats, proj, emb, h, c, *w, *outs,
                                       *scratch)]
        stream = torch.cuda.current_stream().cuda_stream
        if not self.new:
            err = self.fn(ptrs[0], 1, *ptrs[1:], bsz, K, D, A, E, H, stream)
        else:
            p = self.plan(bsz)
            err = self.fn(ptrs[0], 1, *ptrs[1:], bsz, K, D, A, E, H, p.ctas,
                          p.h_cols, p.units, p.a_chunk, p.h_rows,
                          p.smem_bytes, stream)
        if err:
            raise RuntimeError(f"dcap_decode_step: CUDA error {err}")
        return outs


def make_case(bsz, seed=1):
    """chip_smoke.py phase 3's inputs: random step weights, |N(0,1)| bf16
    features, N(0, 0.25) projections, embeddings and state."""
    import torch
    from depth_image_captioning_pub_torch.models.initializers import (
        torch_linear_kernel)
    from depth_image_captioning_pub_torch.ops.kernels import decode_step
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch_linear_kernel(shape, gen).to(dev)

    w = decode_step.pack_weights(u(H, A), u(A), u(A), u(1), u(H, D), u(D),
                                 u(E + D, 4 * H), u(H, 4 * H), u(4 * H),
                                 u(4 * H), dim_embedding=E)
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(np.abs(rng.standard_normal((bsz, K, D))).astype(
        np.float32)).to(dev, torch.bfloat16)
    proj = torch.from_numpy(rng.standard_normal((bsz, K, A)).astype(
        np.float32) * 0.5).to(dev)
    emb, h, c = (torch.from_numpy(rng.standard_normal((bsz, n)).astype(
        np.float32) * 0.5).to(dev) for n in (E, H, H))
    return feats, proj, emb, h, c, w


def cuda_ms(fn, iters, spin=True):
    """Mean device time of fn() over iters calls, with ``spin`` queued
    behind a spin kernel: the card runs them back to back whatever the
    host's rate."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if spin and host_ms > 0.8 * SPIN_CYCLES / 2.0e6:   # at 2 GHz
        raise RuntimeError(f"the host took {host_ms:.2f} ms to queue "
                           f"{iters} launches: longer than the spin")
    return start.elapsed_time(stop) / iters


def phase_breakdown(kern, case, mhz):
    """Each phase's critical path, the barriers' latency and the slowest
    CTA's whole span, in µs, from one run of the traced kernel ``kern``."""
    import torch
    ctas = kern.plan(case[0].shape[0]).ctas
    buf = torch.zeros(7 * ctas, dtype=torch.int64, device="cuda")
    set_trace = kern.lib.dcap_trace_set
    set_trace.argtypes = [_P]
    if set_trace(buf.data_ptr()):
        raise RuntimeError("dcap_trace_set failed")
    kern(*case)
    torch.cuda.synchronize()
    start, loaded, arrive0, leave0, arrive1, leave1, end = (
        buf.cpu().numpy().reshape(7, ctas))
    return {"load_us": (loaded - start).max() / mhz,
            "H_us": (arrive0 - loaded).max() / mhz,
            "A_us": (arrive1 - leave0).max() / mhz,
            "G_us": (end - leave1).max() / mhz,
            "barriers_us": ((leave0 - arrive0).min()
                            + (leave1 - arrive1).min()) / mhz,
            "cta_us": (end - start).max() / mhz}


def main():
    import torch
    from depth_image_captioning_pub_torch.ops.kernels.decode_step import (
        fused_decode_core_plain)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=DIR", help="a directory with another "
                    "decode_step.cu and its headers")
    ap.add_argument("--units", nargs="*", type=int, default=[],
                    choices=(1, 2))
    ap.add_argument("--batches", nargs="*", type=int, default=[1, 16, 64])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_step_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    text = SRC.read_text()
    sources = [("kernel", inline_phases(text), CSRC),
               ("trace_kernel", traced_source(text), CSRC)]
    for spec in args.source:
        name, path = spec.split("=", 1)
        src_dir = Path(path)
        sources.append((name, (src_dir / "decode_step.cu").read_text(),
                        src_dir.resolve()))
    built = build_all(sources)
    for name, (_, lines) in built.items():
        for line in lines:
            print(f"[ptxas] {name}: {line}", flush=True)
    kernels = {name: Kernel(lib) for name, (lib, _) in built.items()
               if not name.startswith("trace_")}
    traced = {"kernel": Kernel(built["trace_kernel"][0])}
    for u in args.units:
        kernels[f"kernel_units{u}"] = Kernel(built["kernel"][0], units=u)
        traced[f"kernel_units{u}"] = Kernel(built["trace_kernel"][0],
                                            units=u)

    results, breakdown, ok = {}, {}, True
    for bsz in args.batches:
        key = f"B={bsz}"
        case = make_case(bsz)
        with torch.inference_mode():
            want = fused_decode_core_plain(*case)
            outs = {}
            for name, kern in kernels.items():
                outs[name] = kern(*case)
                torch.cuda.synchronize()
            times = {name: [] for name in kernels}
            order = list(kernels) + list(kernels)[::-1]
            for name in order + order:
                times[name].append(cuda_ms(
                    lambda k=kernels[name]: k(*case), ITERS))
            plain_ms = cuda_ms(lambda: fused_decode_core_plain(*case), ITERS,
                               spin=False)
            mhz = float(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True).stdout.split()[0])
            breakdown[key] = {name: phase_breakdown(kern, case, mhz)
                              for name, kern in traced.items()}
            breakdown[key]["sm_mhz"] = mhz
        for name in kernels:
            err = max((g - x).abs().max().item()
                      for g, x in zip(outs[name], want))
            diff = max((g - x).abs().max().item()
                       for g, x in zip(outs[name], outs["kernel"]))
            good = err <= ATOL
            ok = ok and good
            plan = kernels[name].plans.get(bsz)
            results.setdefault(name, {})[key] = {
                "ms": min(times[name]), "ms_all": times[name],
                "plain_ms": plain_ms, "max_abs_err": err,
                "max_abs_diff_from_kernel": diff, "ok": good,
                "plan": None if plan is None else {
                    "ctas": plan.ctas, "units": plan.units,
                    "h_rows": plan.h_rows, "h_cols": plan.h_cols,
                    "a_chunk": plan.a_chunk, "smem_bytes": plan.smem_bytes}}
            print(f"[ab] {key} {name}: {min(times[name]):.4f} ms (runs "
                  f"{', '.join(f'{t:.4f}' for t in times[name])}); plain "
                  f"{plain_ms:.4f} ms; max abs err {err:.3e} "
                  f"{'ok' if good else 'WRONG'}, {diff:.3e} from the "
                  f"kernel's"
                  + (f"; plan {plan.ctas} CTAs, {plan.units} unit(s), "
                     f"h tile {plan.h_rows}, chunk {plan.a_chunk}, "
                     f"{plan.smem_bytes} B" if plan else "")
                  + f" [{smi}]", flush=True)
        for name in traced:
            b = breakdown[key][name]
            print(f"[trace] {key} {name} (SM clock {mhz:.0f} MHz), µs: "
                  f"load {b['load_us']:.2f}, H {b['H_us']:.2f}, A "
                  f"{b['A_us']:.2f}, G {b['G_us']:.2f}, 2 barriers "
                  f"{b['barriers_us']:.2f}; slowest CTA {b['cta_us']:.2f} "
                  f"[{smi}]", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({
            "card": smi, "results": results, "trace": breakdown,
            "ptxas": {n: l for n, (_, l) in built.items()}}, indent=1))
    if not ok:
        raise SystemExit("decode_step_ab: a kernel disagrees with the plain "
                         "version")


if __name__ == "__main__":
    main()
