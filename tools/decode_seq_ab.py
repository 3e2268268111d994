#!/usr/bin/env python3
"""A/B timing of the greedy decode kernel (K2) on one CUDA card: variants
of ``csrc/decode_seq.cu`` against each other and against other copies of
the source (an earlier commit's one-CTA-per-row kernel, say).

    python3 tools/decode_seq_ab.py [--source NAME=OTHER.cu ...] \\
        [--variants 512,4,2 256,4,2 ...] [--row-groups 32 ...] \\
        [--units 1 2] [--out FILE.json]

A variant ``T,HR,GR`` is a copy of ``csrc/decode_seq.cu`` with ``kThreads
= T`` threads per CTA, ``kHRows = HR`` rows in a thread's h-product tile
and ``kGRows = GR`` rows per warp in the gate products, planned with the
same numbers. ``--units U`` adds the first variant with U hidden units per
CTA at every B (the planner's ``TWO_UNITS_FROM`` moved past or below B);
``--row-groups N`` adds the first variant run as one launch per N rows,
one after the other, so that a group's features stay in L2. A
``--source`` copy without ``dcap_greedy_max_ctas`` is taken as the
parent's kernel (the C entry of one CTA per row); any other copy must have
this kernel's C entry. Every library is built by nvcc (all at the same
time) under ``build/decode_seq_ab/``, checked against the plain PyTorch
version (token agreement >= 0.99 with ``<end>`` set) and timed with CUDA
events at full width (K=196, D=2048 bf16, A=E=H=128, V=9956, 30 steps) at
B = 1, 16 and 64, in turns (A B C ... C B A, twice); the least of the four
timings is shown.

The first variant is also built as a traced copy, into which the tool
writes SM-clock stamps (``clock64``) as each CTA starts, as it arrives at
and leaves each grid barrier, and at marks inside the phases; they land in
the int scratch past the kernel's own carve. One run at each B without
``<end>`` gives each phase's critical path (the slowest CTA's work between
two barriers), the slowest CTA's time to each mark, and the barriers' own
latency. Prints ptxas' lines, the tables and the card's ``nvidia-smi``
name and power limit; ``--out`` also writes them as JSON.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
CSRC = REPO / "depth_image_captioning_pub_torch" / "csrc"
SRC = CSRC / "decode_seq.cu"
OUT_DIR = REPO / "build" / "decode_seq_ab"
K, D, A, E, H, V = 196, 2048, 128, 128, 128, 9956
BATCHES = (1, 16, 64)
MAX_LEN, START, END = 30, 2, 3
CONSTS = ("kThreads", "kHRows", "kGRows")
ITERS = 10          # launches per timing
_P, _I = ctypes.c_void_p, ctypes.c_int
NEW_ARGS = [_P, _I] + [_P] * 19 + [_I] * 16 + [_P]
OLD_ARGS = [_P, _I] + [_P] * 17 + [_I] * 10 + [_P]

# The traced copy: (anchor, text put before it); each anchor occurs once.
TRACE_PRELUDE = """\
// SM-clock stamps, [1 + barriers, 2, ctas] int64 past the int scratch's
// carve, then the marks, [barriers, 4, ctas]
__device__ inline long long* trace_stamps(const PhaseParams& q) {
  return reinterpret_cast<long long*>(
      q.iscr + ((2 + (long)q.batch * (q.ctas + 2) + 1) & ~1L));
}
__shared__ int t_slot;  // barriers passed: the running phase ends at it
#define TRACE_MARK(q, m)                                                   \\
  do {                                                                     \\
    if (threadIdx.x == 0) {                                                \\
      const long rows = 2 * (2 + 3L * (q).max_length);                     \\
      trace_stamps(q)[(rows + 4L * t_slot + (m)) * (q).ctas + blockIdx.x] = \\
          clock64();                                                       \\
    }                                                                      \\
  } while (0)

"""
TRACE_INSERTS = (
    ("// Grid-wide barrier on a counter", TRACE_PRELUDE),
    ("    volatile int* gen = bar + 1;",
     "    long long* tr = trace_stamps(q);\n"
     "    tr[(2L * t_slot + 2) * q.ctas + blockIdx.x] = clock64();\n"),
    ("  }\n  __syncthreads();\n}\n\n// 16 bytes of features",
     "    tr[(2L * t_slot + 3) * q.ctas + blockIdx.x] = clock64();\n"
     "    ++t_slot;\n"),
    ("  load_slices(q, s);\n",
     "  if (threadIdx.x == 0) {\n"
     "    trace_stamps(q)[blockIdx.x] = clock64();\n"
     "    t_slot = 0;\n  }\n"),
    ("    const int items = (rt4 / kHR) * ncg;",
     "    if (r0 == 0) TRACE_MARK(q, 0);\n"),
    ("    if (cands) {\n      for (int rr = warp;",
     "    if (r0 == 0) TRACE_MARK(q, 1);\n"),
    ("    for (int k0 = 0; k0 < d.K; k0 += kThreads / parts) {",
     "    if (item == blockIdx.x) TRACE_MARK(q, 0);\n"),
    ("    // softmax over K in f32", "    if (item == blockIdx.x) TRACE_MARK(q, 1);\n"),
    ("    // ctx over the chunk", "    if (item == blockIdx.x) TRACE_MARK(q, 2);\n"),
    ("      lo = max(i0, d.E + d.D);",
     "      if (warp == 0 && base == 0) TRACE_MARK(q, 1);\n"),
    ("      lo = i0;\n      hi = min(i1, d.E);",
     "      if (warp == 0 && base == 0) TRACE_MARK(q, 2);\n"),
    ("#pragma unroll\n      for (int u = 0; u < kGUnits; ++u) {\n"
     "        if (u >= nu) break;",
     "      if (warp == 0 && base == 0) TRACE_MARK(q, 3);\n"),
    ("    if (tail) {\n      const int gl",
     "    if (base == 0) TRACE_MARK(q, 0);\n"),
)
# The marks of each phase, in TRACE_MARK's numbering
MARKS = {"set-up (slices, H on h0)": ("h staged", "products"),
         "A attention": ("tokens, dec staged", "scores", "softmax"),
         "G gates": ("products", "warp 0: gated part", "warp 0: h part",
                     "warp 0: emb part"),
         "H h-products": ("h staged", "products")}


def inline_phases(text):
    """The source with decode_phases.cuh written in place of its include:
    the phases, the constants and the trace anchors in one file."""
    header = (CSRC / "decode_phases.cuh").read_text()
    return text.replace('#include "decode_phases.cuh"\n',
                        header.replace("#pragma once\n", ""), 1)


def variant_source(text, values):
    for name, value in zip(CONSTS, values):
        text, count = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
        if count != 1:
            raise ValueError(f"{name} is defined {count} times in {SRC}")
    return text


def traced_source(text):
    for anchor, insert in TRACE_INSERTS:
        if text.count(anchor) != 1:
            raise ValueError(f"trace anchor {anchor!r} occurs "
                             f"{text.count(anchor)} times in {SRC}")
        text = text.replace(anchor, insert + anchor)
    return text


def build_all(sources):
    """nvcc every (name, text) at once; {name: (library, ptxas)}."""
    from depth_image_captioning_pub_torch.ops.kernels import _build
    nvcc = _build.nvcc_path()
    procs = {}
    for name, text in sources:
        d = OUT_DIR / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "decode_seq.cu").write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(CSRC), "-shared",
               "-o", str(d / "lib.so"), str(d / "decode_seq.cu")]
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
                keep = "greedy" in ln
            if keep and ("registers" in ln or "spill" in ln):
                lines.append(ln.split(":")[-1].strip())
        built[name] = (lib, lines)
    return built


class Kernel:
    """One library's greedy entry, called like ``fused_greedy_decode``.

    ``consts`` are the (kThreads, kHRows) it was built with; ``units``
    fixes the hidden units per CTA; ``row_group`` runs one launch per that
    many rows."""

    def __init__(self, lib_path, consts, units=None, row_group=None):
        self.lib = ctypes.CDLL(str(lib_path))
        self.new = hasattr(self.lib, "dcap_greedy_max_ctas")
        fn = self.lib.dcap_greedy_decode
        fn.argtypes = NEW_ARGS if self.new else OLD_ARGS
        fn.restype = ctypes.c_int
        self.fn, self.consts = fn, consts
        self.units, self.row_group = units, row_group
        self.plans = {}

    def plan(self, bsz):
        import torch
        from depth_image_captioning_pub_torch.ops.kernels import decode_seq
        if bsz not in self.plans:
            ctas = torch.cuda.get_device_properties(0).multi_processor_count
            two_from = {None: decode_seq.TWO_UNITS_FROM, 1: bsz + 1,
                        2: 0}[self.units]
            with mock.patch.multiple(decode_seq, THREADS=self.consts[0],
                                     H_ROWS=self.consts[1],
                                     TWO_UNITS_FROM=two_from):
                self.plans[bsz] = decode_seq.plan.__wrapped__(
                    bsz, K, D, A, E, H, V, ctas)
        return self.plans[bsz]

    def __call__(self, case, end_id=END, extra_ints=0):
        import torch
        f = case[0]
        bsz = f.shape[0]
        tokens = torch.empty((bsz, MAX_LEN), dtype=torch.int32,
                             device=f.device)
        step = min(self.row_group or bsz, bsz)
        for r in range(0, bsz, step):
            iscr = self.launch([t[r:r + step] for t in case[:4]], case[4],
                               tokens[r:r + step], end_id, extra_ints)
        return tokens, iscr

    def launch(self, rows, w, tokens, end_id, extra_ints):
        import torch
        f, proj, h0, c0 = rows
        bsz = f.shape[0]
        ptrs = [t.data_ptr() for t in (proj, h0, c0, *w.step, w.w_out,
                                       w.b_out, w.embed)]
        stream = torch.cuda.current_stream().cuda_stream
        iscr = None
        if not self.new:
            err = self.fn(f.data_ptr(), 1, *ptrs, tokens.data_ptr(), bsz, K,
                          D, A, E, H, V, MAX_LEN, START, end_id, stream)
        else:
            p = self.plan(bsz)
            fscr = torch.empty(p.scratch_floats, dtype=torch.float32,
                               device=f.device)
            iscr = torch.zeros(p.scratch_ints + 1 + extra_ints,
                               dtype=torch.int32, device=f.device)
            err = self.fn(f.data_ptr(), 1, *ptrs, tokens.data_ptr(),
                          fscr.data_ptr(), iscr.data_ptr(), bsz, K, D, A, E,
                          H, V, MAX_LEN, START, end_id, p.ctas, p.h_cols,
                          p.units, p.a_chunk, p.h_rows, p.smem_bytes, stream)
        if err:
            raise RuntimeError(f"dcap_greedy_decode: CUDA error {err}")
        return iscr


def make_case(bsz, seed=2):
    import torch
    from depth_image_captioning_pub_torch.models.decoder import (
        AttentionDecoder)
    from depth_image_captioning_pub_torch.ops.attention import (
        project_features)
    dev = torch.device("cuda")
    dec = AttentionDecoder(V, A, E, D, H, device=dev)
    dec.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    f = torch.from_numpy(np.abs(rng.standard_normal((bsz, K, D))).astype(
        np.float32)).to(dev, torch.bfloat16)
    with torch.inference_mode():
        proj = project_features(dec.att_params(), f,
                                compute_dtype=torch.float32)
        st = dec.init_state(f)
        return f, proj, st.h, st.c, dec.seq_weights()


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


def phase_breakdown(kernel, case, mhz):
    """Each phase's critical path (the slowest CTA's work between two
    barriers), the points marked inside it (the slowest CTA's time to
    each), and the barriers' own latency (the least wait), in µs summed
    over the steps, from one traced run without <end>."""
    import torch
    bsz = case[0].shape[0]
    p = kernel.plan(bsz)
    barriers = 1 + 3 * MAX_LEN
    off = (2 + bsz * (p.ctas + 2) + 1) & ~1
    rows = 2 * (1 + barriers) + 4 * barriers     # int64 rows of ctas
    _, iscr = kernel(case, end_id=-1, extra_ints=off + 2 * rows * p.ctas)
    torch.cuda.synchronize()
    tr = iscr[off:off + 2 * rows * p.ctas].cpu().numpy().view(
        np.int64).reshape(rows, p.ctas)
    stamps = tr[:2 * (1 + barriers)].reshape(1 + barriers, 2, p.ctas)
    marks = tr[2 * (1 + barriers):].reshape(barriers, 4, p.ctas)
    leave = stamps[:, 1].copy()
    leave[0] = stamps[0, 0]
    kinds = (["set-up (slices, H on h0)"]
             + ["A attention", "G gates", "H h-products"] * MAX_LEN)
    work, wait = {}, 0.0
    for b in range(barriers):
        kind = kinds[b]
        span = (stamps[b + 1, 0] - leave[b]).max() / mhz
        entry = work.setdefault(kind, {"total": 0.0})
        entry["total"] += span
        for m, name in enumerate(MARKS.get(kind, ())):
            hit = marks[b, m] > 0
            if hit.any():
                t = (marks[b, m][hit] - leave[b][hit]).max() / mhz
                entry[name] = entry.get(name, 0.0) + t
        wait += (stamps[b + 1, 1] - stamps[b + 1, 0]).min() / mhz
    return {"phases_us": work, "barriers_us": wait, "barriers": barriers}


def main():
    import torch
    from depth_image_captioning_pub_torch.ops.kernels.decode_seq import (
        fused_greedy_decode_plain)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH", help="another decode_seq.cu")
    ap.add_argument("--variants", nargs="*", default=["512,4,2"])
    ap.add_argument("--row-groups", nargs="*", type=int, default=[])
    ap.add_argument("--units", nargs="*", type=int, default=[],
                    choices=(1, 2))
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_seq_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    text = inline_phases(SRC.read_text())
    specs = [tuple(int(x) for x in v.split(",")) for v in args.variants]
    sources = [(f"t{t}_h{hr}_g{gr}", variant_source(text, (t, hr, gr)))
               for t, hr, gr in specs]
    sources.append(("trace", traced_source(variant_source(text, specs[0]))))
    consts = dict(zip([n for n, _ in sources], specs + [specs[0]]))
    for spec in args.source:
        name, path = spec.split("=", 1)
        sources.append((name, Path(path).read_text()))
    built = build_all(sources)
    for name, (_, lines) in built.items():
        for line in lines:
            print(f"[ptxas] {name}: {line}", flush=True)
    from depth_image_captioning_pub_torch.ops.kernels import decode_seq
    default = (decode_seq.THREADS, decode_seq.H_ROWS)
    kernels = {name: Kernel(lib, consts.get(name, default))
               for name, (lib, _) in built.items() if name != "trace"}
    first = sources[0][0]
    for rg in args.row_groups:
        kernels[f"{first}_rows{rg}"] = Kernel(built[first][0], specs[0],
                                              row_group=rg)
    for u in args.units:
        kernels[f"{first}_units{u}"] = Kernel(built[first][0], specs[0],
                                              units=u)
    traced = Kernel(built["trace"][0], specs[0])

    results, breakdown = {}, {}
    for bsz in BATCHES:
        case = make_case(bsz)
        with torch.inference_mode():
            f, proj, h0, c0, w = case
            want = fused_greedy_decode_plain(f, proj, h0, c0, w,
                                             max_length=MAX_LEN,
                                             start_id=START, end_id=END)
            agree, toks = {}, {}
            for name, kern in kernels.items():
                toks[name], _ = kern(case)
                torch.cuda.synchronize()
                agree[name] = (toks[name] == want).float().mean().item()
            times = {name: [] for name in kernels}
            order = list(kernels) + list(kernels)[::-1]
            for name in order + order:
                times[name].append(cuda_ms(
                    lambda k=kernels[name]: k(case), ITERS))
            mhz = float(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True).stdout.split()[0])
            breakdown[bsz] = phase_breakdown(traced, case, mhz)
            breakdown[bsz]["sm_mhz"] = mhz
        for name in kernels:
            ok = agree[name] >= 0.99
            same = torch.equal(toks[name], toks[first])
            results.setdefault(name, {})[f"B={bsz}"] = {
                "ms": min(times[name]), "ms_all": times[name],
                "token_agreement": agree[name], "ok": ok,
                "same_tokens_as_first": same}
            print(f"[ab] B={bsz} {name}: {min(times[name]):.4f} ms (runs "
                  f"{', '.join(f'{t:.4f}' for t in times[name])}); token "
                  f"agreement {agree[name]:.4f} {'ok' if ok else 'WRONG'}; "
                  f"tokens {'=' if same else '!='} {first}'s [{smi}]",
                  flush=True)
        b = breakdown[bsz]
        print(f"[trace] B={bsz} ({first}, no <end>, SM clock {mhz:.0f} MHz): "
              + "; ".join(f"{k} {v['total']:.1f} us (" + ", ".join(
                  f"{m} by {t:.1f}" for m, t in v.items() if m != "total")
                  + ")" for k, v in b["phases_us"].items())
              + f"; {b['barriers']} barriers {b['barriers_us']:.1f} us "
              f"[{smi}]", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({
            "card": smi, "results": results, "trace": breakdown,
            "ptxas": {n: l for n, (_, l) in built.items()}}, indent=1))
    if not all(r["ok"] for per in results.values() for r in per.values()):
        raise SystemExit("decode_seq_ab: a kernel disagrees with the plain "
                         "version")


if __name__ == "__main__":
    main()
