#!/usr/bin/env python3
"""A/B timing of the beam-search kernel (K4) on one CUDA card: the kernel
and its planner variants against other copies of the source (an earlier
commit's one-CTA-per-image kernel, say), in turns in one process.

    python3 tools/beam_seq_ab.py [--source NAME=OTHER.cu ...] \\
        [--variants 4,2,4 8,4,8 ...] [--units 1 2] [--h-tiles 64 ...] \\
        [--batches 1 16 64] [--beams 5] [--out FILE.json]

A variant ``HR,GR,CU`` is a copy of ``csrc/beam_seq.cu`` with
``kBeamHRows = HR`` rows in a thread's h-product tile, ``kBeamGRows = GR``
rows per warp in the gate products and ``kCtxUnroll = CU`` feature rows in
flight per thread in phase A, planned with the same numbers; "kernel" is
the shipped constants. ``--units U`` adds the kernel planned with U hidden units per CTA at every
B (the planner's ``TWO_UNITS_FROM`` moved past or below the rows);
``--h-tiles N`` adds it planned with at most N rows per h-product tile
(``H_TILE_MAX``). A ``--source`` copy without ``dcap_beam_max_ctas`` is
taken as the parent's kernel (the C entry of one CTA per image); any other
copy must have this kernel's C entry. Each source is built by nvcc (all at
the same time, ``decode_phases.cuh`` written into the copy) under
``build/beam_seq_ab/``, checked against the plain PyTorch version
(best-token and record agreement >= 0.99) and timed with CUDA events at
full width (K=196, D=2048 bf16, A=E=H=128, V=9956, 30 steps, <end> set) at
each B and W, in turns (A B C ... C B A, twice); the least of the four
timings is shown, and whether each kernel's records equal the first's.

The kernel is also built as a traced copy, into which the tool writes
SM-clock stamps (``clock64``) as each CTA starts and as it arrives at and
leaves each grid barrier. One run at each B gives each phase's critical
path per step (the slowest CTA's work between two barriers: A attention,
G gates, H h-products, T1 the CTAs' top-W over their vocab columns, T2 the
owners' merge; the last step's T2 ends the kernel and is not counted) and the barriers' own latency (the least wait). Prints
ptxas' lines, the tables and the card's ``nvidia-smi`` name and power
limit; ``--out`` also writes them as JSON.
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
SRC = CSRC / "beam_seq.cu"
OUT_DIR = REPO / "build" / "beam_seq_ab"
K, D, A, E, H, V = 196, 2048, 128, 128, 128, 9956
MAX_LEN, START, END = 30, 2, 3
ITERS = 5           # launches per timing
_P, _I = ctypes.c_void_p, ctypes.c_int
NEW_ARGS = [_P, _I] + [_P] * 22 + [_I] * 17 + [_P]
OLD_ARGS = [_P, _I] + [_P] * 20 + [_I] * 11 + [_P]
PHASES = ("A attention", "G gates", "H h-products", "T1 slices' top-W",
          "T2 merge")
CONSTS = ("kBeamHRows", "kBeamGRows", "kCtxUnroll")

# The traced copy: (anchor, text put before it); each anchor occurs once.
TRACE_INSERTS = (
    ("// Grid-wide barrier on a counter",
     "// SM-clock stamps: [1 + 2 x barriers, ctas] int64\n"
     "__device__ long long* dcap_trace;\n"
     "__shared__ int t_slot;  // barriers passed\n\n"),
    ("    volatile int* gen = bar + 1;",
     "    dcap_trace[(1 + 2L * t_slot) * q.ctas + blockIdx.x] = clock64();\n"),
    ("  }\n  __syncthreads();\n}\n\n// 16 bytes of features",
     "    dcap_trace[(2 + 2L * t_slot) * q.ctas + blockIdx.x] = clock64();\n"
     "    ++t_slot;\n"),
    ("  load_slices(q, s);\n",
     "  if (threadIdx.x == 0) {\n"
     "    dcap_trace[blockIdx.x] = clock64();\n"
     "    t_slot = 0;\n  }\n"),
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


def variant_source(text, values):
    for name, value in zip(CONSTS, values):
        text, count = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
        if count != 1:
            raise ValueError(f"{name} is defined {count} times in {SRC}")
    return text


def shipped_consts(text):
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                               text).group(1)) for name in CONSTS)


def traced_source(text):
    text = inline_phases(text)
    for anchor, insert in TRACE_INSERTS:
        if text.count(anchor) != 1:
            raise ValueError(f"trace anchor {anchor!r} occurs "
                             f"{text.count(anchor)} times in {SRC} with "
                             f"decode_phases.cuh")
        text = text.replace(anchor, insert + anchor)
    return text + TRACE_SETTER


def build_all(sources):
    """nvcc every (name, text) at once; {name: (library, ptxas lines)}."""
    from depth_image_captioning_pub_torch.ops.kernels import _build
    nvcc = _build.nvcc_path()
    procs = {}
    for name, text in sources:
        d = OUT_DIR / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "beam_seq.cu").write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(CSRC), "-shared",
               "-o", str(d / "lib.so"), str(d / "beam_seq.cu")]
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
                keep = ("beam" in ln and "Li5E" in ln
                        and "bfloat16" in ln)
            if keep and ("registers" in ln or "spill" in ln):
                lines.append(ln.split(":")[-1].strip())
        built[name] = (lib, lines)
    return built


class Kernel:
    """One library's beam entry, called like ``fused_beam_decode``.

    ``h_rows`` is the kBeamHRows it was built with (the h tile is a
    multiple of it); ``units`` fixes the hidden units per CTA, ``h_tile``
    the most rows of an h-product tile."""

    def __init__(self, lib_path, h_rows=None, units=None, h_tile=None):
        self.lib = ctypes.CDLL(str(lib_path))
        self.new = hasattr(self.lib, "dcap_beam_max_ctas")
        fn = self.lib.dcap_beam_decode
        fn.argtypes = NEW_ARGS if self.new else OLD_ARGS
        fn.restype = ctypes.c_int
        self.fn, self.units, self.h_tile = fn, units, h_tile
        self.h_rows = h_rows
        self.plans = {}

    def plan(self, bsz, beam):
        import torch
        from depth_image_captioning_pub_torch.ops.kernels import beam_seq
        if (bsz, beam) not in self.plans:
            ctas = torch.cuda.get_device_properties(0).multi_processor_count
            two_from = {None: beam_seq.TWO_UNITS_FROM, 1: bsz * beam + 1,
                        2: 0}[self.units]
            with mock.patch.multiple(
                    beam_seq, TWO_UNITS_FROM=two_from,
                    H_TILE_MAX=self.h_tile or beam_seq.H_TILE_MAX,
                    BEAM_H_ROWS=self.h_rows or beam_seq.BEAM_H_ROWS):
                self.plans[bsz, beam] = beam_seq.plan_beam.__wrapped__(
                    bsz, beam, K, D, A, E, H, V, ctas)
        return self.plans[bsz, beam]

    def __call__(self, case, beam):
        import torch
        from depth_image_captioning_pub_torch.ops.kernels.beam_seq import (
            BeamSeqOutputs)
        f, proj, h0, c0, w = case
        bsz, dev = f.shape[0], f.device
        ptrs = [t.data_ptr() for t in (proj, h0, c0, *w.step, w.w_out,
                                       w.b_out, w.embed)]
        logits = torch.empty((bsz, beam, V), dtype=torch.float32, device=dev)
        tokens = torch.empty((bsz, beam, MAX_LEN), dtype=torch.int32,
                             device=dev)
        parents = torch.empty_like(tokens)
        scores = torch.empty((bsz, beam), dtype=torch.float32, device=dev)
        outs = [t.data_ptr() for t in (logits, tokens, parents, scores)]
        stream = torch.cuda.current_stream().cuda_stream
        if not self.new:
            err = self.fn(f.data_ptr(), 1, *ptrs, *outs, bsz, K, D, A, E, H,
                          V, beam, MAX_LEN, START, END, stream)
        else:
            p = self.plan(bsz, beam)
            fscr = torch.empty(p.scratch_floats, dtype=torch.float32,
                               device=dev)
            iscr = torch.empty(p.scratch_ints, dtype=torch.int32, device=dev)
            err = self.fn(f.data_ptr(), 1, *ptrs, *outs, fscr.data_ptr(),
                          iscr.data_ptr(), bsz, K, D, A, E, H, V, beam,
                          MAX_LEN, START, END, p.ctas, p.h_cols, p.units,
                          p.a_chunk, p.h_rows, p.smem_bytes, stream)
        if err:
            raise RuntimeError(f"dcap_beam_decode: CUDA error {err}")
        return BeamSeqOutputs(tokens, parents, scores)


def make_case(bsz, seed=10):
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


def agreement(got, want):
    """(best-token agreement, record agreement, scores' max abs error)."""
    from depth_image_captioning_pub_torch.ops.kernels import beam_seq
    best = (beam_seq.select_best(got, END)[0]
            == beam_seq.select_best(want, END)[0]).float().mean().item()
    rec = min((got.tokens == want.tokens).float().mean().item(),
              (got.parents == want.parents).float().mean().item())
    return best, rec, (got.scores - want.scores).abs().max().item()


def phase_breakdown(kern, case, beam, mhz):
    """Each phase's critical path per step and the barriers' latency, in
    µs, from one traced run of the traced kernel ``kern``."""
    import torch
    bsz = case[0].shape[0]
    ctas = kern.plan(bsz, beam).ctas
    barriers = 1 + len(PHASES) * MAX_LEN - 1
    buf = torch.zeros((1 + 2 * barriers) * ctas, dtype=torch.int64,
                      device="cuda")
    set_trace = kern.lib.dcap_trace_set
    set_trace.argtypes = [_P]
    if set_trace(buf.data_ptr()):
        raise RuntimeError("dcap_trace_set failed")
    out = kern(case, beam)
    torch.cuda.synchronize()
    steps = int(np.max(_steps(out)))
    run = 1 + len(PHASES) * steps - (1 if steps == MAX_LEN else 0)
    tr = buf.cpu().numpy().reshape(1 + 2 * barriers, ctas)
    start, arrive, leave = tr[0], tr[1::2], tr[2::2]
    spans = {"set-up (slices, H on h0)": 0.0}
    spans.update({name: 0.0 for name in PHASES})
    wait = 0.0
    for b in range(run):
        before = start if b == 0 else leave[b - 1]
        kind = ("set-up (slices, H on h0)" if b == 0
                else PHASES[(b - 1) % len(PHASES)])
        spans[kind] += (arrive[b] - before).max() / mhz
        wait += (leave[b] - arrive[b]).min() / mhz
    per_step = {k: v / steps for k, v in spans.items() if k in PHASES}
    return {"steps": steps, "barriers": run, "total_us": spans,
            "per_step_us": per_step, "barriers_us": wait,
            "barrier_us_each": wait / run}


def _steps(out):
    """Steps the search ran: up to the one after which every beam of every
    image had finished, replayed from the records."""
    tok = out.tokens.cpu().numpy()
    par = out.parents.cpu().numpy().astype(np.int64)
    fin = np.zeros(tok.shape[:2], bool)
    for t in range(tok.shape[2]):
        fin = np.take_along_axis(fin, par[:, :, t], 1) | (tok[:, :, t] == END)
        if fin.all():
            return t + 1
    return tok.shape[2]


def main():
    import torch
    from depth_image_captioning_pub_torch.ops.kernels.beam_seq import (
        fused_beam_decode_plain)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH", help="another beam_seq.cu")
    ap.add_argument("--variants", nargs="*", default=[])
    ap.add_argument("--units", nargs="*", type=int, default=[],
                    choices=(1, 2))
    ap.add_argument("--h-tiles", nargs="*", type=int, default=[])
    ap.add_argument("--batches", nargs="*", type=int, default=[1, 16, 64])
    ap.add_argument("--beams", nargs="*", type=int, default=[5])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("beam_seq_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    text = SRC.read_text()
    specs = [shipped_consts(text)] + [
        tuple(int(x) for x in v.split(",")) for v in args.variants]
    names = ["kernel"] + [f"h{hr}_g{gr}_u{cu}" for hr, gr, cu in specs[1:]]
    sources = [(name, inline_phases(variant_source(text, spec)))
               for name, spec in zip(names, specs)]
    sources += [(f"trace_{name}", traced_source(variant_source(text, spec)))
                for name, spec in zip(names, specs)]
    for spec in args.source:
        name, path = spec.split("=", 1)
        sources.append((name, inline_phases(Path(path).read_text())))
    built = build_all(sources)
    for name, (_, lines) in built.items():
        for line in lines:
            print(f"[ptxas] {name} (bf16, W=5): {line}", flush=True)
    rows_of = {name: spec[0] for name, spec in zip(names, specs)}
    kernels = {name: Kernel(lib, rows_of.get(name))
               for name, (lib, _) in built.items()
               if not name.startswith("trace_")}
    traced = {name: Kernel(built[f"trace_{name}"][0], rows_of[name])
              for name in names}
    for u in args.units:
        kernels[f"kernel_units{u}"] = Kernel(built["kernel"][0],
                                             rows_of["kernel"], units=u)
    for t in args.h_tiles:
        kernels[f"kernel_htile{t}"] = Kernel(built["kernel"][0],
                                             rows_of["kernel"], h_tile=t)

    results, breakdown = {}, {}
    ok = True
    for bsz in args.batches:
        case = make_case(bsz)
        for beam in args.beams:
            key = f"B={bsz} W={beam}"
            with torch.inference_mode():
                f, proj, h0, c0, w = case
                want = fused_beam_decode_plain(
                    f, proj, h0, c0, w, beam_size=beam, max_length=MAX_LEN,
                    start_id=START, end_id=END)
                outs, agree = {}, {}
                for name, kern in kernels.items():
                    outs[name] = kern(case, beam)
                    torch.cuda.synchronize()
                    agree[name] = agreement(outs[name], want)
                first = outs["kernel"]
                times = {name: [] for name in kernels}
                order = list(kernels) + list(kernels)[::-1]
                for name in order + order:
                    times[name].append(cuda_ms(
                        lambda k=kernels[name]: k(case, beam), ITERS))
                mhz = float(subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, check=True).stdout.split()[0])
                breakdown[key] = {
                    name: phase_breakdown(kern, case, beam, mhz)
                    for name, kern in traced.items()}
                breakdown[key]["sm_mhz"] = mhz
            for name in kernels:
                best, rec, err = agree[name]
                good = min(best, rec) >= 0.99 and err <= 1e-3
                ok = ok and good
                same = all(torch.equal(a, b)
                           for a, b in zip(outs[name], first))
                plan = (kernels[name].plans.get((bsz, beam))
                        if kernels[name].new else None)
                results.setdefault(name, {})[key] = {
                    "ms": min(times[name]), "ms_all": times[name],
                    "best_token_agreement": best, "record_agreement": rec,
                    "score_err": err, "same_records_as_kernel": same,
                    "ok": good, "plan": None if plan is None else {
                        "ctas": plan.ctas, "units": plan.units,
                        "h_rows": plan.h_rows, "a_chunk": plan.a_chunk,
                        "smem_bytes": plan.smem_bytes}}
                print(f"[ab] {key} {name}: {min(times[name]):.4f} ms (runs "
                      f"{', '.join(f'{t:.4f}' for t in times[name])}); "
                      f"best-token {best:.4f}, records {rec:.4f}, scores "
                      f"err {err:.2e} {'ok' if good else 'WRONG'}; records "
                      f"{'=' if same else '!='} kernel's"
                      + (f"; plan {plan.ctas} CTAs, {plan.units} unit(s), "
                         f"h tile {plan.h_rows}, {plan.smem_bytes} B"
                         if plan else "") + f" [{smi}]", flush=True)
            for name in traced:
                b = breakdown[key][name]
                print(f"[trace] {key} {name} ({b['steps']} steps, SM clock "
                      f"{mhz:.0f} MHz), µs per step: " + "; ".join(
                          f"{k} {v:.2f}" for k, v in b["per_step_us"].items())
                      + f"; set-up "
                      f"{b['total_us']['set-up (slices, H on h0)']:.1f} µs "
                      f"once; {b['barriers']} barriers "
                      f"{b['barriers_us']:.1f} µs "
                      f"({b['barrier_us_each']:.2f} each) [{smi}]",
                      flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({
            "card": smi, "results": results, "trace": breakdown,
            "ptxas": {n: l for n, (_, l) in built.items()}}, indent=1))
    if not ok:
        raise SystemExit("beam_seq_ab: a kernel disagrees with the plain "
                         "version")


if __name__ == "__main__":
    main()
