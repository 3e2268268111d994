// Whole-sequence NIC (Show and Tell) greedy decode in ONE cooperative
// launch: a persistent grid of one CTA per SM, the time loop inside the
// launch, and the weights resident in shared memory, on the phases of
// decode_phases.cuh.
//
// Replaces the TPU kernel
// depth_image_captioning_pub_tpu/ops/pallas/nic_seq.py::fused_nic_greedy_decode
// (pallas_call body `_make_kernel`). The stacked LSTM starts from zero state
// and is primed by the image embedding x0 at step 0; each step runs
//
//   for each layer l (input x for l = 0, the new h of layer l-1 above it):
//     gates = in W_ih_l + h_l W_hh_l + b_l     [4H]  (b = b_ih + b_hh)
//     c_l'  = sigmoid(f) c_l + sigmoid(i) tanh(g);  h_l' = sigmoid(o) tanh(c_l')
//   token = argmax(h_top' W_out + b_out)       lowest index on equal values
//   x     = embed[token]                       [E], a gather
//
// for a fixed max_length steps: NIC's greedy decode has no <end> early exit
// (the JAX scan and the Pallas kernel both run every step).
//
// Each CTA loads once per launch, straight from the weight tensors, a column
// slice of W_out and b_out (76 of the 9,956 columns at the main shape) and
// the four gate columns (i, f, g, o) of its 1 or 2 hidden units in EVERY
// layer ([W_ih_l; W_hh_l]: E + H rows for layer 0, 2H above), so a unit's
// LSTM tail stays in the same CTA in every layer. From then on it reads each
// weight element from shared memory once per step for all the rows it
// serves. A step is L + 1 phases between grid barriers:
//
//   G_l  for each layer l: the gates of the CTA's units for its part of the
//        rows, input [x0 (t = 0), embed[token] or h_{l-1}' | h_l], and the
//        LSTM tail (gate_segment of decode_phases.cuh). G_0 also resolves
//        its rows' tokens of step t-1 (phase R, the best of the CTAs' head
//        candidates), and the first unit group's CTAs record them.
//   H    h_top' W_out + b_out over the CTA's columns: each row's best
//        (value, index) into a [B, ctas] scratch (hproducts_phase, with no
//        dec or gp columns)
//
// and R once more after the last step. Each layer's h is double-buffered by
// step: other CTAs read a row's h_l while its units' owners write h_l'. Each
// c is read only by its unit's owner. Every sum has a fixed order and there
// is no float atomic, so repeated calls are bit-identical.
//
// What bounds it on an H100: the products are small (208 MFLOP a step at
// B=64, 3 us at the f32 FMA rate) and read their weights from shared
// memory; a step is latency (tools/nic_seq_ab.py's trace at B=64, us): G_0
// 6.2 and G_1 4.1, every CTA reading the same freshly written rows from L2;
// H 10.6, 76 columns x 64 rows x H from shared memory on 304 of the 512
// threads; and L + 1 grid barriers of ~1.5 each.
//
// Widths: the input rows (x0, embed, h) are read 16 bytes at a time, so E
// and H must be multiples of 4; the wrapper pads narrower widths with zeros
// (a zero hidden unit stays 0). Any V and any B >= 1. The planner in
// ops/kernels/nic_seq.py sizes the slices, the units, the row tile and the
// shared memory; the launcher checks the carve against it. Plain C
// interface, loaded with ctypes (ops/kernels/_build.py). Build without
// --use_fast_math.
#include "decode_phases.cuh"

namespace dcap {
namespace seq {
namespace nic {

constexpr int kMaxLayers = 4;
constexpr int kNicGRows = 2;  // rows of a warp's gate products
// the gate products' partial sums: per warp, unit, row and gate
constexpr int kPartFloats = kWarps * kGUnits * kNicGRows * 4;
constexpr int kTokSlots = kWarps * kNicGRows;  // the tokens of a G_0 pass

struct Params : PhaseParams {
  const float* x0;                // [B, E]
  const float* w_ih[kMaxLayers];  // [E or H, 4H]
  const float* w_hh[kMaxLayers];  // [H, 4H]
  const float* b[kMaxLayers];     // [4H]  (b_ih + b_hh)
  int layers;
  int* tokens;                    // [B, max_length]
};

// Rows of layer l's gate weights: its input, then h.
__host__ __device__ inline int gate_len(const Params& q, int l) {
  return (l == 0 ? q.d.E : q.d.H) + q.d.H;
}

// Shared memory in floats; the same sum as ops/kernels/nic_seq.smem_floats.
__host__ __device__ inline long smem_floats(const Params& q) {
  const StepDims& d = q.d;
  const long rows = d.E + d.H + (q.layers - 1) * 2L * d.H;
  return (long)d.H * q.h_cols + 4L * q.units * rows +
         (long)q.h_rows * (d.H + 4) + kPartFloats + q.h_cols +
         4L * q.units * q.layers + 2L * q.h_rows * (q.h_cols / 4) +
         kTokSlots;
}

// s.wg holds the layers' gate slices one after the other, s.bg their
// biases; the kTokSlots ints after s.ci are the kernel's s_tok.
__device__ inline Smem carve_smem(float* base, const Params& q) {
  const StepDims& d = q.d;
  Smem s{};
  s.wh = base;
  s.wg = s.wh + (size_t)d.H * q.h_cols;
  s.ht = s.wg + 4L * q.units * (d.E + d.H + (q.layers - 1) * 2L * d.H);
  // float4-read arrays first: every size before them is a multiple of 4
  s.part = s.ht + (size_t)q.h_rows * (d.H + 4);
  s.bh = s.part + kPartFloats;
  s.bg = s.bh + q.h_cols;
  s.cv = s.bg + 4 * q.units * q.layers;
  s.ci = reinterpret_cast<int*>(s.cv + q.h_rows * (q.h_cols / 4));
  return s;
}

// Scratch in global memory, written and read by different CTAs (read with
// __ldcg: L1 is not coherent across SMs): B * (3 L H + ctas) floats, 2 + B *
// ctas ints.
struct Scratch {
  float* h;       // [L, 2, B, H]
  float* c;       // [L, B, H]
  float* cand_v;  // [B, ctas]
  int* cand_i;    // [B, ctas]
};

__device__ inline Scratch carve_scratch(const Params& q) {
  const long bh = (long)q.batch * q.d.H;
  Scratch x;
  x.h = q.fscr;
  x.c = x.h + 2 * q.layers * bh;
  x.cand_v = x.c + q.layers * bh;
  x.cand_i = q.iscr + 2;
  return x;
}

// Load the CTA's weight slices into shared memory (once per launch): the
// h-product columns as load_slices does with no dec or gp columns, and the
// gate columns of the CTA's units in every layer.
__device__ inline void load_nic_slices(const Params& q, const Smem& s) {
  const StepDims& d = q.d;
  const int tid = threadIdx.x;
  const long c0 = (long)blockIdx.x * q.vocab / q.ctas;
  const int width = (int)((long)(blockIdx.x + 1) * q.vocab / q.ctas - c0);
#pragma unroll 4
  for (int x = tid; x < d.H * q.h_cols; x += kThreads) {
    const int i = x / q.h_cols;
    const int c = x % q.h_cols;
    s.wh[x] = c < width ? q.w_out[(size_t)i * q.vocab + c0 + c] : 0.0f;
  }
  for (int c = tid; c < q.h_cols; c += kThreads)
    s.bh[c] = c < width ? q.b_out[c0 + c] : 0.0f;
  const int G = 4 * d.H;
  const int groups = (d.H + q.units - 1) / q.units;  // as in the G phase
  const int j0 = blockIdx.x % groups * q.units;
  float* wg = s.wg;
  for (int l = 0; l < q.layers; ++l) {
    const int n_in = l == 0 ? d.E : d.H;
    const int len = n_in + d.H;
#pragma unroll 4
    for (int x = tid; x < q.units * len * 4; x += kThreads) {
      const int i = x % len;
      const int g = (x / len) & 3;
      const int j = j0 + x / len / 4;
      float v = 0.0f;
      if (j < d.H) {
        const int col = g * d.H + j;
        v = i < n_in ? q.w_ih[l][(size_t)i * G + col]
                     : q.w_hh[l][(size_t)(i - n_in) * G + col];
      }
      wg[x] = v;
    }
    for (int x = tid; x < 4 * q.units; x += kThreads) {
      const int j = j0 + x / 4;
      s.bg[4 * q.units * l + x] = j < d.H ? q.b[l][(x & 3) * d.H + j] : 0.0f;
    }
    wg += (size_t)q.units * len * 4;
  }
}

// The tokens of the last step, for the CTA's rows (r % ctas == cta).
__device__ void resolve_rows(const Params& q, const Scratch& x, int t) {
  const int warp = threadIdx.x >> 5;
  for (int r = blockIdx.x + warp * q.ctas; r < q.batch;
       r += kWarps * q.ctas) {
    const int tok = best_candidate(x.cand_v, x.cand_i, q.ctas, r);
    if ((threadIdx.x & 31) == 0) q.tokens[(size_t)r * q.max_length + t] = tok;
  }
}

// Phase G_l: the gates of the CTA's hidden units in layer l for its part of
// the rows, then the LSTM tail. Row r's input is [in_r | h_in[r]], n_in + H
// wide: in_r is row r of `in` (x0 at step 0, h_{l-1}' above layer 0), or in
// layer 0 after step 0 the embedding of the token row r emitted at step
// t-1. h_in == nullptr is the zero state of step 0 (no h products, c = 0).
// Writes h_out[r] and c[r]. The split is gates_phase's: CTA p takes the
// units of group p % groups for rows part p / groups; a warp takes
// kNicGRows rows over a slice of the input (h first) for all the units at
// once; with few rows, several warps share a row group and their partial
// sums are added in warp order.
//
// The tokens (phase R, inside G_0): the first warp of each row group merges
// its rows' candidates (best_candidate) into s_tok, for the group's other
// warps, and the first unit group's CTAs record them. Each row's candidates
// are merged by every CTA that computes its gates, which costs less than a
// phase of its own and the grid barrier after it.
__device__ void nic_gates_phase(const Params& q, const Smem& s,
                                const Scratch& x, int* s_tok, int l, int t,
                                const float* in, const float* h_in, float* c,
                                float* h_out) {
  constexpr int kGR = kNicGRows;
  const StepDims& d = q.d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bsz = q.batch;
  const bool tokens = l == 0 && t > 0;
  const int n_in = l == 0 ? d.E : d.H;
  int off = 0;  // layer l's gate slice
  for (int k = 0; k < l; ++k) off += 4 * q.units * gate_len(q, k);
  const float* wg = s.wg + off;
  const float* bg = s.bg + 4 * q.units * l;
  const int len = n_in + d.H;
  const int groups = (d.H + q.units - 1) / q.units;
  const int parts = max(1, q.ctas / groups);
  if ((int)blockIdx.x >= groups * parts) return;  // the whole CTA
  const int j0 = (blockIdx.x % groups) * q.units;
  const int nu = min(q.units, d.H - j0);
  const int part = blockIdx.x / groups;
  const int r_lo = part * bsz / parts;
  const int nrows = (part + 1) * bsz / parts - r_lo;
  const int ng = (nrows + kGR - 1) / kGR;
  const int wpg = max(1, kWarps / max(ng, 1));           // warps per group
  const int gpp = kWarps / wpg;                          // groups per pass
  const int seg = ((len + wpg - 1) / wpg + 3) / 4 * 4;  // slice per warp
  for (int base = 0; base < ng; base += gpp) {
    // the tail's threads, one per (row, unit) of the pass, fetch c now, so
    // the loads overlap the products
    const int ty = tid < gpp * kGR * nu ? tid : -1;
    const int tu = tid % nu;
    const int tk = tid / nu;  // row of the pass: group tk / kGR
    const int trow = (base + tk / kGR) * kGR + tk % kGR;
    const bool tail = ty >= 0 && base + tk / kGR < ng && trow < nrows;
    float c_prev = 0.0f;
    if (tail && h_in != nullptr)
      c_prev = __ldcg(c + (size_t)(r_lo + trow) * d.H + j0 + tu);
    const int gi = base + warp / wpg;
    const bool active = warp < gpp * wpg && gi < ng;
    const int rows = min(kGR, nrows - gi * kGR);  // the real ones
    if (tokens) {
      if (active && warp % wpg == 0) {
        for (int k = 0; k < rows; ++k) {
          const int r = r_lo + gi * kGR + k;
          const int tok = best_candidate(x.cand_v, x.cand_i, q.ctas, r);
          if (lane == 0) {
            s_tok[(gi - base) * kGR + k] = tok;
            if (j0 == 0) q.tokens[(size_t)r * q.max_length + t - 1] = tok;
          }
        }
      }
      if (wpg > 1) {  // the same in every warp
        __syncthreads();
      } else {
        __syncwarp();
      }
    }
    if (active) {
      const int i0 = (warp % wpg) * seg;
      const int i1 = min(len, i0 + seg);
      int row[kGR];
      const float* src_k[kGR];
#pragma unroll
      for (int k = 0; k < kGR; ++k)
        row[k] = r_lo + min(gi * kGR + k, nrows - 1);
      float acc[kGUnits][kGR][4];
#pragma unroll
      for (int u = 0; u < kGUnits; ++u)
#pragma unroll
        for (int k = 0; k < kGR; ++k)
          acc[u][k][0] = acc[u][k][1] = acc[u][k][2] = acc[u][k][3] = 0.0f;
      int lo = max(i0, n_in), hi = i1;
      if (h_in != nullptr && lo < hi) {
#pragma unroll
        for (int k = 0; k < kGR; ++k)
          src_k[k] = h_in + (size_t)row[k] * d.H + (lo - n_in);
        gate_segment(wg, len, nu, lo, hi, lane, src_k, rows, acc);
      }
      lo = i0;
      hi = min(i1, n_in);
      if (lo < hi) {
#pragma unroll
        for (int k = 0; k < kGR; ++k) {
          const int src =
              tokens ? s_tok[(gi - base) * kGR + min(k, rows - 1)] : row[k];
          src_k[k] = in + (size_t)src * n_in + lo;
        }
        gate_segment(wg, len, nu, lo, hi, lane, src_k, rows, acc);
      }
#pragma unroll
      for (int u = 0; u < kGUnits; ++u) {
        if (u >= nu) break;
#pragma unroll
        for (int k = 0; k < kGR; ++k)
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float v = warp_sum(acc[u][k][g]);
            if (lane == 0)
              s.part[((warp * kGUnits + u) * kGR + k) * 4 + g] = v;
          }
      }
    }
    __syncthreads();
    if (tail) {
      const int gl = tk / kGR;
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float acc = 0.0f;
        for (int sl = 0; sl < wpg; ++sl)
          acc += s.part[(((gl * wpg + sl) * kGUnits + tu) * kGR +
                         tk % kGR) * 4 + g];
        gate[g] = acc + bg[4 * tu + g];
      }
      const float ig = sigmoid_f32(gate[0]);
      const float fg = sigmoid_f32(gate[1]);
      const float gg = tanhf(gate[2]);
      const float og = sigmoid_f32(gate[3]);
      const float c_new = fg * c_prev + ig * gg;
      const size_t at = (size_t)(r_lo + trow) * d.H + j0 + tu;
      c[at] = c_new;
      h_out[at] = og * tanhf(c_new);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
nic_greedy_kernel(const Params q) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve_smem(reinterpret_cast<float*>(smem_raw), q);
  int* s_tok = s.ci + q.h_rows * (q.h_cols / 4);  // [kTokSlots]
  const Scratch x = carve_scratch(q);
  const size_t bh = (size_t)q.batch * q.d.H;
  load_nic_slices(q, s);
  __syncthreads();  // load_nic_slices' writes, before the first phase
  const HOut out{nullptr, nullptr, x.cand_v, x.cand_i,
                 nullptr, nullptr, nullptr};
  const float* h_top = nullptr;
  for (int t = 0; t < q.max_length; ++t) {
    for (int l = 0; l < q.layers; ++l) {
      // layer l's h of step t-1 and of step t
      const float* h_prev =
          t == 0 ? nullptr : x.h + (2 * l + ((t - 1) & 1)) * bh;
      float* h_new = x.h + (2 * l + (t & 1)) * bh;
      const float* in = l > 0 ? h_top : t == 0 ? q.x0 : q.embed;
      nic_gates_phase(q, s, x, s_tok, l, t, in, h_prev, x.c + l * bh, h_new);
      h_top = h_new;
      grid_sync(q);
    }
    hproducts_phase<false>(q, s, out, h_top, q.batch, true);
    grid_sync(q);
  }
  resolve_rows(q, x, q.max_length - 1);
}

// The grid must be co-resident: the caller sizes it with max_ctas, and
// cudaLaunchCooperativeKernel refuses a larger one
// (cudaErrorCooperativeLaunchTooLarge).
cudaError_t launch(const Params& q, int smem, cudaStream_t stream) {
  if (q.layers < 1 || q.layers > kMaxLayers || q.d.E % 4 || q.d.H % 4 ||
      q.ctas < 1 || q.h_cols % 4 || q.units < 1 || q.units > kGUnits ||
      q.h_rows < kHRows || q.h_rows % kHRows)
    return cudaErrorInvalidValue;
  if (smem_floats(q) * (long)sizeof(float) > smem)
    return cudaErrorInvalidValue;  // the planner and the carve disagree
  const void* fn = reinterpret_cast<const void*>(nic_greedy_kernel);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(q.iscr, 0, 2 * sizeof(int), stream);  // the barrier
  if (err != cudaSuccess) return err;
  Params arg = q;
  void* args[] = {&arg};
  err = cudaLaunchCooperativeKernel(fn, dim3(q.ctas), dim3(kThreads), args,
                                    (size_t)smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int max_ctas(int smem) {
  const void* fn = reinterpret_cast<const void*>(nic_greedy_kernel);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        smem);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

}  // namespace nic
}  // namespace seq
}  // namespace dcap

// The number of CTAs that can be co-resident at `smem` bytes of dynamic
// shared memory (blocks per SM x SMs), or minus a cudaError_t.
extern "C" int dcap_nic_max_ctas(int smem) {
  return dcap::seq::nic::max_ctas(smem);
}

extern "C" int dcap_nic_greedy_decode(
    const float* x0, const float* w_ih0, const float* w_hh0, const float* b0,
    const float* w_ih1, const float* w_hh1, const float* b1,
    const float* w_ih2, const float* w_hh2, const float* b2,
    const float* w_ih3, const float* w_hh3, const float* b3,
    const float* w_out, const float* b_out, const float* embed, int* tokens,
    float* fscr, int* iscr, int batch, int layers, int e, int hdim,
    int vocab, int max_length, int ctas, int h_cols, int units, int h_rows,
    int smem, void* stream) {
  dcap::seq::nic::Params q{};
  q.d = dcap::StepDims{0, 0, 0, e, hdim};
  q.w_out = w_out;
  q.b_out = b_out;
  q.embed = embed;
  q.fscr = fscr;
  q.iscr = iscr;
  q.batch = batch;
  q.vocab = vocab;
  q.max_length = max_length;
  q.ctas = ctas;
  q.h_cols = h_cols;
  q.units = units;
  q.h_rows = h_rows;
  q.x0 = x0;
  const float* w_ih[] = {w_ih0, w_ih1, w_ih2, w_ih3};
  const float* w_hh[] = {w_hh0, w_hh1, w_hh2, w_hh3};
  const float* b[] = {b0, b1, b2, b3};
  for (int l = 0; l < dcap::seq::nic::kMaxLayers; ++l) {
    q.w_ih[l] = w_ih[l];
    q.w_hh[l] = w_hh[l];
    q.b[l] = b[l];
  }
  q.layers = layers;
  q.tokens = tokens;
  return static_cast<int>(
      dcap::seq::nic::launch(q, smem, static_cast<cudaStream_t>(stream)));
}
