// The phases of the persistent decode kernels: the one-step kernel
// (decode_step.cu), the greedy kernel (decode_seq.cu), the beam-search
// kernel (beam_seq.cu) and the NIC greedy kernel (nic_seq.cu: its own
// slice loader and a gate phase per LSTM layer on gate_segment) run them in
// one cooperative launch of one CTA per SM, with grid-wide barriers between
// them.
//
// Each CTA loads, once per launch and straight from the weight tensors, a
// column slice of two weight groups (load_slices):
//
//   h-products     [W_dec | W_fb | W_out], H x (A + D + V), input h:
//                  92 of the 12,132 columns per CTA at the main shape (the
//                  one-step kernel has no W_out: V = 0)
//   gate products  [W_ih_e; W_ih_c; W_hh], E + D + H rows, input
//                  [emb | gated | h]: the 4 columns (i, f, g, o) of 1 or 2
//                  whole hidden units, so the LSTM tail stays in the CTA
//
// and from then on reads each weight element from shared memory once per
// step for all the rows it serves:
//
//   attention_phase  (row, D-chunk) items: scores, softmax, the gated
//                    context (the greedy and the one-step kernel's)
//   gates_phase      the gates of the CTA's hidden units for its part of the
//                    rows, then the LSTM tail
//   hproducts_phase  the h-products of h': dec and gp for the next step, and
//                    the vocab columns as per-CTA (value, index) candidates
//                    (greedy) or as full logits rows (beam search)
//   best_candidate   a row's token from the CTAs' candidates
//
// A row map `src` (beam search) names the row whose h and c a row reads:
// the beams' reorder is an indirection, not a copy. Without one a row reads
// its own. Every sum has a fixed order and there is no float atomic, so
// repeated calls are bit-identical; the h- and gate-product dot products
// run inside one thread or one warp over their full length and do not
// depend on the number of CTAs. Plain C++ device code, no PyTorch headers.
#pragma once

#include "decode_step.cuh"

namespace dcap {
namespace seq {

constexpr int kThreads = 512;  // threads per CTA
constexpr int kHRows = 4;      // rows of a thread's h-product tile (x 4 cols)
constexpr int kGRows = 2;      // rows of a warp's gate products
//                                (the greedy kernel's; the phases take others)
constexpr int kGUnits = 2;     // most hidden units a CTA holds
constexpr int kWarps = kThreads / 32;

// What the phases read of a launch; the kernels' own parameters extend it.
struct PhaseParams {
  const void* feat;    // [B, K, D] f32 or bf16
  const float* proj;   // [B, K, A]
  const float* h0;     // [B, H]
  const float* c0;     // [B, H]
  StepWeights w;
  StepDims d;
  const float* w_out;  // [H, V]
  const float* b_out;  // [V]
  const float* embed;  // [V, E]
  float* fscr;         // float scratch, carved by the kernel
  int* iscr;           // int scratch: barrier (2), then the kernel's carve
  int batch, vocab, max_length, start_id, end_id;
  int ctas;            // grid size, every CTA co-resident
  int h_cols;          // h-product columns per CTA, padded to a multiple of 4
  int units;           // hidden units per CTA, at most kGUnits
  int a_chunk;         // feature columns per attention item, a multiple of 8
  int h_rows;          // rows per h-product tile, a multiple of the
                       // phase's rows per thread
};

// The CTA's shared memory; each kernel carves it to its own sizes.
struct Smem {
  float* wh;     // [H, h_cols]      h-product slice
  float* wg;     // [units, 4, E+D+H] gate-product slice, planes i, f, g, o
  float* ht;     // [h_rows, H + 4]  h tile
  float* part;   // partial sums
  float* wfull;  // [A]
  float* dec;    // attention: the item's rows of dec
  float* bh;     // [h_cols]     the biases of the h-product columns
  float* bg;     // [units, 4]   the gate biases of the CTA's units
  float* cv;     // [h_rows, h_cols/4] head candidates: value (greedy)
  int* ci;       //                    and index
  float* alpha;  // attention: scores, then softmax weights
  float* red;    // [kWarps] (x rows) reduction scratch
};

// Where hproducts_phase writes: dec [rows, A] and gp [rows, D] always; the
// vocab columns as candidates cand_v/cand_i [rows, ctas], or as logits
// [rows, V] with each row's (max, sum of exp(x - max)) over the CTA's
// vocab columns in part_m/part_l [rows, ctas].
struct HOut {
  float* dec;
  float* gp;
  float* cand_v;
  int* cand_i;
  float* logits;
  float* part_m;
  float* part_l;
};

// Grid-wide barrier on a counter and a generation word in global memory
// (iscr[0], iscr[1]); safe because the cooperative launch makes every CTA
// co-resident. The counter starts at 0 and is 0 again after every barrier.
// Thread 0 fences for the CTA after __syncthreads (fences are cumulative)
// and spins on the generation word.
__device__ __forceinline__ void grid_sync(const PhaseParams& q) {
  int* bar = q.iscr;
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile int* gen = bar + 1;
    const int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1) == q.ctas - 1) {
      atomicExch(bar, 0);
      __threadfence();
      atomicAdd(bar + 1, 1);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// 16 bytes of features as floats: 4 f32 or 8 bf16 (upcast exactly), read
// evict-first, so that the stream does not push the scratch out of L2
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[m]));
    v[2 * m] = f.x;
    v[2 * m + 1] = f.y;
  }
}

// (v, i) beats (best, best_i): larger value, or lower index on equal values
__device__ __forceinline__ bool beats(float v, int i, float best,
                                      int best_i) {
  return v > best || (v == best && i < best_i);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Row r's best (value, index) over the CTAs' head candidates cand_v/cand_i
// [rows, ctas], merged by one warp in a fixed order: every lane gets the
// index, and every warp that merges the row gets the same one. A lane loads
// up to 8 candidates before it compares, so the loads are in flight
// together.
__device__ __forceinline__ int best_candidate(const float* cand_v,
                                              const int* cand_i, int ctas,
                                              int r) {
  constexpr int kPerLane = 8;
  const int lane = threadIdx.x & 31;
  float v = -INFINITY;
  int vi = INT_MAX;
  for (int p0 = 0; p0 < ctas; p0 += 32 * kPerLane) {
    float cv[kPerLane];
    int ci[kPerLane];
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) {
      const int p = p0 + 32 * m + lane;
      const bool in = p < ctas;
      cv[m] = in ? __ldcg(cand_v + (size_t)r * ctas + p) : -INFINITY;
      ci[m] = in ? __ldcg(cand_i + (size_t)r * ctas + p) : INT_MAX;
    }
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) {
      if (beats(cv[m], ci[m], v, vi)) {
        v = cv[m];
        vi = ci[m];
      }
    }
  }
  warp_best(v, vi);
  return vi;
}

template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kWarps; ++i) r = kMax ? fmaxf(r, red[i]) : r + red[i];
  __syncthreads();
  return r;
}

// Load the CTA's weight slices into shared memory (once per launch).
__device__ inline void load_slices(const PhaseParams& q, const Smem& s) {
  const StepDims& d = q.d;
  const int tid = threadIdx.x;
  const long nc = (long)d.A + d.D + q.vocab;
  const long c0 = (long)blockIdx.x * nc / q.ctas;
  const int width = (int)((long)(blockIdx.x + 1) * nc / q.ctas - c0);
#pragma unroll 4
  for (int x = tid; x < d.H * q.h_cols; x += kThreads) {
    const int i = x / q.h_cols;
    const int c = x % q.h_cols;
    const long gc = c0 + c;
    float v = 0.0f;
    if (c < width) {
      if (gc < d.A) v = q.w.w_dec[(size_t)i * d.A + gc];
      else if (gc < d.A + d.D) v = q.w.w_fb[(size_t)i * d.D + (gc - d.A)];
      else v = q.w_out[(size_t)i * q.vocab + (gc - d.A - d.D)];
    }
    s.wh[x] = v;
  }
  for (int c = tid; c < q.h_cols; c += kThreads) {
    const long gc = c0 + c;
    float v = 0.0f;
    if (c < width) {
      if (gc < d.A) v = q.w.b_dec[gc];
      else if (gc < d.A + d.D) v = q.w.b_fb[gc - d.A];
      else v = q.b_out[gc - d.A - d.D];
    }
    s.bh[c] = v;
  }
  const int len = d.E + d.D + d.H;
  const int G = 4 * d.H;
  const int groups = (d.H + q.units - 1) / q.units;  // as in gates_phase
#pragma unroll 4
  for (int x = tid; x < q.units * len * 4; x += kThreads) {
    const int i = x % len;
    const int g = (x / len) & 3;
    const int j = blockIdx.x % groups * q.units + x / len / 4;
    float v = 0.0f;
    if (j < d.H) {
      const int col = g * d.H + j;
      if (i < d.E) v = q.w.w_ih_e[(size_t)i * G + col];
      else if (i < d.E + d.D) v = q.w.w_ih_c[(size_t)(i - d.E) * G + col];
      else v = q.w.w_hh[(size_t)(i - d.E - d.D) * G + col];
    }
    s.wg[x] = v;
  }
  for (int x = tid; x < 4 * q.units; x += kThreads) {
    const int j = blockIdx.x % groups * q.units + x / 4;
    s.bg[x] = j < d.H ? q.w.b_lstm[(x & 3) * d.H + j] : 0.0f;
  }
  for (int a = tid; a < d.A; a += kThreads) s.wfull[a] = q.w.w_full[a];
}

// Phase A: (row, D-chunk) items over the CTAs, on phase H's dec_in [B, A]
// and gp_in [B, D]: each item computes its row's scores over K, an f32
// softmax, the context over its chunk of D (features upcast exactly) and
// gated = sigmoid(gp) * ctx into gated [B, D]. With alpha_out, the item of
// each row's first chunk also writes the row's softmax weights [B, K].
template <typename FT>
__device__ void attention_phase(const PhaseParams& q, const Smem& s,
                                const float* dec_in, const float* gp_in,
                                float* gated, float* alpha_out,
                                const FT* feat, const float* proj, int bsz) {
  const StepDims& d = q.d;
  const int tid = threadIdx.x;
  const int chunks = (d.D + q.a_chunk - 1) / q.a_chunk;
  const float b_full = q.w.b_full[0];
  // scores: `parts` adjacent lanes per region, each over every parts-th
  // float4 of A, summed by shuffles in a fixed order
  int parts = 1;
  while (parts < 32 && 2 * parts * d.K <= kThreads) parts *= 2;
  const int a4 = d.A / 4;
  const float4* dec4 = reinterpret_cast<const float4*>(s.dec);
  const float4* wf4 = reinterpret_cast<const float4*>(s.wfull);
  for (int item = blockIdx.x; item < bsz * chunks; item += q.ctas) {
    const int r = item / chunks;
    const int d0 = (item % chunks) * q.a_chunk;
    const int wd = min(q.a_chunk, d.D - d0);
    for (int a = tid; a < d.A; a += kThreads)
      s.dec[a] = __ldcg(dec_in + (size_t)r * d.A + a);
    __syncthreads();
    for (int k0 = 0; k0 < d.K; k0 += kThreads / parts) {
      const int k = k0 + tid / parts;
      const int part = tid % parts;
      float acc = 0.0f;
      if (k < d.K) {
        const float4* pk =
            reinterpret_cast<const float4*>(proj + ((size_t)r * d.K + k) * d.A);
#pragma unroll 8
        for (int a = part; a < a4; a += parts) {
          const float4 p = pk[a];
          const float4 dv = dec4[a];
          const float4 wv = wf4[a];
          acc += fmaxf(p.x + dv.x, 0.0f) * wv.x;
          acc += fmaxf(p.y + dv.y, 0.0f) * wv.y;
          acc += fmaxf(p.z + dv.z, 0.0f) * wv.z;
          acc += fmaxf(p.w + dv.w, 0.0f) * wv.w;
        }
      }
      for (int o = parts / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (k < d.K && part == 0) s.alpha[k] = acc + b_full;
    }
    __syncthreads();
    // softmax over K in f32
    float m = -INFINITY;
    for (int k = tid; k < d.K; k += kThreads) m = fmaxf(m, s.alpha[k]);
    m = block_reduce<true>(m, s.red);
    float sum = 0.0f;
    for (int k = tid; k < d.K; k += kThreads) {
      const float ex = expf(s.alpha[k] - m);
      s.alpha[k] = ex;
      sum += ex;
    }
    sum = block_reduce<false>(sum, s.red);
    for (int k = tid; k < d.K; k += kThreads) {
      const float al = s.alpha[k] / sum;
      s.alpha[k] = al;
      if (alpha_out != nullptr && d0 == 0)
        alpha_out[(size_t)r * d.K + k] = al;
    }
    __syncthreads();
    // ctx over the chunk: 16 bytes of adjacent columns per thread (kVec);
    // with fewer column groups than threads, K is cut into slices whose
    // partial sums meet in a fixed pairwise tree
    constexpr int kVec = 16 / sizeof(FT);
    const int groups = wd / kVec;
    const int slices = groups >= kThreads ? 1 : kThreads / groups;
    const int rows = (d.K + slices - 1) / slices;
    const FT* fr = feat + (size_t)r * d.K * d.D + d0;
    const float* gpr = gp_in + (size_t)r * d.D + d0;
    float* out = gated + (size_t)r * d.D + d0;
    for (int g = tid % groups, sl = tid / groups; sl < slices && g < groups;
         g += (slices == 1 ? kThreads : groups)) {
      const int k0 = slices == 1 ? 0 : sl * rows;
      const int k1 = slices == 1 ? d.K : min(d.K, k0 + rows);
      float acc[kVec];
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[c] = 0.0f;
      const FT* col = fr + kVec * g;
#pragma unroll 8
      for (int k = k0; k < k1; ++k) {
        const float al = s.alpha[k];
        float f[kVec];
        load16(col + (size_t)k * d.D, f);
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[c] += al * f[c];
      }
      if (slices == 1) {
#pragma unroll
        for (int c = 0; c < kVec; c += 4) {
          const float4 gp =
              __ldcg(reinterpret_cast<const float4*>(gpr + kVec * g + c));
          *reinterpret_cast<float4*>(out + kVec * g + c) = make_float4(
              sigmoid_f32(gp.x) * acc[c], sigmoid_f32(gp.y) * acc[c + 1],
              sigmoid_f32(gp.z) * acc[c + 2], sigmoid_f32(gp.w) * acc[c + 3]);
        }
      } else {
        float* dst = s.part + (size_t)sl * wd + kVec * g;
#pragma unroll
        for (int c = 0; c < kVec; c += 4)
          *reinterpret_cast<float4*>(dst + c) =
              make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
        break;  // a sliced thread owns one column group
      }
    }
    if (slices > 1) {
      __syncthreads();
      for (int st = 1 << (31 - __clz(slices - 1)); st > 0; st >>= 1) {
        for (int y = tid; y < st * wd; y += kThreads) {
          const int sl = y / wd;
          if (sl + st < slices) s.part[y] += s.part[y + st * wd];
        }
        __syncthreads();
      }
      for (int j = tid; j < wd; j += kThreads)
        out[j] = sigmoid_f32(__ldcg(gpr + j)) * s.part[j];
    }
    __syncthreads();
  }
}

// Phase H: the h-products of h_in [bsz, H] for every row, tile by tile.
// Writes dec and gp for the next step and, with `head`, the CTA's vocab
// columns: each row's best (value, index) over them into
// cand_v/cand_i[:, cta], or with kFullLogits the logits themselves and each
// row's (max, sum of exp) over them into part_m/part_l[:, cta] (s.cv and
// s.ci, read as floats, hold the thread partials).
// A thread takes kHR rows x 4 columns, 4 steps of H at a time (the h tile's
// rows are a multiple of kHR); when the tile has fewer such items than the
// CTA has threads, S adjacent lanes split the H sum of an item and meet by
// shuffles in a fixed order.
template <bool kFullLogits, int kHR = kHRows>
__device__ void hproducts_phase(const PhaseParams& q, const Smem& s,
                                const HOut& o, const float* h_in, int bsz,
                                bool head) {
  const StepDims& d = q.d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long nc = (long)d.A + d.D + q.vocab;
  const long c0 = (long)blockIdx.x * nc / q.ctas;
  const int width = (int)((long)(blockIdx.x + 1) * nc / q.ctas - c0);
  const int ncg = q.h_cols / 4;
  const int ldh = d.H + 4;  // padded rows of the h tile
  const bool cands = head && !kFullLogits;
  const float4* wh4 = reinterpret_cast<const float4*>(s.wh);
  for (int r0 = 0; r0 < bsz; r0 += q.h_rows) {
    const int rt = min(q.h_rows, bsz - r0);
    const int rt4 = (rt + kHR - 1) / kHR * kHR;
    // coalesced 16-byte loads into padded rows
    const int n4 = rt4 * d.H / 4;
#pragma unroll 4
    for (int y = tid; y < n4; y += kThreads) {
      const int rr = y / (d.H / 4);
      *reinterpret_cast<float4*>(s.ht + rr * ldh + 4 * (y % (d.H / 4))) =
          rr < rt ? __ldcg(reinterpret_cast<const float4*>(
                        h_in + (size_t)(r0 + rr) * d.H) + y % (d.H / 4))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    const int items = (rt4 / kHR) * ncg;
    int S = 1;
    while (S < 32 && 2 * S * items <= kThreads && 8 * S <= d.H) S *= 2;
    for (int z0 = 0; z0 < items * S; z0 += kThreads) {
      const int z = z0 + tid;
      const int item = z / S;
      const int part = z % S;
      const bool active = item < items;
      const int rg = active ? item / ncg : 0;
      const int cg = active ? item % ncg : 0;
      float acc[kHR][4];
#pragma unroll
      for (int a = 0; a < kHR; ++a)
        acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.0f;
      if (active) {
        const float* hrow = s.ht + kHR * rg * ldh;
#pragma unroll 2
        for (int i = 4 * part; i < d.H; i += 4 * S) {
          float4 w[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) w[m] = wh4[(i + m) * ncg + cg];
#pragma unroll
          for (int a = 0; a < kHR; ++a) {
            const float4 h4 =
                *reinterpret_cast<const float4*>(hrow + a * ldh + i);
            const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
            for (int m = 0; m < 4; ++m) {  // one FMA per product
              acc[a][0] = fmaf(hv[m], w[m].x, acc[a][0]);
              acc[a][1] = fmaf(hv[m], w[m].y, acc[a][1]);
              acc[a][2] = fmaf(hv[m], w[m].z, acc[a][2]);
              acc[a][3] = fmaf(hv[m], w[m].w, acc[a][3]);
            }
          }
        }
      }
      for (int off = S / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int a = 0; a < kHR; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[a][b] += __shfl_xor_sync(0xffffffffu, acc[a][b], off);
      }
      if (!active || part != 0) continue;
      float best[kHR];  // kFullLogits: the max over the vocab columns
      int best_i[kHR];
#pragma unroll
      for (int a = 0; a < kHR; ++a) {
        best[a] = -INFINITY;
        best_i[a] = INT_MAX;
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = 4 * cg + b;
        if (c >= width) break;
        const long gc = c0 + c;
        const float bias = s.bh[c];
        if (gc < d.A) {
#pragma unroll
          for (int a = 0; a < kHR; ++a) {
            const int r = kHR * rg + a;
            if (r < rt) o.dec[(size_t)(r0 + r) * d.A + gc] = acc[a][b] + bias;
          }
        } else if (gc < d.A + d.D) {
          const int j = (int)(gc - d.A);
#pragma unroll
          for (int a = 0; a < kHR; ++a) {
            const int r = kHR * rg + a;
            if (r < rt) o.gp[(size_t)(r0 + r) * d.D + j] = acc[a][b] + bias;
          }
        } else if (head) {
          const int v = (int)(gc - d.A - d.D);
          if (kFullLogits) {
#pragma unroll
            for (int a = 0; a < kHR; ++a) {
              const int r = kHR * rg + a;
              const float val = acc[a][b] + bias;
              if (r < rt) o.logits[(size_t)(r0 + r) * q.vocab + v] = val;
              best[a] = fmaxf(best[a], val);
            }
          } else {
            // columns in increasing order: a strict > keeps the lowest index
#pragma unroll
            for (int a = 0; a < kHR; ++a) {
              const float val = acc[a][b] + bias;
              if (val > best[a] || best_i[a] == INT_MAX) {
                best[a] = val;
                best_i[a] = v;
              }
            }
          }
        }
      }
      if (cands) {
#pragma unroll
        for (int a = 0; a < kHR; ++a) {
          s.cv[(kHR * rg + a) * ncg + cg] = best[a];
          s.ci[(kHR * rg + a) * ncg + cg] = best_i[a];
        }
      } else if (kFullLogits && head) {
        // the sum of exp(x - max) over the same columns
        float lsum[kHR];
#pragma unroll
        for (int a = 0; a < kHR; ++a) lsum[a] = 0.0f;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = 4 * cg + b;
          if (c >= width) break;
          if (c0 + c < d.A + d.D) continue;
          const float bias = s.bh[c];
#pragma unroll
          for (int a = 0; a < kHR; ++a)
            lsum[a] += expf(acc[a][b] + bias - best[a]);
        }
        float* sl = reinterpret_cast<float*>(s.ci);
#pragma unroll
        for (int a = 0; a < kHR; ++a) {
          s.cv[(kHR * rg + a) * ncg + cg] = best[a];
          sl[(kHR * rg + a) * ncg + cg] = lsum[a];
        }
      }
    }
    __syncthreads();
    if (kFullLogits && head) {
      // each row's (max, sum of exp) over the CTA's columns from the column
      // groups': the max, then the sums rescaled to it, in a fixed order
      const float* sl = reinterpret_cast<const float*>(s.ci);
      for (int rr = warp; rr < rt; rr += kWarps) {
        float m = -INFINITY;
        for (int cg = lane; cg < ncg; cg += 32)
          m = fmaxf(m, s.cv[rr * ncg + cg]);
        m = warp_max(m);
        float l = 0.0f;
        for (int cg = lane; cg < ncg; cg += 32) {
          const float mg = s.cv[rr * ncg + cg];
          if (mg != -INFINITY) l += sl[rr * ncg + cg] * expf(mg - m);
        }
        l = warp_sum(l);
        if (lane == 0) {
          o.part_m[(size_t)(r0 + rr) * q.ctas + blockIdx.x] = m;
          o.part_l[(size_t)(r0 + rr) * q.ctas + blockIdx.x] = l;
        }
      }
      __syncthreads();
    }
    if (cands) {
      for (int rr = warp; rr < rt; rr += kWarps) {
        float v = -INFINITY;
        int vi = INT_MAX;
        for (int cg = lane; cg < ncg; cg += 32) {
          const float cv = s.cv[rr * ncg + cg];
          const int ci = s.ci[rr * ncg + cg];
          if (beats(cv, ci, v, vi)) {
            v = cv;
            vi = ci;
          }
        }
        warp_best(v, vi);
        if (lane == 0) {
          o.cand_v[(size_t)(r0 + rr) * q.ctas + blockIdx.x] = v;
          o.cand_i[(size_t)(r0 + rr) * q.ctas + blockIdx.x] = vi;
        }
      }
      __syncthreads();
    }
  }
}

// Rows of one gate-product segment for every unit the CTA owns:
// acc[u][k][g] += x_k[i] w[u][g][i] for i in [lo, hi), a lane taking 4
// adjacent i: one 16-byte load per row, and one per unit and gate plane
// (adjacent lanes on adjacent 16 bytes: no bank conflict).
template <int kGR>
__device__ __forceinline__ void gate_segment(
    const float* __restrict__ wg, int len, int units, int lo, int hi,
    int lane, const float* const (&src)[kGR], int rows,
    float (&acc)[kGUnits][kGR][4]) {
#pragma unroll 2
  for (int i = lo + 4 * lane; i < hi; i += 128) {
    float4 xv[kGR];
#pragma unroll
    for (int k = 0; k < kGR; ++k)
      xv[k] = k < rows ? __ldcg(reinterpret_cast<const float4*>(src[k] + i - lo))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < kGUnits; ++u) {
      if (u >= units) break;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 w =
            *reinterpret_cast<const float4*>(wg + (u * 4 + g) * len + i);
#pragma unroll
        for (int k = 0; k < kGR; ++k) {  // one FMA per product
          float a = fmaf(xv[k].x, w.x, acc[u][k][g]);
          a = fmaf(xv[k].y, w.y, a);
          a = fmaf(xv[k].z, w.z, a);
          acc[u][k][g] = fmaf(xv[k].w, w.w, a);
        }
      }
    }
  }
}

// Phase G: the gates of the CTA's hidden units for its part of the rows,
// then the LSTM tail. Row r's input is [embed[tok[r]] | gated[r] | h_in[m]]
// and its cell c_in[m], where m = src[r] with kRowMap, else r; it writes
// h_out[r], c_out[r] (c_out may be c_in when m = r). CTA p takes the units
// of group p % groups (units per CTA, groups = ceil(H / units)) for rows
// part p / groups of max(1, ctas / groups) parts, so each row's input is
// read by `groups` CTAs. A warp takes kGR rows over a slice of the input
// (in the order gated, h, emb, so the token load is in flight under the
// first two) for all the units at once; with few rows, several warps share
// a row group and their partial sums are added in warp order.
template <bool kRowMap, int kGR = kGRows>
__device__ void gates_phase(const PhaseParams& q, const Smem& s,
                            const float* gated, const int* tok_in,
                            const int* src, const float* h_in,
                            const float* c_in, float* h_out, float* c_out,
                            int bsz) {
  const StepDims& d = q.d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = d.E + d.D + d.H;
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
    if (tail) {
      const int m = kRowMap ? __ldcg(src + r_lo + trow) : r_lo + trow;
      c_prev = __ldcg(c_in + (size_t)m * d.H + j0 + tu);
    }
    const int gi = base + warp / wpg;
    if (warp < gpp * wpg && gi < ng) {
      const int i0 = (warp % wpg) * seg;
      const int i1 = min(len, i0 + seg);
      const int rows = min(kGR, nrows - gi * kGR);  // the real ones
      int row[kGR], tok[kGR], hrow[kGR];
      const float* src_k[kGR];
#pragma unroll
      for (int k = 0; k < kGR; ++k) {
        row[k] = r_lo + min(gi * kGR + k, nrows - 1);
        tok[k] = __ldcg(tok_in + row[k]);
        hrow[k] = kRowMap ? __ldcg(src + row[k]) : row[k];
      }
      float acc[kGUnits][kGR][4];
#pragma unroll
      for (int u = 0; u < kGUnits; ++u)
#pragma unroll
        for (int k = 0; k < kGR; ++k)
          acc[u][k][0] = acc[u][k][1] = acc[u][k][2] = acc[u][k][3] = 0.0f;
      int lo = max(i0, d.E), hi = min(i1, d.E + d.D);
#pragma unroll
      for (int k = 0; k < kGR; ++k)
        src_k[k] = gated + (size_t)row[k] * d.D + (lo - d.E);
      if (lo < hi) gate_segment(s.wg, len, nu, lo, hi, lane, src_k, rows, acc);
      lo = max(i0, d.E + d.D);
      hi = i1;
#pragma unroll
      for (int k = 0; k < kGR; ++k)
        src_k[k] = h_in + (size_t)hrow[k] * d.H + (lo - d.E - d.D);
      if (lo < hi) gate_segment(s.wg, len, nu, lo, hi, lane, src_k, rows, acc);
      lo = i0;
      hi = min(i1, d.E);
#pragma unroll
      for (int k = 0; k < kGR; ++k)
        src_k[k] = q.embed + (size_t)tok[k] * d.E + lo;
      if (lo < hi) gate_segment(s.wg, len, nu, lo, hi, lane, src_k, rows, acc);
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
        gate[g] = acc + s.bg[4 * tu + g];
      }
      const float ig = sigmoid_f32(gate[0]);
      const float fg = sigmoid_f32(gate[1]);
      const float gg = tanhf(gate[2]);
      const float og = sigmoid_f32(gate[3]);
      const float c_new = fg * c_prev + ig * gg;
      const size_t at = (size_t)(r_lo + trow) * d.H + j0 + tu;
      c_out[at] = c_new;
      h_out[at] = og * tanhf(c_new);
    }
    __syncthreads();
  }
}

}  // namespace seq
}  // namespace dcap
