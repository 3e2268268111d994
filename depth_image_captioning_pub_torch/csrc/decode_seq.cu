// Whole-sequence greedy caption decode in ONE cooperative launch: a
// persistent grid of one CTA per SM, the time loop inside the launch, and
// the decoder's weights resident in shared memory, split by columns.
//
// Replaces the TPU kernel
// depth_image_captioning_pub_tpu/ops/pallas/decode_seq.py::fused_greedy_decode
// (pallas_call body `_make_kernel`). For t < max_length:
//
//   dec    = h W_dec + b_dec,  gp = h W_fb + b_fb            [B, A], [B, D]
//   alpha  = softmax_K(relu(proj + dec) w_full + b_full)     [B, K]
//   gated  = sigmoid(gp) * (alpha F)                         [B, D]
//   gates  = emb W_ih_e + gated W_ih_c + h W_hh + b          [B, 4H]
//   h', c' = LSTM tail, gate order i, f, g, o                [B, H]
//   token  = argmax(h' W_out + b_out), lowest index on ties  [B]
//   emb    = embed[token]
//
// Each CTA loads, once per launch and straight from the weight tensors, a
// column slice of two weight groups:
//
//   h-products     [W_dec | W_fb | W_out], H x (A + D + V), input h:
//                  92 of the 12,132 columns per CTA at the main shape
//   gate products  [W_ih_e; W_ih_c; W_hh], E + D + H rows, input
//                  [emb | gated | h]: the 4 columns (i, f, g, o) of 1 or 2
//                  whole hidden units, so the LSTM tail stays in the CTA
//
// and from then on reads each weight element from shared memory once per
// step for all the rows it serves. A step is three phases between grid
// barriers:
//
//   A  the token of step t-1 for the CTA's own rows (the best of the CTAs'
//      head candidates), then (row, D-chunk) items over all CTAs: scores,
//      an f32 softmax over K, the context over the chunk (features upcast
//      exactly) and gated, into a [B, D] scratch
//   G  the gates of the CTA's hidden units for its part of the rows (with
//      2 units per CTA, 64 unit groups x 2 row parts), and the LSTM tail
//   H  the h-products of h': per row the best (value, index) of the CTA's
//      logit columns into a [B, CTAs] scratch, and dec, gp for step t+1
//
// Every sum runs in a fixed order and there is no float atomic, so repeated
// calls give identical tokens. The h- and gate-product dot products run
// inside one thread or one warp over their full length: they do not depend
// on the number of CTAs. <end>: a row that emitted end_id keeps emitting it;
// after the A phase that leaves every row done, each CTA fills its rows'
// remaining slots with end_id and the whole grid leaves the loop (every CTA
// reads the same flags, written before the barrier). end_id < 0 runs every
// step.
//
// What bounds it on an H100 (tools/decode_seq_ab.py's phase trace): phase
// A streams the features once per step (B x K x D bf16, 51 MB at B=64,
// above the 50 MB L2; read evict-first), near the HBM rate at B=64; the
// rest of a step is latency: every CTA of a phase reads the same freshly
// written rows from L2 (the inputs of G, the h tile of H, one row's proj
// at small B), and three grid barriers of ~1.3 us. Decoding the rows in
// groups, so that a group's features stay in L2, measured slower: every
// step's latency is paid once per group.
//
// The phases are device functions (attention_phase, gates_phase,
// hproducts_phase) for the other decode kernels to take up. The planner in
// ops/kernels/decode_seq.py sizes the slices, the row tile and the shared
// memory; the launcher checks the carve against it. Plain C interface,
// loaded with ctypes (ops/kernels/_build.py). Build without --use_fast_math.
#include "decode_step.cuh"

namespace dcap {
namespace greedy {

constexpr int kThreads = 512;  // threads per CTA
constexpr int kHRows = 4;      // rows of a thread's h-product tile (x 4 cols)
constexpr int kGRows = 2;      // rows of a warp's gate products
constexpr int kGUnits = 2;     // most hidden units a CTA holds
constexpr int kWarps = kThreads / 32;

struct Params {
  const void* feat;    // [B, K, D] f32 or bf16
  const float* proj;   // [B, K, A]
  const float* h0;     // [B, H]
  const float* c0;     // [B, H]
  StepWeights w;
  StepDims d;
  const float* w_out;  // [H, V]
  const float* b_out;  // [V]
  const float* embed;  // [V, E]
  int* tokens;         // [B, max_length]
  float* fscr;         // float scratch, carved by carve_scratch
  int* iscr;           // int scratch: barrier (2), then carve_scratch
  int batch, vocab, max_length, start_id, end_id;
  int ctas;            // grid size, every CTA co-resident
  int h_cols;          // h-product columns per CTA, padded to a multiple of 4
  int units;           // hidden units per CTA, at most kGUnits
  int a_chunk;         // feature columns per attention item, a multiple of 8
  int h_rows;          // rows per h-product tile, a multiple of kHRows
};

// Shared memory in floats; the same sum as ops/kernels/decode_seq.plan.
__host__ __device__ inline long smem_floats(const Params& q) {
  const StepDims& d = q.d;
  return (long)d.H * q.h_cols + (long)q.units * (d.E + d.D + d.H) * 4 +
         (long)q.h_rows * (d.H + 4) + 8L * kThreads +
         2L * q.h_rows * (q.h_cols / 4) + q.h_cols + 4L * q.units + 2L * d.A +
         d.K + kWarps;
}

struct Smem {
  float* wh;     // [H, h_cols]      h-product slice
  float* wg;     // [units, 4, E+D+H] gate-product slice, planes i, f, g, o
  float* ht;     // [h_rows, H + 4]  h tile
  float* part;   // [8 * kThreads] partial sums
  float* wfull;  // [A]
  float* dec;    // [A]  an attention item's row of dec
  float* bh;     // [h_cols]     the biases of the h-product columns
  float* bg;     // [units, 4]   the gate biases of the CTA's units
  float* cv;     // [h_rows, h_cols/4] head candidates: value
  int* ci;       //                    and index
  float* alpha;  // [K]
  float* red;    // [kWarps]
};

__device__ inline Smem carve_smem(float* base, const Params& q) {
  const StepDims& d = q.d;
  Smem s;
  s.wh = base;
  s.wg = s.wh + (size_t)d.H * q.h_cols;
  s.ht = s.wg + (size_t)q.units * (d.E + d.D + d.H) * 4;
  // float4-read arrays first: every size before them is a multiple of 4
  s.part = s.ht + (size_t)q.h_rows * (d.H + 4);
  s.wfull = s.part + 8 * kThreads;
  s.dec = s.wfull + d.A;
  s.bh = s.dec + d.A;
  s.bg = s.bh + q.h_cols;
  s.cv = s.bg + 4 * q.units;
  s.ci = reinterpret_cast<int*>(s.cv + q.h_rows * (q.h_cols / 4));
  s.alpha = reinterpret_cast<float*>(s.ci + q.h_rows * (q.h_cols / 4));
  s.red = s.alpha + d.K;
  return s;
}

// Scratch in global memory, written and read by different CTAs (read with
// __ldcg: L1 is not coherent across SMs): B * (2D + A + 3H + ctas) floats,
// 2 + B * (ctas + 2) ints.
struct Scratch {
  float* gated;   // [B, D]
  float* dec;     // [B, A]
  float* gp;      // [B, D]  h W_fb + b_fb
  float* h;       // [2, B, H]
  float* c;       // [B, H]
  float* cand_v;  // [B, ctas]
  int* cand_i;    // [B, ctas]
  int* tok;       // [B]  the token fed to the next step
  int* done;      // [B]
};

__device__ inline Scratch carve_scratch(const Params& q) {
  const long g = q.batch;
  Scratch x;
  x.gated = q.fscr;
  x.dec = x.gated + g * q.d.D;
  x.gp = x.dec + g * q.d.A;
  x.h = x.gp + g * q.d.D;
  x.c = x.h + 2 * g * q.d.H;
  x.cand_v = x.c + g * q.d.H;
  x.cand_i = q.iscr + 2;
  x.tok = x.cand_i + g * q.ctas;
  x.done = x.tok + g;
  return x;
}

// Grid-wide barrier on a counter and a generation word in global memory
// (iscr[0], iscr[1]); safe because the cooperative launch makes every CTA
// co-resident. The counter starts at 0 and is 0 again after every barrier.
// Thread 0 fences for the CTA after __syncthreads (fences are cumulative)
// and spins on the generation word.
__device__ __forceinline__ void grid_sync(const Params& q) {
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
__device__ void load_slices(const Params& q, const Smem& s) {
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

// Phase H: the h-products of h_in [bsz, H] for every row, tile by tile.
// Writes dec and gp for the next step and, with `logits`, each row's best
// (value, index) over the CTA's logit columns into cand_v/cand_i[:, cta].
// A thread takes kHRows rows x 4 columns, 4 steps of H at a time; when the
// tile has fewer such items than the CTA has threads, S adjacent lanes
// split the H sum of an item and meet by shuffles in a fixed order.
__device__ void hproducts_phase(const Params& q, const Smem& s,
                                const Scratch& x, const float* h_in,
                                int bsz, bool logits) {
  const StepDims& d = q.d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long nc = (long)d.A + d.D + q.vocab;
  const long c0 = (long)blockIdx.x * nc / q.ctas;
  const int width = (int)((long)(blockIdx.x + 1) * nc / q.ctas - c0);
  const int ncg = q.h_cols / 4;
  const int ldh = d.H + 4;  // padded rows of the h tile
  const float4* wh4 = reinterpret_cast<const float4*>(s.wh);
  for (int r0 = 0; r0 < bsz; r0 += q.h_rows) {
    const int rt = min(q.h_rows, bsz - r0);
    const int rt4 = (rt + kHRows - 1) / kHRows * kHRows;
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
    const int items = (rt4 / kHRows) * ncg;
    int S = 1;
    while (S < 32 && 2 * S * items <= kThreads && 8 * S <= d.H) S *= 2;
    for (int z0 = 0; z0 < items * S; z0 += kThreads) {
      const int z = z0 + tid;
      const int item = z / S;
      const int part = z % S;
      const bool active = item < items;
      const int rg = active ? item / ncg : 0;
      const int cg = active ? item % ncg : 0;
      float acc[kHRows][4];
#pragma unroll
      for (int a = 0; a < kHRows; ++a)
        acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.0f;
      if (active) {
        const float* hrow = s.ht + kHRows * rg * ldh;
#pragma unroll 2
        for (int i = 4 * part; i < d.H; i += 4 * S) {
          float4 w[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) w[m] = wh4[(i + m) * ncg + cg];
#pragma unroll
          for (int a = 0; a < kHRows; ++a) {
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
      for (int o = S / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int a = 0; a < kHRows; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[a][b] += __shfl_xor_sync(0xffffffffu, acc[a][b], o);
      }
      if (!active || part != 0) continue;
      float best[kHRows];
      int best_i[kHRows];
#pragma unroll
      for (int a = 0; a < kHRows; ++a) {
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
          for (int a = 0; a < kHRows; ++a) {
            const int r = kHRows * rg + a;
            if (r < rt) x.dec[(size_t)(r0 + r) * d.A + gc] = acc[a][b] + bias;
          }
        } else if (gc < d.A + d.D) {
          const int j = (int)(gc - d.A);
#pragma unroll
          for (int a = 0; a < kHRows; ++a) {
            const int r = kHRows * rg + a;
            if (r < rt) x.gp[(size_t)(r0 + r) * d.D + j] = acc[a][b] + bias;
          }
        } else if (logits) {
          const int v = (int)(gc - d.A - d.D);
          // columns in increasing order: a strict > keeps the lowest index
#pragma unroll
          for (int a = 0; a < kHRows; ++a) {
            const float val = acc[a][b] + bias;
            if (val > best[a] || best_i[a] == INT_MAX) {
              best[a] = val;
              best_i[a] = v;
            }
          }
        }
      }
      if (logits) {
#pragma unroll
        for (int a = 0; a < kHRows; ++a) {
          s.cv[(kHRows * rg + a) * ncg + cg] = best[a];
          s.ci[(kHRows * rg + a) * ncg + cg] = best_i[a];
        }
      }
    }
    __syncthreads();
    if (logits) {
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
          x.cand_v[(size_t)(r0 + rr) * q.ctas + blockIdx.x] = v;
          x.cand_i[(size_t)(r0 + rr) * q.ctas + blockIdx.x] = vi;
        }
      }
      __syncthreads();
    }
  }
}

// The token of step t for the CTA's rows (r % ctas == cta): the best of the
// CTAs' candidates; a row that is done emits end_id. A lane loads up to 8
// candidates before it compares, so the loads are in flight together.
__device__ void resolve_rows(const Params& q, const Scratch& x, int bsz,
                             int* tokens, int t) {
  constexpr int kPerLane = 8;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = blockIdx.x + warp * q.ctas; r < bsz; r += kWarps * q.ctas) {
    float v = -INFINITY;
    int vi = INT_MAX;
    for (int p0 = 0; p0 < q.ctas; p0 += 32 * kPerLane) {
      float cv[kPerLane];
      int ci[kPerLane];
#pragma unroll
      for (int m = 0; m < kPerLane; ++m) {
        const int p = p0 + 32 * m + lane;
        const bool in = p < q.ctas;
        cv[m] = in ? __ldcg(x.cand_v + (size_t)r * q.ctas + p) : -INFINITY;
        ci[m] = in ? __ldcg(x.cand_i + (size_t)r * q.ctas + p) : INT_MAX;
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
    if (lane == 0) {
      int tok = vi;
      if (q.end_id >= 0) {
        const int was = __ldcg(x.done + r);
        if (was) tok = q.end_id;
        x.done[r] = was | (tok == q.end_id);
      }
      tokens[(size_t)r * q.max_length + t] = tok;
      x.tok[r] = tok;
      vi = tok;
    }
    // bring the token's embedding row into L2 for phase G
    vi = __shfl_sync(0xffffffffu, vi, 0);
    for (int i = 32 * lane; i < q.d.E; i += 32 * 32)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(q.embed +
                                                    (size_t)vi * q.d.E + i));
  }
}

// Phase A: (row, D-chunk) items over the CTAs. gated = sigmoid(gp) * ctx.
template <typename FT>
__device__ void attention_phase(const Params& q, const Smem& s,
                                const Scratch& x, const FT* feat,
                                const float* proj, int bsz) {
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
      s.dec[a] = __ldcg(x.dec + (size_t)r * d.A + a);
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
    for (int k = tid; k < d.K; k += kThreads) s.alpha[k] = s.alpha[k] / sum;
    __syncthreads();
    // ctx over the chunk: 16 bytes of adjacent columns per thread (kVec);
    // with fewer column groups than threads, K is cut into slices whose
    // partial sums meet in a fixed pairwise tree
    constexpr int kVec = 16 / sizeof(FT);
    const int groups = wd / kVec;
    const int slices = groups >= kThreads ? 1 : kThreads / groups;
    const int rows = (d.K + slices - 1) / slices;
    const FT* fr = feat + (size_t)r * d.K * d.D + d0;
    const float* gpr = x.gp + (size_t)r * d.D + d0;
    float* out = x.gated + (size_t)r * d.D + d0;
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

// Rows of one gate-product segment for every unit the CTA owns:
// acc[u][k][g] += x_k[i] w[u][g][i] for i in [lo, hi), a lane taking 4
// adjacent i: one 16-byte load per row, and one per unit and gate plane
// (adjacent lanes on adjacent 16 bytes: no bank conflict).
__device__ __forceinline__ void gate_segment(
    const float* __restrict__ wg, int len, int units, int lo, int hi,
    int lane, const float* const (&src)[kGRows], int rows,
    float (&acc)[kGUnits][kGRows][4]) {
#pragma unroll 2
  for (int i = lo + 4 * lane; i < hi; i += 128) {
    float4 xv[kGRows];
#pragma unroll
    for (int k = 0; k < kGRows; ++k)
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
        for (int k = 0; k < kGRows; ++k) {  // one FMA per product
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
// then the LSTM tail. CTA p takes the units of group p % groups (units
// per CTA, groups = ceil(H / units)) for rows part p / groups of
// max(1, ctas / groups) parts, so each row's input [emb | gated | h] is
// read by `groups` CTAs. A warp takes kGRows rows over a slice of the
// input (in the order gated, h, emb, so the token load is in flight under
// the first two) for all the units at once; with few rows, several warps
// share a row group and their partial sums are added in warp order.
__device__ void gates_phase(const Params& q, const Smem& s,
                            const Scratch& x, const float* h_in,
                            const float* c_in, float* h_out, int bsz) {
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
  const int ng = (nrows + kGRows - 1) / kGRows;
  const int wpg = max(1, kWarps / max(ng, 1));           // warps per group
  const int gpp = kWarps / wpg;                          // groups per pass
  const int seg = ((len + wpg - 1) / wpg + 3) / 4 * 4;  // slice per warp
  for (int base = 0; base < ng; base += gpp) {
    // the tail's threads, one per (row, unit) of the pass, fetch c now, so
    // the loads overlap the products
    const int ty = tid < gpp * kGRows * nu ? tid : -1;
    const int tu = tid % nu;
    const int tk = tid / nu;  // row of the pass: group tk / kGRows
    const int trow = (base + tk / kGRows) * kGRows + tk % kGRows;
    const bool tail = ty >= 0 && base + tk / kGRows < ng && trow < nrows;
    const float c_prev =
        tail ? __ldcg(c_in + (size_t)(r_lo + trow) * d.H + j0 + tu) : 0.0f;
    const int gi = base + warp / wpg;
    if (warp < gpp * wpg && gi < ng) {
      const int i0 = (warp % wpg) * seg;
      const int i1 = min(len, i0 + seg);
      const int rows = min(kGRows, nrows - gi * kGRows);  // the real ones
      int row[kGRows], tok[kGRows];
      const float* src[kGRows];
#pragma unroll
      for (int k = 0; k < kGRows; ++k) {
        row[k] = r_lo + min(gi * kGRows + k, nrows - 1);
        tok[k] = __ldcg(x.tok + row[k]);
      }
      float acc[kGUnits][kGRows][4];
#pragma unroll
      for (int u = 0; u < kGUnits; ++u)
#pragma unroll
        for (int k = 0; k < kGRows; ++k)
          acc[u][k][0] = acc[u][k][1] = acc[u][k][2] = acc[u][k][3] = 0.0f;
      int lo = max(i0, d.E), hi = min(i1, d.E + d.D);
#pragma unroll
      for (int k = 0; k < kGRows; ++k)
        src[k] = x.gated + (size_t)row[k] * d.D + (lo - d.E);
      if (lo < hi) gate_segment(s.wg, len, nu, lo, hi, lane, src, rows, acc);
      lo = max(i0, d.E + d.D);
      hi = i1;
#pragma unroll
      for (int k = 0; k < kGRows; ++k)
        src[k] = h_in + (size_t)row[k] * d.H + (lo - d.E - d.D);
      if (lo < hi) gate_segment(s.wg, len, nu, lo, hi, lane, src, rows, acc);
      lo = i0;
      hi = min(i1, d.E);
#pragma unroll
      for (int k = 0; k < kGRows; ++k)
        src[k] = q.embed + (size_t)tok[k] * d.E + lo;
      if (lo < hi) gate_segment(s.wg, len, nu, lo, hi, lane, src, rows, acc);
#pragma unroll
      for (int u = 0; u < kGUnits; ++u) {
        if (u >= nu) break;
#pragma unroll
        for (int k = 0; k < kGRows; ++k)
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float v = warp_sum(acc[u][k][g]);
            if (lane == 0)
              s.part[((warp * kGUnits + u) * kGRows + k) * 4 + g] = v;
          }
      }
    }
    __syncthreads();
    if (tail) {
      const int gl = tk / kGRows;
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float acc = 0.0f;
        for (int sl = 0; sl < wpg; ++sl)
          acc += s.part[(((gl * wpg + sl) * kGUnits + tu) * kGRows +
                         tk % kGRows) * 4 + g];
        gate[g] = acc + s.bg[4 * tu + g];
      }
      const float ig = sigmoid_f32(gate[0]);
      const float fg = sigmoid_f32(gate[1]);
      const float gg = tanhf(gate[2]);
      const float og = sigmoid_f32(gate[3]);
      const float c_new = fg * c_prev + ig * gg;
      const size_t at = (size_t)(r_lo + trow) * d.H + j0 + tu;
      x.c[at] = c_new;
      h_out[at] = og * tanhf(c_new);
    }
    __syncthreads();
  }
}

template <typename FT>
__global__ void __launch_bounds__(kThreads, 1)
greedy_tiled_kernel(const Params q) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve_smem(reinterpret_cast<float*>(smem_raw), q);
  const Scratch x = carve_scratch(q);
  const StepDims& d = q.d;
  const int bsz = q.batch;
  const FT* feat = static_cast<const FT*>(q.feat);
  load_slices(q, s);
  for (int r = blockIdx.x + threadIdx.x * q.ctas; r < bsz;
       r += kThreads * q.ctas) {
    x.tok[r] = q.start_id;
    x.done[r] = 0;
  }
  __syncthreads();  // load_slices' writes, before the first tile
  hproducts_phase(q, s, x, q.h0, bsz, false);
  grid_sync(q);
  for (int t = 0; t < q.max_length; ++t) {
    if (t > 0) resolve_rows(q, x, bsz, q.tokens, t - 1);
    attention_phase<FT>(q, s, x, feat, q.proj, bsz);
    grid_sync(q);
    if (q.end_id >= 0 && t > 0) {
      bool all = true;
      for (int r = threadIdx.x; r < bsz; r += kThreads)
        all = all && __ldcg(x.done + r);
      if (__syncthreads_and(all)) {  // the same in every CTA
        for (int r = blockIdx.x; r < bsz; r += q.ctas)
          for (int u = t + threadIdx.x; u < q.max_length; u += kThreads)
            q.tokens[(size_t)r * q.max_length + u] = q.end_id;
        return;
      }
    }
    const float* h_in = t == 0 ? q.h0 : x.h + (size_t)((t - 1) & 1) * bsz * d.H;
    const float* c_in = t == 0 ? q.c0 : x.c;
    float* h_out = x.h + (size_t)(t & 1) * bsz * d.H;
    gates_phase(q, s, x, h_in, c_in, h_out, bsz);
    grid_sync(q);
    hproducts_phase(q, s, x, h_out, bsz, true);
    grid_sync(q);
  }
  resolve_rows(q, x, bsz, q.tokens, q.max_length - 1);
}

// The grid must be co-resident: the caller sizes it with max_ctas, and
// cudaLaunchCooperativeKernel refuses a larger one
// (cudaErrorCooperativeLaunchTooLarge).
template <typename FT>
cudaError_t launch(const Params& q, int smem, cudaStream_t stream) {
  if (smem_floats(q) * (long)sizeof(float) > smem)
    return cudaErrorInvalidValue;  // the planner and the carve disagree
  const void* fn = reinterpret_cast<const void*>(greedy_tiled_kernel<FT>);
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

template <typename FT>
int max_ctas(int smem) {
  const void* fn = reinterpret_cast<const void*>(greedy_tiled_kernel<FT>);
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

}  // namespace greedy
}  // namespace dcap

// The number of CTAs that can be co-resident at `smem` bytes of dynamic
// shared memory (blocks per SM x SMs), or minus a cudaError_t.
extern "C" int dcap_greedy_max_ctas(int feat_bf16, int smem) {
  return feat_bf16 ? dcap::greedy::max_ctas<__nv_bfloat16>(smem)
                   : dcap::greedy::max_ctas<float>(smem);
}

extern "C" int dcap_greedy_decode(
    const void* feat, int feat_bf16, const float* proj, const float* h0,
    const float* c0, const float* w_dec, const float* b_dec,
    const float* w_full, const float* b_full, const float* w_fb,
    const float* b_fb, const float* w_ih_e, const float* w_ih_c,
    const float* w_hh, const float* b_lstm, const float* w_out,
    const float* b_out, const float* embed, int* tokens, float* fscr,
    int* iscr, int batch, int k, int d, int a, int e, int hdim, int vocab,
    int max_length, int start_id, int end_id, int ctas, int h_cols,
    int units, int a_chunk, int h_rows, int smem, void* stream) {
  dcap::greedy::Params q;
  q.feat = feat;
  q.proj = proj;
  q.h0 = h0;
  q.c0 = c0;
  q.w = dcap::StepWeights{w_dec, b_dec, w_full, b_full, w_fb,
                          b_fb,  w_ih_e, w_ih_c, w_hh, b_lstm};
  q.d = dcap::StepDims{k, d, a, e, hdim};
  q.w_out = w_out;
  q.b_out = b_out;
  q.embed = embed;
  q.tokens = tokens;
  q.fscr = fscr;
  q.iscr = iscr;
  q.batch = batch;
  q.vocab = vocab;
  q.max_length = max_length;
  q.start_id = start_id;
  q.end_id = end_id;
  q.ctas = ctas;
  q.h_cols = h_cols;
  q.units = units;
  q.a_chunk = a_chunk;
  q.h_rows = h_rows;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      feat_bf16 ? dcap::greedy::launch<__nv_bfloat16>(q, smem, st)
                : dcap::greedy::launch<float>(q, smem, st);
  return static_cast<int>(err);
}
