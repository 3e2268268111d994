// One attention-LSTM decode step for one image row, as a CUDA device function.
//
// Replaces the step math of the TPU kernel
// depth_image_captioning_pub_tpu/ops/pallas/decode_step.py::fused_decode_core
// (body `_kernel`), which the whole-sequence kernel
// ops/pallas/decode_seq.py::_make_kernel inlines in its time loop:
//
//   dec    = h W_dec + b_dec                              [A]
//   e      = relu(proj + dec) w_full + b_full             [K]
//   alpha  = softmax_K(e)                                 [K]
//   ctx    = alpha F                                      [D]
//   gated  = sigmoid(h W_fb + b_fb) * ctx                 [D]
//   gates  = emb W_ih_e + gated W_ih_c + h W_hh + b       [4H]  (i, f, g, o)
//   c'     = sigmoid(f) c + sigmoid(i) tanh(g);  h' = sigmoid(o) tanh(c')
//
// Pallas tiled the batch to fit VMEM; here one CTA owns one image row and
// keeps h, c, emb, dec, e/alpha, ctx, gated and gates in shared memory.
// Features may be stored bf16 and are upcast as they are read (exact);
// every sum is accumulated in f32.
//
// What bounds it on an H100: the CTA streams the step's weights from L2
// for its row alone, W_ih_c (D x 4H f32, 4 MB) and W_fb (1 MB) dominate,
// plus the row's features (196 x 2048 bf16, 0.8 MB). One SM can only pull
// so many bytes per second from L2, and only with enough loads in flight,
// so every matrix-vector product here (matvec below) gives each thread
// 16-byte loads of 4 adjacent columns and, when a matrix has fewer column
// groups than the CTA has threads, splits its rows over thread groups whose
// partial sums meet in shared memory. Rows share nothing, so a batch of B
// reads the weights B times per step; sharing one weight read across many
// rows (a batch-tiled GEMM) is the next step, not this one.
//
// Build without --use_fast_math: greedy argmax parity depends on expf/tanhf.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dcap {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct StepWeights {
  const float* w_dec;   // [H, A]
  const float* b_dec;   // [A]
  const float* w_full;  // [A]
  const float* b_full;  // [1]
  const float* w_fb;    // [H, D]
  const float* b_fb;    // [D]
  const float* w_ih_e;  // [E, 4H]
  const float* w_ih_c;  // [D, 4H]
  const float* w_hh;    // [H, 4H]
  const float* b_lstm;  // [4H]  (b_ih + b_hh)
};

struct StepDims {
  int K, D, A, E, H;
};

// The CTA's shared working set, carved from dynamic shared memory.
struct StepSmem {
  float* h;        // [H]   h in, h' out
  float* c;        // [H]   c in, c' out
  float* emb;      // [E]
  float* dec;      // [A]
  float* alpha;    // [K]   scores, then softmax weights
  float* ctx;      // [D]   context, then gated context
  float* gate;     // [D]   h W_fb
  float* gates;    // [4H]
  float* red;      // [kWarps]       reduction scratch
  float* partial;  // [4 * kThreads] matvec partial sums
};

__host__ __device__ inline int step_smem_floats(const StepDims& d) {
  return 2 * d.H + d.E + d.A + d.K + 2 * d.D + 4 * d.H + kWarps +
         4 * kThreads;
}

__device__ inline StepSmem carve_step_smem(float* base, const StepDims& d) {
  StepSmem s;
  s.h = base;
  s.c = s.h + d.H;
  s.emb = s.c + d.H;
  s.dec = s.emb + d.E;
  s.alpha = s.dec + d.A;
  s.ctx = s.alpha + d.K;
  s.gate = s.ctx + d.D;
  s.gates = s.gate + d.D;
  s.red = s.gates + 4 * d.H;
  s.partial = s.red + kWarps;
  return s;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four adjacent elements as f32: one 16-byte (f32) or 8-byte (bf16) load.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum or max; every thread calls it and gets the result.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kWarps; ++i) r = kMax ? fmaxf(r, red[i]) : r + red[i];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

// out[j] (+)= sum_{i < n_in} x[i] * W[i * n_out + j] for j < n_out, with x
// in shared memory and W row-major in global memory; every thread calls it
// and it ends synchronised. A thread takes 4 adjacent columns when n_out is
// a multiple of 4 and W is aligned for it, else 1. With fewer column groups
// than threads, the rows are cut into slices, one per thread group, and
// the slices' partial sums are added in slice order through `partial`
// (slices * n_out <= 4 * kThreads floats).
template <typename WT>
__device__ void matvec(const float* __restrict__ x,
                       const WT* __restrict__ W, int n_in, int n_out,
                       float* __restrict__ out, bool accumulate,
                       float* __restrict__ partial) {
  const int tid = threadIdx.x;
  const bool vec = (n_out % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(W) % (4 * sizeof(WT)) == 0);
  const int width = vec ? 4 : 1;
  const int groups = n_out / width;
  const int slices = groups >= kThreads ? 1 : kThreads / groups;
  const int rows = (n_in + slices - 1) / slices;
  const int slice = tid / groups;  // < slices unless the thread is idle
  float* dst = slices == 1 ? out : partial;

  for (int g = tid % groups; slice < slices && g < groups;
       g += (slices == 1 ? kThreads : groups)) {
    const int i0 = slices == 1 ? 0 : slice * rows;
    const int i1 = slices == 1 ? n_in : min(n_in, i0 + rows);
    const size_t base = slices == 1 ? 0 : (size_t)slice * n_out;
    if (vec) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      const WT* col = W + 4 * g;
#pragma unroll 4
      for (int i = i0; i < i1; ++i) {
        const float xi = x[i];
        const float4 w = load4(col + (size_t)i * n_out);
        acc.x += xi * w.x;
        acc.y += xi * w.y;
        acc.z += xi * w.z;
        acc.w += xi * w.w;
      }
      float* o = dst + base + 4 * g;
      if (slices == 1 && accumulate) {
        o[0] += acc.x; o[1] += acc.y; o[2] += acc.z; o[3] += acc.w;
      } else {
        o[0] = acc.x; o[1] = acc.y; o[2] = acc.z; o[3] = acc.w;
      }
    } else {
      float acc = 0.f;
#pragma unroll 4
      for (int i = i0; i < i1; ++i)
        acc += x[i] * to_f32(W[(size_t)i * n_out + g]);
      float* o = dst + base + g;
      *o = (slices == 1 && accumulate) ? *o + acc : acc;
    }
    if (slices > 1) break;  // a sliced thread owns one column group
  }
  __syncthreads();
  if (slices > 1) {
    for (int j = tid; j < n_out; j += kThreads) {
      float acc = accumulate ? out[j] : 0.f;
      for (int s = 0; s < slices; ++s) acc += partial[(size_t)s * n_out + j];
      out[j] = acc;
    }
    __syncthreads();
  }
}

// One step for one row. On entry s.h, s.c and s.emb hold the row's state and
// every thread has passed a __syncthreads() since they were written. On exit
// s.h, s.c hold h', c', s.alpha holds alpha, and the block is synchronised.
template <typename FT>
__device__ void attention_lstm_step(const FT* __restrict__ feat,    // [K, D]
                                    const float* __restrict__ proj, // [K, A]
                                    const StepWeights& w,
                                    const StepDims& d,
                                    const StepSmem& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = 4 * d.H;

  // dec = h W_dec + b_dec
  matvec(s.h, w.w_dec, d.H, d.A, s.dec, false, s.partial);
  for (int a = tid; a < d.A; a += kThreads) s.dec[a] += w.b_dec[a];
  __syncthreads();

  // e[k]: one warp per region, lanes over A, warp reduction
  const float b_full = w.b_full[0];
  for (int k = warp; k < d.K; k += kWarps) {
    const float* pk = proj + (size_t)k * d.A;
    float acc = 0.0f;
    for (int a = lane; a < d.A; a += 32)
      acc += fmaxf(pk[a] + s.dec[a], 0.0f) * w.w_full[a];
    acc = warp_sum(acc);
    if (lane == 0) s.alpha[k] = acc + b_full;
  }
  __syncthreads();

  // softmax over K in f32; each thread rewrites only the k it read
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

  // ctx = alpha F (features upcast as read); gated = sigmoid(h W_fb + b) ctx
  matvec(s.alpha, feat, d.K, d.D, s.ctx, false, s.partial);
  matvec(s.h, w.w_fb, d.H, d.D, s.gate, false, s.partial);
  for (int j = tid; j < d.D; j += kThreads)
    s.ctx[j] = sigmoid_f32(s.gate[j] + w.b_fb[j]) * s.ctx[j];
  __syncthreads();

  // gates = emb W_ih_e + gated W_ih_c + h W_hh + b
  matvec(s.emb, w.w_ih_e, d.E, G, s.gates, false, s.partial);
  matvec(s.ctx, w.w_ih_c, d.D, G, s.gates, true, s.partial);
  matvec(s.h, w.w_hh, d.H, G, s.gates, true, s.partial);

  // LSTM tail, gate order i, f, g, o; thread j owns h[j], c[j]
  for (int j = tid; j < d.H; j += kThreads) {
    const float ig = sigmoid_f32(s.gates[j] + w.b_lstm[j]);
    const float fg = sigmoid_f32(s.gates[d.H + j] + w.b_lstm[d.H + j]);
    const float gg = tanhf(s.gates[2 * d.H + j] + w.b_lstm[2 * d.H + j]);
    const float og = sigmoid_f32(s.gates[3 * d.H + j] + w.b_lstm[3 * d.H + j]);
    const float c_new = fg * s.c[j] + ig * gg;
    s.c[j] = c_new;
    s.h[j] = og * tanhf(c_new);
  }
  __syncthreads();
}

}  // namespace dcap
