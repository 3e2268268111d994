// Whole-sequence NIC (Show and Tell) greedy decode in ONE launch: grid = B,
// one CTA per image row, the time loop inside the CTA.
//
// Replaces the TPU kernel
// depth_image_captioning_pub_tpu/ops/pallas/nic_seq.py::fused_nic_greedy_decode
// (pallas_call body `_make_kernel`). The stacked LSTM starts from zero state
// and is primed by the image embedding x0 at step 0; each step runs
//
//   for each layer l (input x for l = 0, the new h of layer l-1 above it):
//     gates = in W_ih_l + h_l W_hh_l + b_l     [4H]  (b = b_ih + b_hh)
//     c_l'  = sigmoid(f) c_l + sigmoid(i) tanh(g);  h_l' = sigmoid(o) tanh(c_l')
//   token = argmax(h_top' W_out + b_out)       head_argmax, lowest index on
//                                              equal values
//   x     = embed[token]                       [E], a gather
//
// for a fixed max_length steps: NIC's greedy decode has no <end> early exit
// (the JAX scan and the Pallas kernel both run every step).
//
// What bounds it on an H100: like the attention decoder's greedy kernel,
// each CTA streams the weights from L2 for its row alone, per step: the
// layers' W_ih/W_hh (E x 4H and 3 x H x 4H f32, about 1.4 MB at E=300,
// H=128) and W_out (H x V f32, about 5 MB at V=9956). The matrix-vector
// products (matvec of decode_step.cuh) give each thread 16-byte loads of 4
// adjacent columns and split the rows of the narrow gate matrices over
// thread groups. Nothing needs E or V to be a power of two or a multiple of
// 4: the embedding row is gathered one float per thread, matvec takes any
// n_in, and the head falls back to one column per thread when V % 4 != 0.
//
// Plain C interface, loaded with ctypes (ops/kernels/_build.py). Returns the
// launch's cudaError_t; the Python wrapper raises when it is not 0.
#include "decode_step.cuh"

namespace dcap {

// argmax_j (h W_out + b_out)[j] over j < vocab, h [H] in shared memory:
// the vocab head of decode_seq.cu's greedy kernel as a function. Threads
// over V (16-byte loads of 4 adjacent columns when V and the pointers allow
// it), each walking its columns in increasing order so a strict > keeps the
// lowest index among equal values, then warp and block merges on (value,
// then index). Every thread calls it and gets the token; s_val/s_idx are
// [kWarps] shared scratch and s_tok one shared int. Ends synchronised.
// decode_seq.cu keeps its own inline copy: calling this function from the
// greedy kernel measured 2% slower there (4.88 vs 4.78 ms at B=64,
// chip_smoke.py phase 4 from both trees in one call, H100).
__device__ __forceinline__ int head_argmax(
    const float* __restrict__ h, int H,
    const float* __restrict__ w_out,  // [H, V]
    const float* __restrict__ b_out,  // [V]
    int vocab, float* s_val, int* s_idx, int* s_tok) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool vec = vocab % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w_out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b_out) % 16 == 0;
  float best = -INFINITY;
  int best_idx = INT_MAX;
  if (vec) {
    for (int q = tid; q < vocab / 4; q += kThreads) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int i = 0; i < H; ++i) {
        const float hi = h[i];
        const float4 wv = load4(w_out + (size_t)i * vocab + 4 * q);
        acc.x += hi * wv.x;
        acc.y += hi * wv.y;
        acc.z += hi * wv.z;
        acc.w += hi * wv.w;
      }
      const float4 bv = load4(b_out + 4 * q);
      take_max(acc.x + bv.x, 4 * q, best, best_idx);
      take_max(acc.y + bv.y, 4 * q + 1, best, best_idx);
      take_max(acc.z + bv.z, 4 * q + 2, best, best_idx);
      take_max(acc.w + bv.w, 4 * q + 3, best, best_idx);
    }
  } else {
    for (int v = tid; v < vocab; v += kThreads) {
      float acc = 0.0f;
#pragma unroll 4
      for (int i = 0; i < H; ++i) acc += h[i] * w_out[(size_t)i * vocab + v];
      take_max(acc + b_out[v], v, best, best_idx);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_idx, o);
    if (ov > best || (ov == best && oi < best_idx)) {
      best = ov;
      best_idx = oi;
    }
  }
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = best_idx;
  }
  __syncthreads();
  if (tid == 0) {
    float bv = s_val[0];
    int bi = s_idx[0];
    for (int i = 1; i < kWarps; ++i) {
      if (s_val[i] > bv || (s_val[i] == bv && s_idx[i] < bi)) {
        bv = s_val[i];
        bi = s_idx[i];
      }
    }
    *s_tok = bi;
  }
  __syncthreads();
  return *s_tok;
}

constexpr int kMaxLayers = 4;

struct NICLayers {
  const float* w_ih[kMaxLayers];  // [E or H, 4H]
  const float* w_hh[kMaxLayers];  // [H, 4H]
  const float* b[kMaxLayers];     // [4H]  (b_ih + b_hh)
};

__host__ __device__ inline int nic_smem_floats(int layers, int E, int H) {
  return E + 2 * layers * H + 4 * H + 4 * kThreads;
}

__global__ void __launch_bounds__(kThreads)
nic_greedy_kernel(const float* __restrict__ x0,     // [B, E]
                  NICLayers lw, int layers, int E, int H,
                  const float* __restrict__ w_out,  // [H, V]
                  const float* __restrict__ b_out,  // [V]
                  const float* __restrict__ embed,  // [V, E]
                  int vocab, int max_length,
                  int* __restrict__ tokens) {       // [B, max_length]
  extern __shared__ float smem[];
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_tok;
  float* x = smem;                  // [E]     the step's input
  float* hs = x + E;                // [L, H]
  float* cs = hs + layers * H;      // [L, H]
  float* gates = cs + layers * H;   // [4H]
  float* partial = gates + 4 * H;   // [4 * kThreads] matvec partial sums
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int G = 4 * H;
  int* out = tokens + (size_t)b * max_length;

  for (int j = tid; j < E; j += kThreads) x[j] = x0[(size_t)b * E + j];
  for (int j = tid; j < layers * H; j += kThreads) {
    hs[j] = 0.0f;
    cs[j] = 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < max_length; ++t) {
    for (int l = 0; l < layers; ++l) {
      float* h = hs + l * H;
      float* c = cs + l * H;
      matvec(l == 0 ? x : hs + (l - 1) * H, lw.w_ih[l], l == 0 ? E : H, G,
             gates, false, partial);
      matvec(h, lw.w_hh[l], H, G, gates, true, partial);
      const float* bias = lw.b[l];
      for (int j = tid; j < H; j += kThreads) {
        const float ig = sigmoid_f32(gates[j] + bias[j]);
        const float fg = sigmoid_f32(gates[H + j] + bias[H + j]);
        const float gg = tanhf(gates[2 * H + j] + bias[2 * H + j]);
        const float og = sigmoid_f32(gates[3 * H + j] + bias[3 * H + j]);
        const float c_new = fg * c[j] + ig * gg;
        c[j] = c_new;
        h[j] = og * tanhf(c_new);
      }
      __syncthreads();
    }
    const int token = head_argmax(hs + (layers - 1) * H, H, w_out, b_out,
                                  vocab, s_val, s_idx, &s_tok);
    if (tid == 0) out[t] = token;
    for (int j = tid; j < E; j += kThreads)
      x[j] = embed[(size_t)token * E + j];
    __syncthreads();
  }
}

}  // namespace dcap

extern "C" int dcap_nic_greedy_decode(
    const float* x0, const float* w_ih0, const float* w_hh0, const float* b0,
    const float* w_ih1, const float* w_hh1, const float* b1,
    const float* w_ih2, const float* w_hh2, const float* b2,
    const float* w_ih3, const float* w_hh3, const float* b3,
    const float* w_out, const float* b_out, const float* embed, int* tokens,
    int batch, int layers, int e, int hdim, int vocab, int max_length,
    void* stream) {
  if (layers < 1 || layers > dcap::kMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  const dcap::NICLayers lw{{w_ih0, w_ih1, w_ih2, w_ih3},
                           {w_hh0, w_hh1, w_hh2, w_hh3},
                           {b0, b1, b2, b3}};
  const size_t smem =
      sizeof(float) * (size_t)dcap::nic_smem_floats(layers, e, hdim);
  cudaError_t err = cudaFuncSetAttribute(
      dcap::nic_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dcap::nic_greedy_kernel<<<batch, dcap::kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      x0, lw, layers, e, hdim, w_out, b_out, embed, vocab, max_length,
      tokens);
  return static_cast<int>(cudaGetLastError());
}
