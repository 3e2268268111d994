// Whole-sequence greedy caption decode in ONE launch: grid = B, one CTA per
// image row, the time loop inside the CTA.
//
// Replaces the TPU kernel
// depth_image_captioning_pub_tpu/ops/pallas/decode_seq.py::fused_greedy_decode
// (pallas_call body `_make_kernel`). Each step runs the attention-LSTM
// device step of decode_step.cuh, then
//
//   logits = h' W_out + b_out      threads over V (16-byte loads of 4
//                                  adjacent columns), coalesced rows
//   token  = argmax(logits)        block argmax, LOWEST index on equal values
//                                  (what jnp.argmax and torch.argmax return)
//   emb    = embed[token]          a gather; the Pallas kernel's one-hot
//                                  matmul was a Mosaic workaround
//
// <end> handling: once this row emits end_id, its remaining slots are filled
// with end_id and its CTA leaves the loop. Rows are independent, so this is
// the output of the Pallas block-level early exit, where finished rows only
// ever emit <end>. end_id < 0 runs every step.
//
// What bounds it on an H100: each CTA streams, per step and for its row
// alone, W_ih_c (4 MB) and W_fb (1 MB) for the step plus W_out (H x V f32,
// about 5 MB at V=9956) for the head, from L2; plus the row's 0.8 MB of bf16
// features. The weights are read once per row per step, so the kernel does
// B times the weight traffic a batch-tiled GEMM would; sharing each weight
// read across rows is the next step, not this one.
//
// Plain C interface, loaded with ctypes (ops/kernels/_build.py). Returns the
// launch's cudaError_t; the Python wrapper raises when it is not 0.
#include "decode_step.cuh"

namespace dcap {

template <typename FT>
__global__ void __launch_bounds__(kThreads)
greedy_decode_kernel(const FT* __restrict__ feat,
                     const float* __restrict__ proj,
                     const float* __restrict__ h0,
                     const float* __restrict__ c0, StepWeights w, StepDims d,
                     const float* __restrict__ w_out,  // [H, V]
                     const float* __restrict__ b_out,  // [V]
                     const float* __restrict__ embed,  // [V, E]
                     int vocab, int max_length, int start_id, int end_id,
                     int* __restrict__ tokens) {       // [B, max_length]
  extern __shared__ float smem[];
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_tok;
  const StepSmem s = carve_step_smem(smem, d);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const FT* feat_b = feat + (size_t)b * d.K * d.D;
  const float* proj_b = proj + (size_t)b * d.K * d.A;
  int* out = tokens + (size_t)b * max_length;
  const bool head_vec = vocab % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(w_out) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(b_out) % 16 == 0;

  for (int j = tid; j < d.H; j += kThreads) {
    s.h[j] = h0[(size_t)b * d.H + j];
    s.c[j] = c0[(size_t)b * d.H + j];
  }
  for (int j = tid; j < d.E; j += kThreads)
    s.emb[j] = embed[(size_t)start_id * d.E + j];
  __syncthreads();

  for (int t = 0; t < max_length; ++t) {
    attention_lstm_step<FT>(feat_b, proj_b, w, d, s);

    // vocab head: threads over V (4 adjacent columns per 16-byte load
    // when V allows it); each thread walks its columns in increasing order,
    // so a strict > keeps the lowest index among equal values
    float best = -INFINITY;
    int best_idx = INT_MAX;
    if (head_vec) {
      for (int q = tid; q < vocab / 4; q += kThreads) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int i = 0; i < d.H; ++i) {
          const float hi = s.h[i];
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
        for (int i = 0; i < d.H; ++i)
          acc += s.h[i] * w_out[(size_t)i * vocab + v];
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
      out[t] = bi;
      s_tok = bi;
    }
    __syncthreads();
    const int token = s_tok;
    if (end_id >= 0 && token == end_id) {
      for (int u = t + 1 + tid; u < max_length; u += kThreads) out[u] = end_id;
      break;  // token is the same for every thread: a uniform exit
    }
    for (int j = tid; j < d.E; j += kThreads)
      s.emb[j] = embed[(size_t)token * d.E + j];
    __syncthreads();
  }
}

template <typename FT>
cudaError_t launch_greedy_decode(const void* feat, const float* proj,
                                 const float* h0, const float* c0,
                                 const StepWeights& w, const StepDims& d,
                                 const float* w_out, const float* b_out,
                                 const float* embed, int vocab,
                                 int max_length, int start_id, int end_id,
                                 int* tokens, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)step_smem_floats(d);
  cudaError_t err = cudaFuncSetAttribute(
      greedy_decode_kernel<FT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  greedy_decode_kernel<FT><<<batch, kThreads, smem, stream>>>(
      static_cast<const FT*>(feat), proj, h0, c0, w, d, w_out, b_out, embed,
      vocab, max_length, start_id, end_id, tokens);
  return cudaGetLastError();
}

}  // namespace dcap

extern "C" int dcap_greedy_decode(
    const void* feat, int feat_bf16, const float* proj, const float* h0,
    const float* c0, const float* w_dec, const float* b_dec,
    const float* w_full, const float* b_full, const float* w_fb,
    const float* b_fb, const float* w_ih_e, const float* w_ih_c,
    const float* w_hh, const float* b_lstm, const float* w_out,
    const float* b_out, const float* embed, int* tokens, int batch, int k,
    int d, int a, int e, int hdim, int vocab, int max_length, int start_id,
    int end_id, void* stream) {
  const dcap::StepWeights w{w_dec, b_dec, w_full, b_full, w_fb,
                            b_fb,  w_ih_e, w_ih_c, w_hh, b_lstm};
  const dcap::StepDims dims{k, d, a, e, hdim};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      feat_bf16
          ? dcap::launch_greedy_decode<__nv_bfloat16>(
                feat, proj, h0, c0, w, dims, w_out, b_out, embed, vocab,
                max_length, start_id, end_id, tokens, batch, st)
          : dcap::launch_greedy_decode<float>(
                feat, proj, h0, c0, w, dims, w_out, b_out, embed, vocab,
                max_length, start_id, end_id, tokens, batch, st);
  return static_cast<int>(err);
}
