// What every decode kernel shares below its phases: the attention-LSTM
// step's weights and sizes, and small device helpers.
//
// The step (the math of the TPU kernel
// depth_image_captioning_pub_tpu/ops/pallas/decode_step.py::fused_decode_core,
// which the whole-sequence kernels inline in their time loops):
//
//   dec    = h W_dec + b_dec                              [A]
//   e      = relu(proj + dec) w_full + b_full             [K]
//   alpha  = softmax_K(e)                                 [K]
//   ctx    = alpha F                                      [D]
//   gated  = sigmoid(h W_fb + b_fb) * ctx                 [D]
//   gates  = emb W_ih_e + gated W_ih_c + h W_hh + b       [4H]  (i, f, g, o)
//   c'     = sigmoid(f) c + sigmoid(i) tanh(g);  h' = sigmoid(o) tanh(c')
//
// decode_phases.cuh splits it into phases over a persistent grid (H: dec
// and the f_beta products, A: attention, G: gates and the LSTM tail); the
// one-step kernel (decode_step.cu) and the whole-sequence kernels run them.
//
// Build without --use_fast_math: greedy argmax parity depends on expf/tanhf.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace dcap {

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

}  // namespace dcap
