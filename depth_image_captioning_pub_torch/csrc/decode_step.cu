// One fused attention-LSTM decode step over a batch: grid = B, one CTA per
// image row, running the device step of decode_step.cuh once.
//
// Replaces the TPU kernel
// depth_image_captioning_pub_tpu/ops/pallas/decode_step.py::fused_decode_core
// (pallas_call body `_kernel`). Same inputs, same outputs (h', c', alpha);
// the vocab head stays with the caller. What bounds it on an H100 is the
// per-row weight stream from L2 described in decode_step.cuh.
//
// Plain C interface, loaded with ctypes (ops/kernels/_build.py). Returns the
// launch's cudaError_t; the Python wrapper raises when it is not 0.
#include "decode_step.cuh"

namespace dcap {

template <typename FT>
__global__ void __launch_bounds__(kThreads)
decode_step_kernel(const FT* __restrict__ feat, const float* __restrict__ proj,
                   const float* __restrict__ emb, const float* __restrict__ h,
                   const float* __restrict__ c, StepWeights w, StepDims d,
                   float* __restrict__ h_out, float* __restrict__ c_out,
                   float* __restrict__ alpha_out) {
  extern __shared__ float smem[];
  const StepSmem s = carve_step_smem(smem, d);
  const int b = blockIdx.x;
  for (int j = threadIdx.x; j < d.H; j += kThreads) {
    s.h[j] = h[(size_t)b * d.H + j];
    s.c[j] = c[(size_t)b * d.H + j];
  }
  for (int j = threadIdx.x; j < d.E; j += kThreads)
    s.emb[j] = emb[(size_t)b * d.E + j];
  __syncthreads();
  attention_lstm_step<FT>(feat + (size_t)b * d.K * d.D,
                          proj + (size_t)b * d.K * d.A, w, d, s);
  for (int j = threadIdx.x; j < d.H; j += kThreads) {
    h_out[(size_t)b * d.H + j] = s.h[j];
    c_out[(size_t)b * d.H + j] = s.c[j];
  }
  for (int k = threadIdx.x; k < d.K; k += kThreads)
    alpha_out[(size_t)b * d.K + k] = s.alpha[k];
}

template <typename FT>
cudaError_t launch_decode_step(const void* feat, const float* proj,
                               const float* emb, const float* h,
                               const float* c, const StepWeights& w,
                               const StepDims& d, float* h_out, float* c_out,
                               float* alpha_out, int batch,
                               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)step_smem_floats(d);
  cudaError_t err = cudaFuncSetAttribute(
      decode_step_kernel<FT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  decode_step_kernel<FT><<<batch, kThreads, smem, stream>>>(
      static_cast<const FT*>(feat), proj, emb, h, c, w, d, h_out, c_out,
      alpha_out);
  return cudaGetLastError();
}

}  // namespace dcap

extern "C" int dcap_decode_step(
    const void* feat, int feat_bf16, const float* proj, const float* emb,
    const float* h, const float* c, const float* w_dec, const float* b_dec,
    const float* w_full, const float* b_full, const float* w_fb,
    const float* b_fb, const float* w_ih_e, const float* w_ih_c,
    const float* w_hh, const float* b_lstm, float* h_out, float* c_out,
    float* alpha_out, int batch, int k, int d, int a, int e, int hdim,
    void* stream) {
  const dcap::StepWeights w{w_dec, b_dec, w_full, b_full, w_fb,
                            b_fb,  w_ih_e, w_ih_c, w_hh, b_lstm};
  const dcap::StepDims dims{k, d, a, e, hdim};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      feat_bf16 ? dcap::launch_decode_step<__nv_bfloat16>(
                      feat, proj, emb, h, c, w, dims, h_out, c_out, alpha_out,
                      batch, st)
                : dcap::launch_decode_step<float>(feat, proj, emb, h, c, w,
                                                  dims, h_out, c_out,
                                                  alpha_out, batch, st);
  return static_cast<int>(err);
}

extern "C" const char* dcap_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
