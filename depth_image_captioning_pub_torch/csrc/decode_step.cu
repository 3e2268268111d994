// One attention-LSTM decode step over a batch in ONE cooperative launch: a
// grid of one CTA per SM on the phases of decode_phases.cuh.
//
// Replaces the TPU kernel
// depth_image_captioning_pub_tpu/ops/pallas/decode_step.py::fused_decode_core
// (pallas_call body `_kernel`). Same inputs, same outputs (h', c', alpha);
// the vocab head stays with the caller (stochastic sampling draws from its
// filtered logits, ops/decode.py). It is the whole-sequence greedy kernel's
// step with no head and no loop, three phases and two grid barriers:
//
//   H  dec = h W_dec + b_dec and gp = h W_fb + b_fb for every row
//      (hproducts_phase with V = 0)
//   A  (row, D-chunk) items over all CTAs: scores, an f32 softmax over K
//      (the row's first item writes alpha), the context over the chunk
//      (features upcast exactly) and gated = sigmoid(gp) * ctx, into a
//      [B, D] scratch (attention_phase)
//   G  the gates of the CTA's 1 or 2 hidden units for its part of the rows
//      and the LSTM tail, writing h' and c' (gates_phase; the embedding
//      rows are `emb` itself, read as a table with row r's token r)
//
// What bounds it on an H100: at the main shape (K=196, D=2048 bf16,
// A=E=H=128) the bytes, the B x K x D features read once and 5.8 MB of
// weights (W_ih_c 4 MB, W_fb 1 MB) read once per launch for all rows: each
// CTA loads its column slice of [W_dec | W_fb] and its units' gate columns
// into shared memory and reads each element once for every row it serves,
// where the one-CTA-per-row design streamed them from L2 once per row.
// Above the bound (tools/decode_step_ab.py's phase trace): the load of the
// gate columns, a gather down the rows of the gate weights that moves a
// 32-byte sector from L2 for each 4-byte element, once per launch (about
// 11 us with one hidden unit per CTA, which the planner takes below 128
// rows, twice that with two; cp.async copies landing during phases H and
// A saved nothing: sending the requests takes as long); phase A's feature
// stream at about half the HBM rate; and latency: two grid barriers, and
// the reads of freshly written rows (dec, gp, gated) from L2.
//
// Every sum has a fixed order and there is no float atomic, so repeated
// calls are bit-identical. The planner in ops/kernels/decode_step.py
// (plan_step) sizes the slices, the units, the attention chunk and the
// shared memory; the launcher checks the carve against it. Plain C
// interface, loaded with ctypes (ops/kernels/_build.py); returns the
// launch's cudaError_t. Build without --use_fast_math.
#include "decode_phases.cuh"

namespace dcap {
namespace seq {
namespace step {

struct Params : PhaseParams {
  float* h_out;      // [B, H]
  float* c_out;      // [B, H]
  float* alpha_out;  // [B, K]
};

// Shared memory in floats; the same sum as ops/kernels/decode_step.plan_step.
__host__ __device__ inline long smem_floats(const Params& q) {
  const StepDims& d = q.d;
  return (long)d.H * q.h_cols + (long)q.units * (d.E + d.D + d.H) * 4 +
         (long)q.h_rows * (d.H + 4) + 8L * kThreads + q.h_cols +
         4L * q.units + 2L * d.A + d.K + kWarps;
}

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
  s.cv = nullptr;  // no head
  s.ci = nullptr;
  s.alpha = s.bg + 4 * q.units;
  s.red = s.alpha + d.K;
  return s;
}

// Scratch in global memory, written and read by different CTAs (read with
// __ldcg): B * (2D + A) floats, 2 + B ints.
struct Scratch {
  float* gated;  // [B, D]
  float* dec;    // [B, A]
  float* gp;     // [B, D]  h W_fb + b_fb
  int* tok;      // [B]  row r's embedding row in q.embed: r
};

__device__ inline Scratch carve_scratch(const Params& q) {
  const long g = q.batch;
  Scratch x;
  x.gated = q.fscr;
  x.dec = x.gated + g * q.d.D;
  x.gp = x.dec + g * q.d.A;
  x.tok = q.iscr + 2;
  return x;
}

template <typename FT>
__global__ void __launch_bounds__(kThreads, 1) step_kernel(const Params q) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve_smem(reinterpret_cast<float*>(smem_raw), q);
  const Scratch x = carve_scratch(q);
  const int bsz = q.batch;
  load_slices(q, s);
  for (int r = blockIdx.x + threadIdx.x * q.ctas; r < bsz;
       r += kThreads * q.ctas)
    x.tok[r] = r;
  __syncthreads();  // load_slices' writes, before the first tile
  const HOut out{x.dec, x.gp, nullptr, nullptr, nullptr, nullptr, nullptr};
  hproducts_phase<false>(q, s, out, q.h0, bsz, false);
  grid_sync(q);
  attention_phase<FT>(q, s, x.dec, x.gp, x.gated, q.alpha_out,
                      static_cast<const FT*>(q.feat), q.proj, bsz);
  grid_sync(q);
  gates_phase<false>(q, s, x.gated, x.tok, nullptr, q.h0, q.c0, q.h_out,
                     q.c_out, bsz);
}

// The grid must be co-resident: the caller sizes it with max_ctas, and
// cudaLaunchCooperativeKernel refuses a larger one.
template <typename FT>
cudaError_t launch(const Params& q, int smem, cudaStream_t stream) {
  if (smem_floats(q) * (long)sizeof(float) > smem)
    return cudaErrorInvalidValue;  // the planner and the carve disagree
  const void* fn = reinterpret_cast<const void*>(step_kernel<FT>);
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
  const void* fn = reinterpret_cast<const void*>(step_kernel<FT>);
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

}  // namespace step
}  // namespace seq
}  // namespace dcap

// The number of CTAs that can be co-resident at `smem` bytes of dynamic
// shared memory (blocks per SM x SMs), or minus a cudaError_t.
extern "C" int dcap_step_max_ctas(int feat_bf16, int smem) {
  return feat_bf16 ? dcap::seq::step::max_ctas<__nv_bfloat16>(smem)
                   : dcap::seq::step::max_ctas<float>(smem);
}

extern "C" int dcap_decode_step(
    const void* feat, int feat_bf16, const float* proj, const float* emb,
    const float* h, const float* c, const float* w_dec, const float* b_dec,
    const float* w_full, const float* b_full, const float* w_fb,
    const float* b_fb, const float* w_ih_e, const float* w_ih_c,
    const float* w_hh, const float* b_lstm, float* h_out, float* c_out,
    float* alpha_out, float* fscr, int* iscr, int batch, int k, int d, int a,
    int e, int hdim, int ctas, int h_cols, int units, int a_chunk,
    int h_rows, int smem, void* stream) {
  dcap::seq::step::Params q{};
  q.feat = feat;
  q.proj = proj;
  q.h0 = h;
  q.c0 = c;
  q.w = dcap::StepWeights{w_dec, b_dec, w_full, b_full, w_fb,
                          b_fb,  w_ih_e, w_ih_c, w_hh, b_lstm};
  q.d = dcap::StepDims{k, d, a, e, hdim};
  q.w_out = nullptr;  // no head: V = 0
  q.b_out = nullptr;
  q.embed = emb;      // row r's input embedding is emb[r]
  q.fscr = fscr;
  q.iscr = iscr;
  q.batch = batch;
  q.vocab = 0;
  q.max_length = 1;
  q.start_id = 0;
  q.end_id = -1;
  q.ctas = ctas;
  q.h_cols = h_cols;
  q.units = units;
  q.a_chunk = a_chunk;
  q.h_rows = h_rows;
  q.h_out = h_out;
  q.c_out = c_out;
  q.alpha_out = alpha_out;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      feat_bf16 ? dcap::seq::step::launch<__nv_bfloat16>(q, smem, st)
                : dcap::seq::step::launch<float>(q, smem, st);
  return static_cast<int>(err);
}

extern "C" const char* dcap_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
