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
// Each CTA holds a column slice of [W_dec | W_fb | W_out] and the gate
// weights of 1 or 2 whole hidden units in shared memory for the whole
// launch (load_slices of decode_phases.cuh, shared with the beam-search
// kernel), and reads each weight element from shared memory once per step
// for all the rows it serves. A step is three phases between grid
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
// A, G and H, the slice loader and the grid barrier are decode_phases.cuh's
// (A shared with the one-step kernel, decode_step.cu); the candidates'
// resolution is this kernel's. The planner in
// ops/kernels/decode_seq.py sizes the slices, the row tile and the shared
// memory; the launcher checks the carve against it. Plain C interface,
// loaded with ctypes (ops/kernels/_build.py). Build without --use_fast_math.
#include "decode_phases.cuh"

namespace dcap {
namespace seq {
namespace greedy {

struct Params : PhaseParams {
  int* tokens;  // [B, max_length]
};

// Shared memory in floats; the same sum as ops/kernels/decode_seq.plan.
__host__ __device__ inline long smem_floats(const Params& q) {
  const StepDims& d = q.d;
  return (long)d.H * q.h_cols + (long)q.units * (d.E + d.D + d.H) * 4 +
         (long)q.h_rows * (d.H + 4) + 8L * kThreads +
         2L * q.h_rows * (q.h_cols / 4) + q.h_cols + 4L * q.units + 2L * d.A +
         d.K + kWarps;
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

// The token of step t for the CTA's rows (r % ctas == cta): the best of the
// CTAs' candidates (best_candidate); a row that is done emits end_id.
__device__ void resolve_rows(const Params& q, const Scratch& x, int bsz,
                             int* tokens, int t) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = blockIdx.x + warp * q.ctas; r < bsz; r += kWarps * q.ctas) {
    int vi = best_candidate(x.cand_v, x.cand_i, q.ctas, r);
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
  const HOut out{x.dec, x.gp, x.cand_v, x.cand_i, nullptr};
  hproducts_phase<false>(q, s, out, q.h0, bsz, false);
  grid_sync(q);
  for (int t = 0; t < q.max_length; ++t) {
    if (t > 0) resolve_rows(q, x, bsz, q.tokens, t - 1);
    attention_phase<FT>(q, s, x.dec, x.gp, x.gated, nullptr, feat, q.proj,
                        bsz);
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
    gates_phase<false>(q, s, x.gated, x.tok, nullptr, h_in, c_in, h_out, x.c,
                       bsz);
    grid_sync(q);
    hproducts_phase<false>(q, s, out, h_out, bsz, true);
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
}  // namespace seq
}  // namespace dcap

// The number of CTAs that can be co-resident at `smem` bytes of dynamic
// shared memory (blocks per SM x SMs), or minus a cudaError_t.
extern "C" int dcap_greedy_max_ctas(int feat_bf16, int smem) {
  return feat_bf16 ? dcap::seq::greedy::max_ctas<__nv_bfloat16>(smem)
                   : dcap::seq::greedy::max_ctas<float>(smem);
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
  dcap::seq::greedy::Params q;
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
      feat_bf16 ? dcap::seq::greedy::launch<__nv_bfloat16>(q, smem, st)
                : dcap::seq::greedy::launch<float>(q, smem, st);
  return static_cast<int>(err);
}
