// Whole beam search in ONE launch: grid = B, one CTA per image holding all W
// of its beams, the time loop inside the CTA.
//
// Replaces the TPU kernel
// depth_image_captioning_pub_tpu/ops/pallas/beam_seq.py::fused_beam_decode
// (pallas_call body `_make_kernel`), the search of ops/decode.beam_search:
//
//   1. the attention-LSTM step (decode_step.cuh's math) for the W beams;
//   2. logits = h' W_out + b_out                 [W, V] -> global scratch
//   3. lp = x - max - log(sum(exp(x - max)))     per beam row, block sums
//   4. finished beams: lp = 0 for <end>, -1e9 for every other token
//   5. total = score + lp, and the flat top-W over W*V in lax.top_k's
//      order: the larger value first, among equal values the lower flat
//      index w*V + v;
//   6. h, c and finished reordered by parent, the chosen tokens embedded,
//      (token, parent) recorded;
//   7. exit once the image's W beams have all finished: the records of the
//      skipped steps are <end> with identity parents, which is what those
//      steps would give (ops/decode.beam_search's early-exit argument).
//
// What bounds it on an H100: per step the CTA streams the step's weights
// (W_ih_c 4 MB, W_fb 1 MB f32), W_out (5 MB at V=9956) and the image's
// features (0.8 MB bf16) from L2. Holding the W beams in one CTA reads each
// of these ONCE per step for all beams (matvec_rows: every 16-byte load of
// 4 adjacent columns feeds W rows of FMAs), where a CTA per beam would read
// them W times. The [W, V] logits of one image (199 KB at W=5) do not fit
// beside the step's working set in the 227 KB of shared memory, so they go
// to a global scratch [B, W, V] that the wrapper allocates (12.7 MB at B=64,
// inside the 50 MB L2). The top-W is an ordinary block reduction on this
// card (the TPU kernel's in-kernel top-k was its recorded loss): each thread
// keeps a sorted top-W of its strided slice, then W rounds of a block-wide
// (value, index) argmax pop the winners.
//
// Plain C interface, loaded with ctypes (ops/kernels/_build.py). Returns the
// launch's cudaError_t; the Python wrapper raises when it is not 0.
#include "decode_step.cuh"

namespace dcap {

constexpr int kBeamThreads = 512;
constexpr int kBeamWarps = kBeamThreads / 32;
constexpr int kMaxBeam = 5;

// Rows of W in flight per thread in the weight-streaming loops, per beam
// width R. The kernel waits on L2 loads, so deeper unrolling pays until the
// R accumulators and the loads in flight crowd the 128 registers a thread
// has at 512 threads; where that happens depends on R and was measured, not
// derived (B=64, V=9956, H100, records identical at every depth; PERF.md).
__host__ __device__ constexpr int beam_unroll(int R) {
  return R == 5 ? 8 : (R == 3 ? 4 : 6);
}
constexpr float kNegInf = -1e9f;  // ops/decode.NEG_INF

// The CTA's shared working set for W beams, carved from dynamic shared
// memory; rows of beam r start at r * (row width).
struct BeamSmem {
  float* h;        // [W, H]
  float* c;        // [W, H]
  float* emb;      // [W, E]
  float* dec;      // [W, A]
  float* alpha;    // [W, K]   scores, then softmax weights
  float* ctx;      // [W, D]   context, then gated context
  float* gate;     // [W, D]   h W_fb
  float* gates;    // [W, 4H]  LSTM gates, then the reorder copy of h and c
  float* red;      // [kBeamWarps, W] reduction scratch
  float* partial;  // [W, 4 * kBeamThreads] matvec_rows partial sums
};

__host__ __device__ inline int beam_smem_floats(const StepDims& d, int W) {
  return W * (2 * d.H + d.E + d.A + d.K + 2 * d.D + 4 * d.H) +
         kBeamWarps * W + W * 4 * kBeamThreads;
}

__device__ inline BeamSmem carve_beam_smem(float* base, const StepDims& d,
                                           int W) {
  BeamSmem s;
  s.h = base;
  s.c = s.h + W * d.H;
  s.emb = s.c + W * d.H;
  s.dec = s.emb + W * d.E;
  s.alpha = s.dec + W * d.A;
  s.ctx = s.alpha + W * d.K;
  s.gate = s.ctx + W * d.D;
  s.gates = s.gate + W * d.D;
  s.red = s.gates + W * 4 * d.H;
  s.partial = s.red + kBeamWarps * W;
  return s;
}

// out[r, j] (+)= sum_{i < n_in} x[r, i] W[i, j] for the R rows of x (row
// stride ldx, shared memory) and j < n_out (row stride ldo), W row-major in
// global memory and read once for all R rows. Every thread calls it and it
// ends synchronised. As decode_step.cuh's matvec: 4 adjacent columns per
// thread when n_out and W allow it, and the rows of W cut into slices over
// thread groups when there are fewer column groups than threads, their
// partial sums added in slice order (slices * R * n_out <= R * 4 *
// kBeamThreads floats of `partial`).
template <int R, typename WT>
__device__ void matvec_rows(const float* __restrict__ x, int ldx,
                            const WT* __restrict__ W, int n_in, int n_out,
                            float* __restrict__ out, int ldo, bool accumulate,
                            float* __restrict__ partial) {
  const int tid = threadIdx.x;
  const bool vec = (n_out % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(W) % (4 * sizeof(WT)) == 0);
  const int width = vec ? 4 : 1;
  const int groups = n_out / width;
  const int slices = groups >= kBeamThreads ? 1 : kBeamThreads / groups;
  const int rows = (n_in + slices - 1) / slices;
  const int slice = tid / groups;  // < slices unless the thread is idle

  for (int g = tid % groups; slice < slices && g < groups;
       g += (slices == 1 ? kBeamThreads : groups)) {
    const int i0 = slices == 1 ? 0 : slice * rows;
    const int i1 = slices == 1 ? n_in : min(n_in, i0 + rows);
    if (vec) {
      float4 acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      const WT* col = W + 4 * g;
#pragma unroll (beam_unroll(R))
      for (int i = i0; i < i1; ++i) {
        const float4 w = load4(col + (size_t)i * n_out);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xi = x[r * ldx + i];
          acc[r].x += xi * w.x;
          acc[r].y += xi * w.y;
          acc[r].z += xi * w.z;
          acc[r].w += xi * w.w;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (slices == 1) {
          float* o = out + r * ldo + 4 * g;
          if (accumulate) {
            o[0] += acc[r].x; o[1] += acc[r].y;
            o[2] += acc[r].z; o[3] += acc[r].w;
          } else {
            o[0] = acc[r].x; o[1] = acc[r].y;
            o[2] = acc[r].z; o[3] = acc[r].w;
          }
        } else {
          float* o = partial + ((size_t)slice * R + r) * n_out + 4 * g;
          o[0] = acc[r].x; o[1] = acc[r].y; o[2] = acc[r].z; o[3] = acc[r].w;
        }
      }
    } else {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll (beam_unroll(R))
      for (int i = i0; i < i1; ++i) {
        const float w = to_f32(W[(size_t)i * n_out + g]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] += x[r * ldx + i] * w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (slices == 1) {
          float* o = out + r * ldo + g;
          *o = accumulate ? *o + acc[r] : acc[r];
        } else {
          partial[((size_t)slice * R + r) * n_out + g] = acc[r];
        }
      }
    }
    if (slices > 1) break;  // a sliced thread owns one column group
  }
  __syncthreads();
  if (slices > 1) {
    for (int j = tid; j < R * n_out; j += kBeamThreads) {
      const int r = j / n_out;
      const int col = j - r * n_out;
      float acc = accumulate ? out[r * ldo + col] : 0.f;
      for (int sl = 0; sl < slices; ++sl)
        acc += partial[((size_t)sl * R + r) * n_out + col];
      out[r * ldo + col] = acc;
    }
    __syncthreads();
  }
}

// Block-wide max or sum of each of the R values a thread holds; every
// thread gets the R results. red: [kBeamWarps * R] shared floats.
template <int R, bool kMax>
__device__ void block_reduce_rows(float (&v)[R], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = kMax ? warp_max(v[r]) : warp_sum(v[r]);
    if (lane == 0) red[warp * R + r] = v[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float acc = red[r];
    for (int i = 1; i < kBeamWarps; ++i)
      acc = kMax ? fmaxf(acc, red[i * R + r]) : acc + red[i * R + r];
    v[r] = acc;
  }
  __syncthreads();  // red is reused by the next reduction
}

// lax.top_k's order: the larger value, then the lower flat index.
__device__ __forceinline__ bool ranks_before(float av, int ai, float bv,
                                             int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Insert (v, i) into a thread's sorted top-R list if it makes the cut.
template <int R>
__device__ __forceinline__ void insert_top(float v, int i, float (&tv)[R],
                                           int (&ti)[R]) {
  if (!ranks_before(v, i, tv[R - 1], ti[R - 1])) return;
  tv[R - 1] = v;
  ti[R - 1] = i;
#pragma unroll
  for (int k = R - 1; k > 0; --k) {
    if (ranks_before(tv[k], ti[k], tv[k - 1], ti[k - 1])) {
      const float fv = tv[k];
      tv[k] = tv[k - 1];
      tv[k - 1] = fv;
      const int fi = ti[k];
      ti[k] = ti[k - 1];
      ti[k - 1] = fi;
    }
  }
}

template <typename FT, int R>
__global__ void __launch_bounds__(kBeamThreads)
beam_decode_kernel(const FT* __restrict__ feat,        // [B, K, D]
                   const float* __restrict__ proj,     // [B, K, A]
                   const float* __restrict__ h0,       // [B, H]
                   const float* __restrict__ c0,       // [B, H]
                   StepWeights w, StepDims d,
                   const float* __restrict__ w_out,    // [H, V]
                   const float* __restrict__ b_out,    // [V]
                   const float* __restrict__ embed,    // [V, E]
                   int vocab, int max_length, int start_id, int end_id,
                   float* __restrict__ logits,         // [B, R, V] scratch
                   int* __restrict__ tokens,           // [B, R, L]
                   int* __restrict__ parents,          // [B, R, L]
                   float* __restrict__ scores_out) {   // [B, R]
  extern __shared__ float smem[];
  __shared__ float s_score[kMaxBeam];
  __shared__ int s_fin[kMaxBeam];
  __shared__ float s_cv[kBeamWarps];
  __shared__ int s_ci[kBeamWarps];
  __shared__ float s_sel_v[kMaxBeam];
  __shared__ int s_sel_i[kMaxBeam];
  const BeamSmem s = carve_beam_smem(smem, d, R);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = 4 * d.H;
  const int V = vocab;
  const int L = max_length;
  const FT* feat_b = feat + (size_t)b * d.K * d.D;
  const float* proj_b = proj + (size_t)b * d.K * d.A;
  float* logit_b = logits + (size_t)b * R * V;
  int* tok_b = tokens + (size_t)b * R * L;
  int* par_b = parents + (size_t)b * R * L;
  const bool head_vec = V % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(w_out) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(b_out) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(logits) % 16 == 0;

  // every beam starts from the image's state and <start>; only beam 0 live
  for (int j = tid; j < R * d.H; j += kBeamThreads) {
    s.h[j] = h0[(size_t)b * d.H + j % d.H];
    s.c[j] = c0[(size_t)b * d.H + j % d.H];
  }
  for (int j = tid; j < R * d.E; j += kBeamThreads)
    s.emb[j] = embed[(size_t)start_id * d.E + j % d.E];
  if (tid < R) {
    s_score[tid] = tid == 0 ? 0.0f : kNegInf;
    s_fin[tid] = 0;
  }
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    // ---- the attention-LSTM step for the R beams --------------------------
    matvec_rows<R>(s.h, d.H, w.w_dec, d.H, d.A, s.dec, d.A, false,
                   s.partial);
    for (int j = tid; j < R * d.A; j += kBeamThreads)
      s.dec[j] += w.b_dec[j % d.A];
    __syncthreads();

    // e[r, k]: one warp per region, lanes over A, proj read once for R beams
    const float b_full = w.b_full[0];
    for (int k = warp; k < d.K; k += kBeamWarps) {
      const float* pk = proj_b + (size_t)k * d.A;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      for (int a = lane; a < d.A; a += 32) {
        const float p = pk[a];
        const float wf = w.w_full[a];
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] += fmaxf(p + s.dec[r * d.A + a], 0.0f) * wf;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r] = warp_sum(acc[r]);
        if (lane == 0) s.alpha[r * d.K + k] = acc[r] + b_full;
      }
    }
    __syncthreads();

    // softmax over K in f32, warp r for beam r
    if (warp < R) {
      float* e = s.alpha + warp * d.K;
      float m = -INFINITY;
      for (int k = lane; k < d.K; k += 32) m = fmaxf(m, e[k]);
      m = warp_max(m);
      float sum = 0.0f;
      for (int k = lane; k < d.K; k += 32) {
        const float ex = expf(e[k] - m);
        e[k] = ex;
        sum += ex;
      }
      sum = warp_sum(sum);
      for (int k = lane; k < d.K; k += 32) e[k] = e[k] / sum;
    }
    __syncthreads();

    // ctx = alpha F (features read once for R beams, upcast as read);
    // gated = sigmoid(h W_fb + b) ctx
    matvec_rows<R>(s.alpha, d.K, feat_b, d.K, d.D, s.ctx, d.D, false,
                   s.partial);
    matvec_rows<R>(s.h, d.H, w.w_fb, d.H, d.D, s.gate, d.D, false,
                   s.partial);
    for (int j = tid; j < R * d.D; j += kBeamThreads)
      s.ctx[j] = sigmoid_f32(s.gate[j] + w.b_fb[j % d.D]) * s.ctx[j];
    __syncthreads();

    // gates = emb W_ih_e + gated W_ih_c + h W_hh + b; LSTM tail (i, f, g, o)
    matvec_rows<R>(s.emb, d.E, w.w_ih_e, d.E, G, s.gates, G, false,
                   s.partial);
    matvec_rows<R>(s.ctx, d.D, w.w_ih_c, d.D, G, s.gates, G, true,
                   s.partial);
    matvec_rows<R>(s.h, d.H, w.w_hh, d.H, G, s.gates, G, true, s.partial);
    for (int j = tid; j < R * d.H; j += kBeamThreads) {
      const int r = j / d.H;
      const int i = j - r * d.H;
      const float* g = s.gates + r * G;
      const float ig = sigmoid_f32(g[i] + w.b_lstm[i]);
      const float fg = sigmoid_f32(g[d.H + i] + w.b_lstm[d.H + i]);
      const float gg = tanhf(g[2 * d.H + i] + w.b_lstm[2 * d.H + i]);
      const float og = sigmoid_f32(g[3 * d.H + i] + w.b_lstm[3 * d.H + i]);
      const float c_new = fg * s.c[j] + ig * gg;
      s.c[j] = c_new;
      s.h[j] = og * tanhf(c_new);
    }
    __syncthreads();

    // ---- head: logits of the R beams, W_out read once ----------------------
    float m[R];
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = -INFINITY;
    if (head_vec) {
      for (int q = tid; q < V / 4; q += kBeamThreads) {
        float4 acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll (beam_unroll(R))
        for (int i = 0; i < d.H; ++i) {
          const float4 wv = load4(w_out + (size_t)i * V + 4 * q);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float hi = s.h[r * d.H + i];
            acc[r].x += hi * wv.x;
            acc[r].y += hi * wv.y;
            acc[r].z += hi * wv.z;
            acc[r].w += hi * wv.w;
          }
        }
        const float4 bv = load4(b_out + 4 * q);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 o = make_float4(acc[r].x + bv.x, acc[r].y + bv.y,
                                       acc[r].z + bv.z, acc[r].w + bv.w);
          *reinterpret_cast<float4*>(logit_b + (size_t)r * V + 4 * q) = o;
          m[r] = fmaxf(m[r], fmaxf(fmaxf(o.x, o.y), fmaxf(o.z, o.w)));
        }
      }
    } else {
      for (int v = tid; v < V; v += kBeamThreads) {
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll (beam_unroll(R))
        for (int i = 0; i < d.H; ++i) {
          const float wv = w_out[(size_t)i * V + v];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] += s.h[r * d.H + i] * wv;
        }
        const float bv = b_out[v];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float o = acc[r] + bv;
          logit_b[(size_t)r * V + v] = o;
          m[r] = fmaxf(m[r], o);
        }
      }
    }
    block_reduce_rows<R, true>(m, s.red);  // its barrier publishes logits

    // ---- log-softmax per beam row ------------------------------------------
    float lse[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float sum = 0.0f;
      for (int v = tid; v < V; v += kBeamThreads)
        sum += expf(logit_b[(size_t)r * V + v] - m[r]);
      lse[r] = sum;
    }
    block_reduce_rows<R, false>(lse, s.red);
#pragma unroll
    for (int r = 0; r < R; ++r) lse[r] = logf(lse[r]);

    // ---- total = score + lp (finished: <end> at 0, the rest -1e9); top-W --
    float tv[R];
    int ti[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      tv[r] = -INFINITY;
      ti[r] = INT_MAX;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float score = s_score[r];
      const bool fin = s_fin[r] != 0;
      for (int v = tid; v < V; v += kBeamThreads) {
        const float lp =
            fin ? (v == end_id ? 0.0f : kNegInf)
                : (logit_b[(size_t)r * V + v] - m[r]) - lse[r];
        insert_top<R>(score + lp, r * V + v, tv, ti);
      }
    }
    // R rounds: each thread offers its best remaining candidate, the block's
    // best wins and its owner drops it (flat indices are unique)
    for (int j = 0; j < R; ++j) {
      float bv = tv[0];
      int bi = ti[0];
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ranks_before(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        s_cv[warp] = bv;
        s_ci[warp] = bi;
      }
      __syncthreads();
      if (tid == 0) {
        for (int i = 1; i < kBeamWarps; ++i) {
          if (ranks_before(s_cv[i], s_ci[i], bv, bi)) {
            bv = s_cv[i];
            bi = s_ci[i];
          }
        }
        s_sel_v[j] = bv;
        s_sel_i[j] = bi;
      }
      __syncthreads();
      if (ti[0] == s_sel_i[j]) {
#pragma unroll
        for (int k = 0; k + 1 < R; ++k) {
          tv[k] = tv[k + 1];
          ti[k] = ti[k + 1];
        }
        tv[R - 1] = -INFINITY;
        ti[R - 1] = INT_MAX;
      }
    }

    // ---- reorder by parent, embed, record -----------------------------------
    for (int j = tid; j < R * d.H; j += kBeamThreads) {
      s.gates[j] = s.h[j];
      s.gates[R * d.H + j] = s.c[j];
    }
    int new_fin = 0;
    if (tid < R) {
      const int parent = s_sel_i[tid] / V;
      const int token = s_sel_i[tid] - parent * V;
      new_fin = (s_fin[parent] != 0 || token == end_id) ? 1 : 0;
      tok_b[tid * L + t] = token;
      par_b[tid * L + t] = parent;
    }
    __syncthreads();
    for (int j = tid; j < R * d.H; j += kBeamThreads) {
      const int r = j / d.H;
      const int i = j - r * d.H;
      const int parent = s_sel_i[r] / V;
      s.h[j] = s.gates[parent * d.H + i];
      s.c[j] = s.gates[R * d.H + parent * d.H + i];
    }
    for (int j = tid; j < R * d.E; j += kBeamThreads) {
      const int r = j / d.E;
      const int token = s_sel_i[r] % V;
      s.emb[j] = embed[(size_t)token * d.E + (j - r * d.E)];
    }
    if (tid < R) {
      s_fin[tid] = new_fin;
      s_score[tid] = s_sel_v[tid];
    }
    __syncthreads();

    bool all_done = true;
#pragma unroll
    for (int r = 0; r < R; ++r) all_done = all_done && s_fin[r] != 0;
    if (all_done) {  // the same for every thread: a uniform exit
      const int rest = L - t - 1;
      for (int j = tid; j < R * rest; j += kBeamThreads) {
        const int r = j / rest;
        const int u = t + 1 + (j - r * rest);
        tok_b[r * L + u] = end_id;
        par_b[r * L + u] = r;
      }
      break;
    }
  }
  if (tid < R) scores_out[(size_t)b * R + tid] = s_score[tid];
}

template <typename FT, int R>
cudaError_t launch_beam(const void* feat, const float* proj, const float* h0,
                        const float* c0, const StepWeights& w,
                        const StepDims& d, const float* w_out,
                        const float* b_out, const float* embed, int vocab,
                        int max_length, int start_id, int end_id,
                        float* logits, int* tokens, int* parents,
                        float* scores, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)beam_smem_floats(d, R);
  cudaError_t err = cudaFuncSetAttribute(
      beam_decode_kernel<FT, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  beam_decode_kernel<FT, R><<<batch, kBeamThreads, smem, stream>>>(
      static_cast<const FT*>(feat), proj, h0, c0, w, d, w_out, b_out, embed,
      vocab, max_length, start_id, end_id, logits, tokens, parents, scores);
  return cudaGetLastError();
}

template <typename FT>
cudaError_t launch_beam_width(int beam, const void* feat, const float* proj,
                              const float* h0, const float* c0,
                              const StepWeights& w, const StepDims& d,
                              const float* w_out, const float* b_out,
                              const float* embed, int vocab, int max_length,
                              int start_id, int end_id, float* logits,
                              int* tokens, int* parents, float* scores,
                              int batch, cudaStream_t st) {
#define DCAP_BEAM_CASE(R)                                                  \
  case R:                                                                  \
    return launch_beam<FT, R>(feat, proj, h0, c0, w, d, w_out, b_out,      \
                              embed, vocab, max_length, start_id, end_id,  \
                              logits, tokens, parents, scores, batch, st);
  switch (beam) {
    DCAP_BEAM_CASE(2)
    DCAP_BEAM_CASE(3)
    DCAP_BEAM_CASE(4)
    DCAP_BEAM_CASE(5)
    default:
      return cudaErrorInvalidValue;
  }
#undef DCAP_BEAM_CASE
}

}  // namespace dcap

extern "C" int dcap_beam_decode(
    const void* feat, int feat_bf16, const float* proj, const float* h0,
    const float* c0, const float* w_dec, const float* b_dec,
    const float* w_full, const float* b_full, const float* w_fb,
    const float* b_fb, const float* w_ih_e, const float* w_ih_c,
    const float* w_hh, const float* b_lstm, const float* w_out,
    const float* b_out, const float* embed, float* logits, int* tokens,
    int* parents, float* scores, int batch, int k, int d, int a, int e,
    int hdim, int vocab, int beam, int max_length, int start_id, int end_id,
    void* stream) {
  const dcap::StepWeights w{w_dec, b_dec, w_full, b_full, w_fb,
                            b_fb,  w_ih_e, w_ih_c, w_hh, b_lstm};
  const dcap::StepDims dims{k, d, a, e, hdim};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      feat_bf16
          ? dcap::launch_beam_width<__nv_bfloat16>(
                beam, feat, proj, h0, c0, w, dims, w_out, b_out, embed, vocab,
                max_length, start_id, end_id, logits, tokens, parents, scores,
                batch, st)
          : dcap::launch_beam_width<float>(
                beam, feat, proj, h0, c0, w, dims, w_out, b_out, embed, vocab,
                max_length, start_id, end_id, logits, tokens, parents, scores,
                batch, st);
  return static_cast<int>(err);
}
