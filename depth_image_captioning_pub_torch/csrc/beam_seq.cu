// Whole beam search in ONE cooperative launch: a persistent grid of one CTA
// per SM, the search loop inside the launch, and the decoder's weights
// resident in shared memory, on the phases of decode_phases.cuh.
//
// Replaces the TPU kernel
// depth_image_captioning_pub_tpu/ops/pallas/beam_seq.py::fused_beam_decode
// (pallas_call body `_make_kernel`), the search of ops/decode.beam_search.
// The search has R = B*W beam rows; rows b*W .. b*W+W-1 are image b's. At
// step 0 every beam of image b starts from image b's state and <start>,
// and beam 0 alone is live (scores 0, -1e9, ...). A step is four phases
// between grid barriers:
//
//   A  (image, D-chunk) items over all CTAs. An item reads its image's
//      proj and its feature chunk ONCE for the W beams: per beam the scores
//      from its parent's dec, an f32 softmax over K, the context over the
//      chunk and gated = sigmoid(gp[parent]) * ctx, into a [R, D] scratch.
//      Features stay per image, never tiled by beam.
//   G  gates_phase over the R rows: [emb(token) | gated | h[parent]] and
//      c[parent] -> h', c'
//   H  hproducts_phase of h': dec and gp of every row for step t+1, and the
//      row's full logits into a [R, V] scratch (12.7 MB at B=64, W=5,
//      inside the 50 MB L2)
//   T  per image, on CTA b % ctas: each of its W rows' log-softmax (max and
//      sum of exp in one pass, the lse, then the top-W pass), finished
//      beams restricted to <end> at 0 and -1e9 elsewhere, total = score +
//      lp, and the flat top-W over W*V in lax.top_k's order (larger value
//      first, then the lower flat index w*V + v); then the step's records
//      (token, parent), the scores and finished flags, and for step t+1
//      each row's token and src[r] = b*W + parent. Top-W runs on the exact
//      totals of all W*V candidates: score + (x - m) - lse rounds distinct
//      logits to equal totals, so a cut by logit could drop a winner.
//
// The beams' reorder is a row map, not a copy: step t+1 reads its parents'
// h, c, dec and gp through src. A row reads its parent's h and c while
// another row writes its own, so both are double-buffered. Once T leaves
// every beam of every image finished, every CTA sees the same flags after
// the barrier; the owners fill the remaining records with <end> and
// identity parents (what those steps would give: ops/decode.beam_search's
// early-exit argument) and the grid leaves the loop. Every sum has a fixed
// order and there is no float atomic: repeated calls are bit-identical.
//
// What bounds it on an H100: A streams the features once per step (B x K x
// D bf16, 51 MB at B=64, the same stream as the greedy kernel's, not W
// times it); G and H do R x (E+D+H) x 4H and R x 12,132 x H FMAs (377 and
// 497 M at B=64, W=5) from weights in shared memory, every CTA reading the
// rows' inputs from L2; T reads an image's W x V logits twice on one CTA.
// The planner (ops/kernels/beam_seq.plan_beam) sizes the slices, units,
// items, row tile and shared memory; the launcher checks the carve against
// it. Plain C interface, loaded with ctypes (ops/kernels/_build.py); returns
// the cudaError_t of the launch. Build without --use_fast_math.
#include "decode_phases.cuh"

namespace dcap {
namespace seq {
namespace beam {

constexpr int kMaxBeam = 8;
constexpr float kNegInf = -1e9f;  // ops/decode.NEG_INF
constexpr int kBeamHRows = 4;     // rows of a thread's h-product tile
constexpr int kBeamGRows = 2;     // rows of a warp's gate products
constexpr int kCtxUnroll = 4;     // feature rows in flight per thread in A

struct Params : PhaseParams {
  float* logits;   // [R, V] scratch
  int* tokens;     // [B, W, L] records: the token beam w chose at t
  int* parents;    // [B, W, L]          and its parent beam
  float* scores;   // [B, W] the running, then the final scores
  int beam;        // W
};

// Phase A's partial sums: per beam, warp slices x chunk columns (at most
// kWarps x 8 groups of 16 bytes); the gate products need fewer (kWarps x
// kGUnits x kBeamGRows x 4).
__host__ __device__ inline long part_floats(int W) {
  return 8L * kWarps * 8 * W;
}

// Shared memory in floats; the same sum as ops/kernels/beam_seq.plan_beam.
__host__ __device__ inline long smem_floats(const Params& q) {
  const StepDims& d = q.d;
  const int W = q.beam;
  return (long)d.H * q.h_cols + (long)q.units * (d.E + d.D + d.H) * 4 +
         (long)q.h_rows * (d.H + 4) + part_floats(W) + d.A + (long)W * d.A +
         q.h_cols + 4L * q.units + 2L * q.h_rows * (q.h_cols / 4) +
         (long)W * d.K;
}

__device__ inline Smem carve_smem(float* base, const Params& q) {
  const StepDims& d = q.d;
  const int W = q.beam;
  Smem s;
  s.wh = base;
  s.wg = s.wh + (size_t)d.H * q.h_cols;
  s.ht = s.wg + (size_t)q.units * (d.E + d.D + d.H) * 4;
  // float4-read arrays first: every size before them is a multiple of 4
  s.part = s.ht + (size_t)q.h_rows * (d.H + 4);
  s.wfull = s.part + part_floats(W);
  s.dec = s.wfull + d.A;          // [W, A] the item's parents' dec
  s.bh = s.dec + (size_t)W * d.A;
  s.bg = s.bh + q.h_cols;
  s.cv = s.bg + 4 * q.units;      // [h_rows, h_cols/4] the head's (max,
  s.ci = reinterpret_cast<int*>(s.cv + q.h_rows * (q.h_cols / 4));  // sum)
  s.alpha = reinterpret_cast<float*>(s.ci + q.h_rows * (q.h_cols / 4));
  // [W, K]
  s.red = nullptr;                // the reductions use static arrays
  return s;
}

// Scratch in global memory, written and read by different CTAs (read with
// __ldcg: L1 is not coherent across SMs): R * (2D + A + 4H + 2 ctas) + B *
// chunks * W floats, 2 + 3R + B * chunks * W ints.
struct Scratch {
  float* gated;  // [R, D]
  float* dec;    // [R, A]  h W_dec + b_dec of each row's h
  float* gp;     // [R, D]  h W_fb + b_fb
  float* h;      // [2, R, H]
  float* c;      // [2, R, H]
  int* tok;      // [R] the token row r feeds to the next step
  int* src;      // [R] the row whose h, c, dec, gp row r reads: its parent
  int* fin;      // [R] finished flags
  float* part_m;  // [R, ctas] each row's max over each CTA's vocab columns
  float* part_l;  // [R, ctas]            and sum of exp(x - max)
  float* cand_v;  // [B, chunks, W] each image's top-W over each vocabulary
  int* cand_i;    // [B, chunks, W]  chunk (chunks <= max(1, ctas / B)) and
                  //                 its flat index w * V + v
};

__device__ inline Scratch carve_scratch(const Params& q) {
  const long R = (long)q.batch * q.beam;
  Scratch x;
  x.gated = q.fscr;
  x.dec = x.gated + R * q.d.D;
  x.gp = x.dec + R * q.d.A;
  x.h = x.gp + R * q.d.D;
  x.c = x.h + 2 * R * q.d.H;
  x.part_m = x.c + 2 * R * q.d.H;
  x.part_l = x.part_m + R * q.ctas;
  x.cand_v = x.part_l + R * q.ctas;
  x.tok = q.iscr + 2;
  x.src = x.tok + R;
  x.fin = x.src + R;
  x.cand_i = x.fin + R;
  return x;
}

// Phase A: (image, D-chunk) items over the CTAs, the W beams of the image
// at once. The context: a warp takes 8 column groups of 16 bytes, its four
// 8-lane quarters each over a quarter of its part of K (so a quarter reads
// 128 contiguous bytes of a feature row); the quarters meet by shuffles,
// and with few column groups several warps split K further and meet in
// shared memory in warp order.
template <typename FT, int W>
__device__ void attention_phase(const Params& q, const Smem& s,
                                const Scratch& x, const FT* feat,
                                int images) {
  __shared__ int s_src[kMaxBeam];
  const StepDims& d = q.d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunks = (d.D + q.a_chunk - 1) / q.a_chunk;
  const float b_full = q.w.b_full[0];
  // scores: `parts` adjacent lanes per region, each over every parts-th
  // float4 of A, summed by shuffles in a fixed order
  int parts = 1;
  while (parts < 32 && 2 * parts * d.K <= kThreads) parts *= 2;
  const int a4 = d.A / 4;
  const float4* dec4 = reinterpret_cast<const float4*>(s.dec);
  const float4* wf4 = reinterpret_cast<const float4*>(s.wfull);
  constexpr int kVec = 16 / sizeof(FT);
  for (int item = blockIdx.x; item < images * chunks; item += q.ctas) {
    const int b = item / chunks;
    const int d0 = (item % chunks) * q.a_chunk;
    const int wd = min(q.a_chunk, d.D - d0);
    if (tid < W) s_src[tid] = __ldcg(x.src + b * W + tid);
    __syncthreads();
    for (int j = tid; j < W * d.A; j += kThreads)
      s.dec[j] = __ldcg(x.dec + (size_t)s_src[j / d.A] * d.A + j % d.A);
    __syncthreads();
    const float* proj_b = q.proj + (size_t)b * d.K * d.A;
    for (int k0 = 0; k0 < d.K; k0 += kThreads / parts) {
      const int k = k0 + tid / parts;
      const int part = tid % parts;
      float acc[W];
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = 0.0f;
      if (k < d.K) {
        const float4* pk =
            reinterpret_cast<const float4*>(proj_b + (size_t)k * d.A);
#pragma unroll 4
        for (int a = part; a < a4; a += parts) {
          const float4 p = pk[a];
          const float4 wv = wf4[a];
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const float4 dv = dec4[w * a4 + a];
            acc[w] += fmaxf(p.x + dv.x, 0.0f) * wv.x;
            acc[w] += fmaxf(p.y + dv.y, 0.0f) * wv.y;
            acc[w] += fmaxf(p.z + dv.z, 0.0f) * wv.z;
            acc[w] += fmaxf(p.w + dv.w, 0.0f) * wv.w;
          }
        }
      }
      for (int o = parts / 2; o > 0; o >>= 1)
#pragma unroll
        for (int w = 0; w < W; ++w)
          acc[w] += __shfl_xor_sync(0xffffffffu, acc[w], o);
      if (k < d.K && part == 0)
#pragma unroll
        for (int w = 0; w < W; ++w) s.alpha[w * d.K + k] = acc[w] + b_full;
    }
    __syncthreads();
    // softmax over K in f32, warp w for beam w
    if (warp < W) {
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
    // the context over the chunk for the W beams, features read once
    const int groups = wd / kVec;
    const int gblocks = (groups + 7) / 8;
    const int ws = max(1, kWarps / gblocks);  // warps over one block's K
    const int rows = (d.K + 4 * ws - 1) / (4 * ws);
    const int lg = lane & 7;
    const int quarter = lane >> 3;
    const int wsl = warp % ws;
    const FT* fr = feat + (size_t)b * d.K * d.D + d0;
    for (int gb = warp / ws; gb < gblocks; gb += kWarps / ws) {
      const int g = gb * 8 + lg;
      const bool act = g < groups;
      const int k0 = (wsl * 4 + quarter) * rows;
      const int k1 = min(d.K, k0 + rows);
      float acc[W][kVec];
#pragma unroll
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[w][c] = 0.0f;
      if (act) {
        const FT* col = fr + kVec * g;
#pragma unroll (kCtxUnroll)
        for (int k = k0; k < k1; ++k) {
          float f[kVec];
          load16(col + (size_t)k * d.D, f);
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const float al = s.alpha[w * d.K + k];
#pragma unroll
            for (int c = 0; c < kVec; ++c) acc[w][c] += al * f[c];
          }
        }
      }
      // the four quarters' sums, the same in each quarter
#pragma unroll
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          acc[w][c] += __shfl_xor_sync(0xffffffffu, acc[w][c], 8);
          acc[w][c] += __shfl_xor_sync(0xffffffffu, acc[w][c], 16);
        }
      if (!act || quarter != 0) continue;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (ws == 1) {
          const float* gpr =
              x.gp + (size_t)s_src[w] * d.D + d0 + kVec * g;
          float* out = x.gated + (size_t)(b * W + w) * d.D + d0 + kVec * g;
#pragma unroll
          for (int c = 0; c < kVec; c += 4) {
            const float4 gp = __ldcg(reinterpret_cast<const float4*>(gpr + c));
            *reinterpret_cast<float4*>(out + c) = make_float4(
                sigmoid_f32(gp.x) * acc[w][c],
                sigmoid_f32(gp.y) * acc[w][c + 1],
                sigmoid_f32(gp.z) * acc[w][c + 2],
                sigmoid_f32(gp.w) * acc[w][c + 3]);
          }
        } else {
          float* dst = s.part + ((size_t)wsl * W + w) * wd + kVec * g;
#pragma unroll
          for (int c = 0; c < kVec; ++c) dst[c] = acc[w][c];
        }
      }
    }
    if (ws > 1) {
      __syncthreads();
      for (int j = tid; j < W * wd; j += kThreads) {
        const int w = j / wd;
        const int col = j - w * wd;
        float v = s.part[(size_t)w * wd + col];
        for (int sl = 1; sl < ws; ++sl)
          v += s.part[((size_t)sl * W + w) * wd + col];
        x.gated[(size_t)(b * W + w) * d.D + d0 + col] =
            sigmoid_f32(__ldcg(x.gp + (size_t)s_src[w] * d.D + d0 + col)) * v;
      }
    }
    __syncthreads();
  }
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

// W rounds of a block-wide argmax in lax.top_k's order over the threads'
// sorted top-W lists (tv, ti): each thread offers its best remaining
// candidate, the block's best wins and its owner drops it (flat indices are
// unique). The winners land in sel_v/sel_i; every thread calls it.
template <int W>
__device__ void block_top(float (&tv)[W], int (&ti)[W], float* sel_v,
                          int* sel_i) {
  __shared__ float s_cv[kWarps];
  __shared__ int s_ci[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = 0; j < W; ++j) {
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
      for (int i = 1; i < kWarps; ++i) {
        if (ranks_before(s_cv[i], s_ci[i], bv, bi)) {
          bv = s_cv[i];
          bi = s_ci[i];
        }
      }
      sel_v[j] = bv;
      sel_i[j] = bi;
    }
    __syncthreads();
    if (ti[0] == sel_i[j]) {
#pragma unroll
      for (int k = 0; k + 1 < W; ++k) {
        tv[k] = tv[k + 1];
        ti[k] = ti[k + 1];
      }
      tv[W - 1] = -INFINITY;
      ti[W - 1] = INT_MAX;
    }
  }
}

// The vocabulary chunks of phase T1: about ctas items in all.
__device__ inline int vocab_chunks(const Params& q) {
  return max(1, min(q.ctas / q.batch, q.vocab));
}

// Phase T1: (image, vocabulary chunk) items over the CTAs. An item takes
// its image's W rows' max M and lse from the CTAs' partials of phase H
// (a warp per row: the max, then the sums rescaled to it, in a fixed order,
// so every item of the image gets the same numbers), then the image's top-W
// over the chunk in the exact totals the search ranks by: score + ((x - M)
// - lse), or for a finished beam score + 0 at <end> and score - 1e9
// elsewhere. The union of the chunks' top-W holds the image's top-W.
template <int W>
__device__ void topw_chunks_phase(const Params& q, const Scratch& x,
                                  int images) {
  __shared__ float s_m[kMaxBeam], s_lse[kMaxBeam], s_score[kMaxBeam];
  __shared__ int s_fin[kMaxBeam];
  __shared__ float s_sel_v[kMaxBeam];
  __shared__ int s_sel_i[kMaxBeam];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int V = q.vocab;
  const int chunks = vocab_chunks(q);
  for (int item = blockIdx.x; item < images * chunks; item += q.ctas) {
    const int b = item / chunks;
    const int c = item % chunks;
    const int vlo = (int)((long)c * V / chunks);
    const int nv = (int)((long)(c + 1) * V / chunks) - vlo;
    if (warp < W) {
      const int r = b * W + warp;
      const float* pm = x.part_m + (size_t)r * q.ctas;
      const float* pl = x.part_l + (size_t)r * q.ctas;
      float m = -INFINITY;
      for (int p = lane; p < q.ctas; p += 32) m = fmaxf(m, __ldcg(pm + p));
      m = warp_max(m);
      float l = 0.0f;
      for (int p = lane; p < q.ctas; p += 32) {
        const float mp = __ldcg(pm + p);
        if (mp != -INFINITY) l += __ldcg(pl + p) * expf(mp - m);
      }
      l = warp_sum(l);
      if (lane == 0) {
        s_m[warp] = m;
        s_lse[warp] = logf(l);
        s_score[warp] = __ldcg(q.scores + r);
        s_fin[warp] = __ldcg(x.fin + r);
      }
    }
    __syncthreads();
    float tv[W];
    int ti[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      tv[k] = -INFINITY;
      ti[k] = INT_MAX;
    }
    const float* lg = q.logits + (size_t)b * W * V;
    // a column of all W rows at a time: W loads in flight together
#pragma unroll 2
    for (int v = vlo + tid; v < vlo + nv; v += kThreads) {
      float xv[W];
#pragma unroll
      for (int r = 0; r < W; ++r)  // a finished row's lp reads no logit
        xv[r] = s_fin[r] ? 0.0f : __ldcg(lg + (size_t)r * V + v);
#pragma unroll
      for (int r = 0; r < W; ++r) {
        const float lp = s_fin[r] ? (v == q.end_id ? 0.0f : kNegInf)
                                  : (xv[r] - s_m[r]) - s_lse[r];
        insert_top<W>(s_score[r] + lp, r * V + v, tv, ti);
      }
    }
    block_top<W>(tv, ti, s_sel_v, s_sel_i);
    if (tid < W) {
      const size_t at = (size_t)item * W + tid;
      x.cand_v[at] = s_sel_v[tid];
      x.cand_i[at] = s_sel_i[tid];
    }
    __syncthreads();  // s_* of the next item
  }
}

// Phase T2, on the owner of each image (b % ctas): the image's top-W from
// its chunks' candidates, then the step's records, the scores and finished
// flags, and for step t+1 each row's token and its parent's row.
template <int W>
__device__ void select_phase(const Params& q, const Scratch& x, int images,
                             int t) {
  __shared__ float s_sel_v[kMaxBeam];
  __shared__ int s_sel_i[kMaxBeam];
  const int tid = threadIdx.x;
  const int V = q.vocab;
  const int L = q.max_length;
  const int n = vocab_chunks(q) * W;
  for (int b = blockIdx.x; b < images; b += q.ctas) {
    float tv[W];
    int ti[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      tv[k] = -INFINITY;
      ti[k] = INT_MAX;
    }
    for (int i = tid; i < n; i += kThreads)
      insert_top<W>(__ldcg(x.cand_v + (size_t)b * n + i),
                    __ldcg(x.cand_i + (size_t)b * n + i), tv, ti);
    block_top<W>(tv, ti, s_sel_v, s_sel_i);
    // the parents' flags are read before any row's flag is written
    int parent = 0, token = 0, parent_fin = 0;
    if (tid < W) {
      parent = s_sel_i[tid] / V;
      token = s_sel_i[tid] - parent * V;
      parent_fin = __ldcg(x.fin + b * W + parent);
    }
    __syncthreads();
    if (tid < W) {
      const int r = b * W + tid;
      x.fin[r] = (parent_fin != 0 || token == q.end_id) ? 1 : 0;
      q.scores[r] = s_sel_v[tid];
      x.tok[r] = token;
      x.src[r] = b * W + parent;
      q.tokens[(size_t)r * L + t] = token;
      q.parents[(size_t)r * L + t] = parent;
    }
    __syncthreads();  // s_sel_* of the next image
  }
}

template <typename FT, int W>
__global__ void __launch_bounds__(kThreads, 1) beam_kernel(const Params q) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve_smem(reinterpret_cast<float*>(smem_raw), q);
  const Scratch x = carve_scratch(q);
  const StepDims& d = q.d;
  const int images = q.batch;
  const int rows = images * W;
  const int L = q.max_length;
  const FT* feat = static_cast<const FT*>(q.feat);
  load_slices(q, s);
  // every beam starts from its image's row and <start>; only beam 0 live
  for (int r = blockIdx.x + threadIdx.x * q.ctas; r < rows;
       r += kThreads * q.ctas) {
    x.tok[r] = q.start_id;
    x.src[r] = r / W;
    x.fin[r] = 0;
    q.scores[r] = r % W == 0 ? 0.0f : kNegInf;
  }
  __syncthreads();  // load_slices' writes, before the first tile
  const HOut out{x.dec, x.gp, nullptr, nullptr, q.logits, x.part_m, x.part_l};
  hproducts_phase<true, kBeamHRows>(q, s, out, q.h0, images, false);  // dec, gp of h0
  grid_sync(q);
  for (int t = 0; t < L; ++t) {
    if (t > 0) {
      bool all = true;
      for (int r = threadIdx.x; r < rows; r += kThreads)
        all = all && __ldcg(x.fin + r);
      if (__syncthreads_and(all)) {  // the same in every CTA
        const int rest = L - t;
        for (int b = blockIdx.x; b < images; b += q.ctas)
          for (int j = threadIdx.x; j < W * rest; j += kThreads) {
            const int w = j / rest;
            const size_t at = (size_t)(b * W + w) * L + t + (j - w * rest);
            q.tokens[at] = q.end_id;
            q.parents[at] = w;
          }
        return;
      }
    }
    attention_phase<FT, W>(q, s, x, feat, images);
    grid_sync(q);
    const size_t prev = (size_t)((t + 1) & 1) * rows * d.H;
    const size_t next = (size_t)(t & 1) * rows * d.H;
    gates_phase<true, kBeamGRows>(q, s, x.gated, x.tok, x.src, t == 0 ? q.h0 : x.h + prev,
                      t == 0 ? q.c0 : x.c + prev, x.h + next, x.c + next,
                      rows);
    grid_sync(q);
    hproducts_phase<true, kBeamHRows>(q, s, out, x.h + next, rows, true);
    grid_sync(q);
    topw_chunks_phase<W>(q, x, images);
    grid_sync(q);
    select_phase<W>(q, x, images, t);
    if (t + 1 < L) grid_sync(q);
  }
}

template <typename FT, int W>
const void* kernel_fn() {
  return reinterpret_cast<const void*>(beam_kernel<FT, W>);
}

template <typename FT>
const void* kernel_for(int beam) {
  switch (beam) {
    case 2: return kernel_fn<FT, 2>();
    case 3: return kernel_fn<FT, 3>();
    case 4: return kernel_fn<FT, 4>();
    case 5: return kernel_fn<FT, 5>();
    case 6: return kernel_fn<FT, 6>();
    case 7: return kernel_fn<FT, 7>();
    case 8: return kernel_fn<FT, 8>();
    default: return nullptr;
  }
}

// The grid must be co-resident: the caller sizes it with max_ctas, and
// cudaLaunchCooperativeKernel refuses a larger one
// (cudaErrorCooperativeLaunchTooLarge).
cudaError_t launch(const void* fn, const Params& q, int smem,
                   cudaStream_t stream) {
  if (fn == nullptr) return cudaErrorInvalidValue;  // no such beam width
  if (smem_floats(q) * (long)sizeof(float) > smem)
    return cudaErrorInvalidValue;  // the planner and the carve disagree
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

int max_ctas(const void* fn, int smem) {
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
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

const void* kernel_of(int feat_bf16, int beam) {
  return feat_bf16 ? kernel_for<__nv_bfloat16>(beam) : kernel_for<float>(beam);
}

}  // namespace beam
}  // namespace seq
}  // namespace dcap

// The number of CTAs that can be co-resident at `smem` bytes of dynamic
// shared memory (blocks per SM x SMs), or minus a cudaError_t.
extern "C" int dcap_beam_max_ctas(int feat_bf16, int beam, int smem) {
  namespace kb = dcap::seq::beam;
  return kb::max_ctas(kb::kernel_of(feat_bf16, beam), smem);
}

extern "C" int dcap_beam_decode(
    const void* feat, int feat_bf16, const float* proj, const float* h0,
    const float* c0, const float* w_dec, const float* b_dec,
    const float* w_full, const float* b_full, const float* w_fb,
    const float* b_fb, const float* w_ih_e, const float* w_ih_c,
    const float* w_hh, const float* b_lstm, const float* w_out,
    const float* b_out, const float* embed, float* logits, int* tokens,
    int* parents, float* scores, float* fscr, int* iscr, int batch, int k,
    int d, int a, int e, int hdim, int vocab, int beam, int max_length,
    int start_id, int end_id, int ctas, int h_cols, int units, int a_chunk,
    int h_rows, int smem, void* stream) {
  namespace kb = dcap::seq::beam;
  kb::Params q;
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
  q.logits = logits;
  q.tokens = tokens;
  q.parents = parents;
  q.scores = scores;
  q.beam = beam;
  const cudaError_t err = kb::launch(kb::kernel_of(feat_bf16, beam), q, smem,
                                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
