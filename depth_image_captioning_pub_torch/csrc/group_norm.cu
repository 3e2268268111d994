// GroupNorm over NHWC activations, with a fused ReLU or residual-add + ReLU
// epilogue, for the ResNetV2 backbone of the DPT-hybrid:
//
//   mean, var  of each image's group g: H*W x C/G values, f32, population
//   a[c]     = rstd[g] * weight[c],  b[c] = bias[c] - mean[g] * a[c]   (f32)
//   y        = round(x * a + b)                       x's dtype
//   y        = round(y + residual)                    with a residual, f32 add
//   y        = relu(y)                                with relu
//
// over x [B, H*W, C] contiguous (C innermost), G = 32 groups, bf16 or f32;
// weight, bias [C] and the residual [B, H*W, C] in x's dtype. These are the
// rounding points of nn.GroupNorm (f32 statistics, the fused f32 scale and
// shift, one rounding on store) followed by relu(y + shortcut) in x's dtype;
// only the order of the statistic sums differs, and on bf16 input the mean
// and rstd, which PyTorch's CUDA GroupNorm rounds to bf16 before applying
// them, stay f32 here.
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which
// fuses it with its neighbours in NHWC. PyTorch's CUDA GroupNorm takes
// NCHW-contiguous tensors only, so on the card each of the backbone's 52
// GroupNorms copied its channels_last input to NCHW, ran a moments pass and
// an apply pass, left the ReLU and the residual add to passes of their own,
// and handed the next convolution an NCHW tensor that cuDNN copied back.
//
// Bound on an H100: bytes. x read once, y written once, the residual read
// once, over 3.35 TB/s; the arithmetic is a few operations an element. At
// the backbone's largest shape (B = 64, 96 x 96, C = 256, bf16, with a
// residual) that is 453 MB, 0.135 ms.
//
// Design. Two launches, on a grid of (tile of rows of H*W, image):
//
//   1. stats_kernel: each block reads its tile once. A thread owns one
//      16-byte vector of channels (8 bf16 or 4 f32; neighbouring threads on
//      neighbouring vectors, so a warp reads 512 contiguous bytes of a row)
//      and walks the tile's rows, kUnroll rows' loads in flight at a time.
//      Each row's values of one group (the whole vector, or the vector's
//      share of a narrow group: C/G is 2 to 32 in this model) are reduced to
//      a mean and a sum of squared deviations and merged into the thread's
//      running moments (Chan's pairwise update, one reciprocal a row). The
//      block merges its threads' moments group by group (8 lanes a group,
//      then shuffles) and writes one (mean, M2) a group and tile.
//   2. apply_kernel: each block merges its image's tile partials (8 lanes a
//      group again), turns them into the per-channel scale and shift in
//      shared memory, and streams its tile: x (and the residual) in 16-byte
//      loads, the epilogue, 16-byte stores.
//
// The tiling (rows a tile, tiles an image) is the wrapper's: 16 row steps
// a tile (72 tiles an image, 4,608 blocks at the largest shape at B = 64),
// at most 128 tiles an image so that the merges in the apply pass stay
// short (ops/kernels/group_norm.py). It depends on H*W and C alone, so an
// image's statistics are summed in one order, and its output is the same
// bits, whatever the batch around it. The apply pass reads x a second
// time, from device memory at B = 64 (a stage-0 activation is 302 MB, more
// than the 50 MB L2), so the kernel moves 4/3 of its bound's bytes with a
// residual and 3/2 without.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace dcap {
namespace gn {

constexpr int kThreads = 256;
constexpr int kGroups = 32;
constexpr int kLanes = kThreads / kGroups;  // lanes that merge one group
constexpr int kUnroll = 4;                  // rows of loads in flight
constexpr int kMaxChannels = 1024;

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  __device__ static __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ static __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static __forceinline__ float round(float v) { return v; }
  __device__ static __forceinline__ float to_float(float v) { return v; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
  __device__ static __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};

// Running moments: count, mean, sum of squared deviations.
struct Moments {
  float n, mean, m2;
};

// Chan's merge of (nb, mean_b, m2b) into m; an empty side changes nothing.
__device__ __forceinline__ void merge(Moments& m, float nb, float mean_b,
                                      float m2b) {
  if (nb == 0.f) return;
  const float n = m.n + nb;
  const float d = mean_b - m.mean;
  const float f = nb / n;
  m.mean = fmaf(d, f, m.mean);
  m.m2 = m.m2 + m2b + d * d * m.n * f;
  m.n = n;
}

// Merge the moments of the kLanes consecutive lanes that hold one group;
// every lane of the group ends with the whole.
__device__ __forceinline__ void merge_lanes(Moments& m) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, m.n, off);
    const float mean_b = __shfl_xor_sync(0xffffffffu, m.mean, off);
    const float m2b = __shfl_xor_sync(0xffffffffu, m.m2, off);
    merge(m, nb, mean_b, m2b);
  }
}

// Pass 1. SUB: the values of one group in a thread's vector (C/G, at most
// the vector's kN); the vector holds kN / SUB groups' shares.
template <typename T, int SUB>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const T* __restrict__ x, float2* __restrict__ part, int hw,
                 int c, int rows_per_tile) {
  constexpr int kN = Pack<T>::kN;
  constexpr int kSub = kN / SUB;
  __shared__ float s_mean[kThreads * kSub];
  __shared__ float s_m2[kThreads * kSub];
  __shared__ float s_n[kThreads];

  const int tile = blockIdx.x, tiles = gridDim.x, b = blockIdx.y;
  const int t = threadIdx.x;
  const int vecs = c / kN;             // vectors a row
  const int rows_step = kThreads / vecs;  // rows the block reads at once
  const int v = t % vecs, r0 = t / vecs;
  const int row_begin = tile * rows_per_tile;
  const int row_end = min(hw, row_begin + rows_per_tile);
  const int cols = c / SUB;            // group shares a row

  float mean[kSub], m2[kSub];
#pragma unroll
  for (int j = 0; j < kSub; ++j) mean[j] = m2[j] = 0.f;
  int k = 0;                           // rows this thread has merged
  if (r0 < rows_step) {
    const T* base = x + (static_cast<size_t>(b) * hw) * c + v * kN;
    for (int row = row_begin + r0; row < row_end; row += kUnroll * rows_step) {
      float vals[kUnroll][kN];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int rr = row + u * rows_step;
        if (rr < row_end) Pack<T>::load(base + static_cast<size_t>(rr) * c, vals[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (row + u * rows_step >= row_end) break;
        ++k;
        const float f = 1.f / static_cast<float>(k);  // SUB / (k * SUB)
        const float n_old = static_cast<float>((k - 1) * SUB);
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < SUB; ++i) s += vals[u][j * SUB + i];
          const float mb = s * (1.f / SUB);
          float q = 0.f;
#pragma unroll
          for (int i = 0; i < SUB; ++i) {
            const float d = vals[u][j * SUB + i] - mb;
            q = fmaf(d, d, q);
          }
          const float d = mb - mean[j];
          mean[j] = fmaf(d, f, mean[j]);
          m2[j] = m2[j] + q + d * d * n_old * f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      s_mean[r0 * cols + v * kSub + j] = mean[j];
      s_m2[r0 * cols + v * kSub + j] = m2[j];
    }
    if (v == 0) s_n[r0] = static_cast<float>(k * SUB);
  }
  __syncthreads();

  // Group g's shares: columns [g * per, (g + 1) * per) of rows_step rows.
  const int g = t / kLanes, lane = t % kLanes;
  const int per = (c / kGroups) / SUB;
  const int entries = rows_step * per;
  Moments m{0.f, 0.f, 0.f};
  for (int e = lane; e < entries; e += kLanes) {
    const int r = e / per, col = g * per + e % per;
    merge(m, s_n[r], s_mean[r * cols + col], s_m2[r * cols + col]);
  }
  merge_lanes(m);
  if (lane == 0)
    part[(static_cast<size_t>(b) * tiles + tile) * kGroups + g] =
        make_float2(m.mean, m.m2);
}

// Pass 2.
template <typename T, bool kResidual, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ x, const T* __restrict__ weight,
                 const T* __restrict__ bias, const T* __restrict__ residual,
                 T* __restrict__ y, const float2* __restrict__ part, int hw,
                 int c, int rows_per_tile, float eps) {
  constexpr int kN = Pack<T>::kN;
  __shared__ float s_mean[kGroups], s_rstd[kGroups];
  __shared__ float s_a[kMaxChannels], s_b[kMaxChannels];

  const int tile = blockIdx.x, tiles = gridDim.x, b = blockIdx.y;
  const int t = threadIdx.x;
  const int cpg = c / kGroups;
  {
    const int g = t / kLanes, lane = t % kLanes;
    Moments m{0.f, 0.f, 0.f};
    for (int i = lane; i < tiles; i += kLanes) {
      const int rows = min(rows_per_tile, hw - i * rows_per_tile);
      const float2 p = part[(static_cast<size_t>(b) * tiles + i) * kGroups + g];
      merge(m, static_cast<float>(rows * cpg), p.x, p.y);
    }
    merge_lanes(m);
    if (lane == 0) {
      s_mean[g] = m.mean;
      s_rstd[g] = 1.f / sqrtf(fmaxf(m.m2 / m.n, 0.f) + eps);
    }
  }
  __syncthreads();
  for (int ch = t; ch < c; ch += kThreads) {
    const int g = ch / cpg;
    const float a = s_rstd[g] * Pack<T>::to_float(weight[ch]);
    s_a[ch] = a;
    s_b[ch] = fmaf(-a, s_mean[g], Pack<T>::to_float(bias[ch]));
  }
  __syncthreads();

  const int vecs = c / kN;
  const int rows_step = kThreads / vecs;
  const int v = t % vecs, r0 = t / vecs;
  if (r0 >= rows_step) return;
  float a[kN], sh[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    a[i] = s_a[v * kN + i];
    sh[i] = s_b[v * kN + i];
  }
  const int row_begin = tile * rows_per_tile;
  const int row_end = min(hw, row_begin + rows_per_tile);
  const size_t base = (static_cast<size_t>(b) * hw) * c + v * kN;
  for (int row = row_begin + r0; row < row_end; row += kUnroll * rows_step) {
    float vals[kUnroll][kN], res[kUnroll][kN];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = row + u * rows_step;
      if (rr < row_end) {
        Pack<T>::load(x + base + static_cast<size_t>(rr) * c, vals[u]);
        if (kResidual)
          Pack<T>::load(residual + base + static_cast<size_t>(rr) * c, res[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = row + u * rows_step;
      if (rr >= row_end) break;
      float out[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        float o = fmaf(vals[u][i], a[i], sh[i]);
        if (kResidual) o = Pack<T>::round(o) + res[u][i];
        if (kRelu) o = o < 0.f ? 0.f : o;
        out[i] = o;
      }
      Pack<T>::store(y + base + static_cast<size_t>(rr) * c, out);
    }
  }
}

template <typename T>
cudaError_t launch_stats(const T* x, float2* part, int b, int hw, int c,
                         int tiles, int rows_per_tile, cudaStream_t st) {
  const dim3 grid(tiles, b);
  const int sub = c / kGroups < Pack<T>::kN ? c / kGroups : Pack<T>::kN;
  switch (sub) {
    case 1: stats_kernel<T, 1><<<grid, kThreads, 0, st>>>(x, part, hw, c, rows_per_tile); break;
    case 2: stats_kernel<T, 2><<<grid, kThreads, 0, st>>>(x, part, hw, c, rows_per_tile); break;
    case 4: stats_kernel<T, 4><<<grid, kThreads, 0, st>>>(x, part, hw, c, rows_per_tile); break;
    case 8:
      if constexpr (Pack<T>::kN >= 8) {
        stats_kernel<T, 8><<<grid, kThreads, 0, st>>>(x, part, hw, c, rows_per_tile);
        break;
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, bool kResidual, bool kRelu>
cudaError_t launch_apply(const T* x, const T* w, const T* bias, const T* r,
                         T* y, const float2* part, int b, int hw, int c,
                         int tiles, int rows_per_tile, float eps,
                         cudaStream_t st) {
  apply_kernel<T, kResidual, kRelu><<<dim3(tiles, b), kThreads, 0, st>>>(
      x, w, bias, r, y, part, hw, c, rows_per_tile, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias,
                   const void* r, void* y, void* part, int b, int hw, int c,
                   int tiles, int rows_per_tile, float eps, int relu,
                   cudaStream_t st) {
  // the wrapper's envelope, checked again: a 16-byte vector of whole
  // groups' shares, at most kMaxChannels, and no vector split over threads
  const int sub = c / kGroups;
  if (c < kGroups || c % kGroups != 0 || c % Pack<T>::kN != 0 || c > kMaxChannels ||
      (sub < Pack<T>::kN && Pack<T>::kN % sub != 0) ||
      (sub > Pack<T>::kN && sub % Pack<T>::kN != 0) || tiles < 1 ||
      rows_per_tile < 1 || b < 1 || hw < 1)
    return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  float2* p = static_cast<float2*>(part);
  cudaError_t err = launch_stats<T>(xt, p, b, hw, c, tiles, rows_per_tile, st);
  if (err != cudaSuccess) return err;
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(bias);
  const T* rt = static_cast<const T*>(r);
  T* yt = static_cast<T*>(y);
  if (r != nullptr)
    return relu ? launch_apply<T, true, true>(xt, wt, bt, rt, yt, p, b, hw, c, tiles, rows_per_tile, eps, st)
                : launch_apply<T, true, false>(xt, wt, bt, rt, yt, p, b, hw, c, tiles, rows_per_tile, eps, st);
  return relu ? launch_apply<T, false, true>(xt, wt, bt, rt, yt, p, b, hw, c, tiles, rows_per_tile, eps, st)
              : launch_apply<T, false, false>(xt, wt, bt, rt, yt, p, b, hw, c, tiles, rows_per_tile, eps, st);
}

}  // namespace gn
}  // namespace dcap

// x, residual (nullptr: none) and y [b, hw, c], weight and bias [c], all
// bf16 (is_bf16) or f32; part: b * tiles * 32 float2 of scratch. Two
// launches on `stream`; returns the first CUDA error, or 0.
extern "C" int dcap_group_norm_nhwc(const void* x, const void* weight,
                                    const void* bias, const void* residual,
                                    void* y, void* part, int is_bf16, int b,
                                    int hw, int c, int tiles,
                                    int rows_per_tile, float eps, int relu,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dcap::gn::launch<__nv_bfloat16>(x, weight, bias, residual, y,
                                                part, b, hw, c, tiles,
                                                rows_per_tile, eps, relu, st)
              : dcap::gn::launch<float>(x, weight, bias, residual, y, part, b,
                                        hw, c, tiles, rows_per_tile, eps,
                                        relu, st);
  return static_cast<int>(err);
}
