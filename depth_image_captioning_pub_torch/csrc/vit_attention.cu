// Fused ViT attention for the DPT-hybrid's transformer blocks:
//
//   out[z] = softmax(q[z] k[z]^T * scale, keys >= n_valid -> -inf) v[z]
//
// over q/k/v [Z, N, d] (Z = batch * heads), bf16 or f32, output in v's
// dtype. Scores and the softmax are f32; the normalised p is rounded to v's
// dtype before the PV product, which accumulates in f32.
//
// Replaces the TPU kernel
// depth_image_captioning_pub_tpu/ops/pallas/vit_attention.py::fused_attention
// (pallas_call body `_kernel`), with the same rounding points.
//
// Why the TPU design does not carry over: that kernel keeps a whole [N, N]
// f32 score tile per (batch x head) in VMEM, 1.3 MB at N=577, and one SM has
// 227 KB of shared memory. Here one CTA takes one z and a tile of 32 query
// rows, and keeps only that tile's [32 x n_valid] f32 score rows in dynamic
// shared memory (74 KB at N=577):
//
//   1. Q tile -> smem (f32); loop over key tiles of 128: K tile -> smem,
//      transposed; each thread computes a 4 x 4 block of scores on CUDA
//      cores and writes them, scaled, into the score rows;
//   2. exact row max and sum in f32, one warp per 4 rows; p = exp(s - m) / l,
//      rounded to v's dtype in place;
//   3. loop over value tiles of 128: V tile -> smem; each thread accumulates
//      a 4 x (d/32) block of the output in f32; round once on store.
//
// Masked keys (>= n_valid) have p exactly 0 in the TPU kernel, so they are
// skipped here: the softmax and PV run over the first n_valid keys only.
//
// What bounds it on an H100: at N=577, d=64 the QK^T and PV products are
// 2 * 577 * 577 * 64 * 2 = 85 MFLOP per z, and this kernel runs them on the
// CUDA cores (f32 FMA from shared memory), not on the tensor cores; the
// score rows never reach device memory. Online (flash) softmax, mma.sync or
// wgmma and TMA loads are the next steps for speed, not this one.
//
// Plain C interface, loaded with ctypes (ops/kernels/_build.py). Returns the
// launch's cudaError_t; the Python wrapper raises when it is not 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace dcap {
namespace vit {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRows = 32;       // query rows per CTA: 8 warps x 4 rows
constexpr int kTile = 128;      // keys per K/V tile: 32 lanes x 4 columns

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}
// x rounded to T and back: p.astype(v.dtype) of the TPU kernel
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dynamic shared memory: the Q tile [kRows][D], one K tile [D][kTile+1]
// (transposed, padded against bank conflicts) or V tile [kTile][D] in the
// same floats, and the score rows [kRows][ld]. The Python wrapper computes
// the same sum (ops/kernels/vit_attention.smem_bytes) to refuse calls above
// the 227 KB a block may use.
__host__ __device__ constexpr int kv_floats(int D) { return D * (kTile + 1); }
__host__ __device__ inline size_t smem_bytes(int D, int ld) {
  return sizeof(float) * ((size_t)kRows * D + kv_floats(D) + (size_t)kRows * ld);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
vit_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int n,
                     int n_valid, int ld, int tiles, float scale) {
  static_assert(D % 32 == 0 && D <= 128, "head dim must be 32, 64 or 128");
  constexpr int kCols = D / 32;              // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][D]
  float* kv = qs + kRows * D;  // K tile [D][kTile+1] or V tile [kTile][D]
  float* s = kv + kv_floats(D);                 // [kRows][ld] score rows

  const int z = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kRows;
  const size_t base = (size_t)z * n * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * 4;                      // this thread's 4 rows

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[i] = q0 + r < n ? to_f32(q[base + (size_t)(q0 + r) * D + c]) : 0.f;
  }

  // 1. scores, one key tile at a time
  for (int k0 = 0; k0 < n_valid; k0 += kTile) {
    __syncthreads();   // the Q tile is in, or the last tile's readers are done
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int j = i / D, c = i % D;
      kv[c * (kTile + 1) + j] =
          k0 + j < n_valid ? to_f32(k[base + (size_t)(k0 + j) * D + c]) : 0.f;
    }
    __syncthreads();
    float acc[4][4] = {};
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(qs + (r0 + r) * D + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float kk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) kk[i] = kv[(c + cc) * (kTile + 1) + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[r][i] = fmaf(comp(qv[r], cc), kk[i], acc[r][i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + lane + 32 * i;
      if (key < n_valid) {
#pragma unroll
        for (int r = 0; r < 4; ++r) s[(r0 + r) * ld + key] = acc[r][i] * scale;
      }
    }
  }
  __syncthreads();

  // 2. exact softmax per row in f32; p rounded to v's dtype; the row's tail
  //    up to ld is zeroed for the 4-wide reads of step 3
  for (int r = r0; r < r0 + 4; ++r) {
    float* row = s + r * ld;
    float m = -INFINITY;
    for (int j = lane; j < n_valid; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n_valid; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < ld; j += 32)
      row[j] = j < n_valid ? round_to<T>(row[j] / l) : 0.f;
  }

  // 3. out = p v, one value tile at a time, f32 accumulation
  float o[4][kCols] = {};
  for (int k0 = 0; k0 < n_valid; k0 += kTile) {
    __syncthreads();   // the score rows are final / last tile's readers done
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int j = i / D;
      kv[i] = k0 + j < n_valid ? to_f32(v[base + (size_t)(k0 + j) * D + i % D])
                               : 0.f;
    }
    __syncthreads();
    const int tk = min(kTile, n_valid - k0);
    for (int j = 0; j < tk; j += 4) {
      float4 p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[r] = *reinterpret_cast<const float4*>(s + (r0 + r) * ld + k0 + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[kCols];
#pragma unroll
        for (int i = 0; i < kCols; ++i) vv[i] = kv[(j + jj) * D + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int i = 0; i < kCols; ++i)
            o[r][i] = fmaf(comp(p[r], jj), vv[i], o[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + r0 + r;
    if (row < n) {
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        out[base + (size_t)row * D + lane + 32 * i] = from_f32<T>(o[r][i]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int z, int n, int n_valid, float scale,
                   cudaStream_t stream) {
  const int ld = (n_valid + 3) & ~3;
  const int tiles = (n + kRows - 1) / kRows;
  const size_t smem = smem_bytes(D, ld);
  cudaError_t err = cudaFuncSetAttribute(
      vit_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  vit_attention_kernel<T, D><<<(unsigned)z * tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n, n_valid, ld, tiles,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int z, int n, int d, int n_valid, float scale,
                     cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, out, z, n, n_valid, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, z, n, n_valid, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, z, n, n_valid, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vit
}  // namespace dcap

extern "C" int dcap_vit_attention(const void* q, const void* k, const void* v,
                                  void* out, int is_bf16, int z, int n, int d,
                                  int n_valid, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dcap::vit::launch_d<__nv_bfloat16>(q, k, v, out, z, n, d,
                                                   n_valid, scale, st)
              : dcap::vit::launch_d<float>(q, k, v, out, z, n, d, n_valid,
                                           scale, st);
  return static_cast<int>(err);
}
