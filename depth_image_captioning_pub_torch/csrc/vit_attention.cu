// Fused ViT attention for the DPT-hybrid's transformer blocks:
//
//   out[z] = softmax(q[z] k[z]^T * scale, keys >= n_valid -> -inf) v[z]
//
// over q/k/v [Z, N, d] (Z = batch * heads, d = 32, 64 or 128), bf16 or f32,
// output in v's dtype. Scores and the softmax are f32 (exact row max, f32
// row sum); the normalised p = exp(s - m) / l is rounded to v's dtype
// before the PV product, which accumulates in f32 and is rounded once on
// store.
//
// Replaces the TPU kernel
// depth_image_captioning_pub_tpu/ops/pallas/vit_attention.py::fused_attention
// (pallas_call body `_kernel`), with the same rounding points.
//
// Work and bound on an H100 at the DPT's shape (Z = 64 images x 12 heads,
// N = 577, d = 64, bf16): QK^T and PV are 2 * 577 * 577 * 64 * 2 = 85 MFLOP
// per z, 65.5 GFLOP per call, about 0.066 ms on the bf16 tensor cores (989
// TFLOP/s); q, k, v and out are 4 * 768 * 577 * 64 * 2 B = 227 MB, 0.068 ms
// at 3.35 TB/s. On tensor cores the products cost about what the bytes do.
//
// bf16 route (attention_bf16_kernel, the DPT's): one CTA of 4 warps per z
// and tile of 128 query rows. Each warp owns two blocks of 16 rows (one at
// d = 128, where two do not fit the registers), so every K or V fragment it
// reads from shared memory feeds two products (at one block per warp the
// ldmatrix reads alone take about 0.25 ms of shared memory's 128 B/clk per
// SM at the DPT's shape). Both products
// run on the tensor cores as mma.sync m16n8k16 bf16 with f32 accumulators,
// their B fragments read by ldmatrix (ldmatrix.trans for V). The TPU kernel
// holds a whole [N, N] f32 score tile in VMEM (1.3 MB at N = 577); an SM
// has 227 KB of shared memory, so no score row is kept here. The kernel
// walks the key tiles twice instead:
//
//   pass 1: S = (Q K^T) * scale per tile of kKeys keys, keys >= n_valid set
//           to -inf; the running row max m and row sum l = sum exp(s - m)
//           stay in registers (l rescaled when m grows), reduced over the
//           four lanes that share a row with __shfl_xor_sync;
//   pass 2: S again, by the same instructions on the same operands, so each
//           score is pass 1's bit for bit; p = exp(s - m) / l in f32,
//           rounded to bf16, and the S accumulator fragment is packed
//           straight into the A fragment of the PV mma (the m16n8 C layout
//           is the m16n8k16 A layout), so p never reaches shared memory;
//           O accumulates in f32.
//
// That keeps the Pallas kernel's rounding points: p is divided by the exact
// row sum and rounded to bf16 before PV, where flash attention would divide
// the f32 output at the end. The price is the second QK^T, 1.5x the FLOPs
// (about 0.1 ms of tensor-core time at the DPT's shape); it buys no score
// rows in shared memory and no limit on n_valid. Each score costs two
// exponentials, one per pass, and they and the f32 work around them, not
// the products, bound the kernel; so exp(s - m) is ex2.approx of
// s log2(e) - m log2(e) (one FFMA and one MUFU op) and "/ l" a product
// with 1 / l taken once per row. Both differ from expf and the IEEE
// quotient only in the last f32 bits (about 1e-6 relative), far below the
// bf16 rounding of p that follows (2^-9 relative).
//
// Q [rows x d] is copied once and held as A fragments in registers; K and V
// tiles [kKeys x d] stay bf16 in a kStages ring filled by 16-byte cp.async,
// so the next tile's copy overlaps this tile's products. Each shared-memory
// row is padded by 16 bytes, which puts the 8 rows one ldmatrix reads in 8
// different bank groups. Keys >= n_valid and query rows >= N are never read:
// their cp.async has source size 0 and fills zeros (garbage there would
// reach the mma, where 0 * NaN is NaN). The output goes out through the
// warp's Q rows in shared memory, as 16-byte stores. The tile shape (warps,
// row blocks per warp, keys per tile, stages) was chosen by timing the
// alternatives on an H100 (tools/vit_attention_ab.py; PERF.md).
//
// Later: wgmma (one warpgroup per 64 query rows, B straight from shared
// memory, S and O in the warpgroup's registers) and TMA loads driven by a
// producer warp through an mbarrier ring, which take the B fragments off
// ldmatrix and the copies off the warps that compute.
//
// f32 route (vit_attention_kernel<float, D>): CUDA cores, since f32 on the
// tensor cores would be TF32. One CTA per z and tile of 32 query rows keeps
// that tile's [32 x n_valid] f32 score rows in dynamic shared memory (74 KB
// at N = 577, so n_valid is bounded by the 227 KB a block may use):
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
// Plain C interface, loaded with ctypes (ops/kernels/_build.py). Returns the
// launch's cudaError_t; the Python wrapper raises when it is not 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dcap {
namespace vit {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRows = 32;       // query rows per CTA: 8 warps x 4 rows
constexpr int kTile = 128;      // keys per K/V tile: 32 lanes x 4 columns

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
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

// ---- bf16 route: tensor cores, two passes over the key tiles -------------

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocks = 2;            // m16 blocks of query rows per warp
constexpr int kKeys = 64;             // keys per K/V tile
constexpr int kStages = 2;            // K/V tiles in the cp.async ring

// A warp's row blocks share each K and V fragment it reads. At d = 128 the
// O and Q fragments of two blocks alone would take 192 registers, so there
// a warp takes one block.
__host__ __device__ constexpr int blocks(int D) {
  return D < 128 ? kBlocks : 1;
}
__host__ __device__ constexpr int rows(int D) {  // query rows per CTA
  return 16 * blocks(D) * kWarps;
}
// One shared-memory row of d bf16 values, padded by 16 bytes: the 8 rows an
// ldmatrix reads then start in 8 different 16-byte bank groups.
__host__ __device__ constexpr int row_bytes(int D) { return 2 * D + 16; }
// Q rows, then kStages K tiles, then kStages V tiles. The Python wrapper
// computes the same sum (ops/kernels/vit_attention.smem_bytes).
__host__ __device__ constexpr int smem_bytes(int D) {
  return (rows(D) + 2 * kStages * kKeys) * row_bytes(D);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; with full == false nothing is read and the 16
// bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// c += a b on the tensor cores: a [16 x 16] bf16 (row), b [16 x 8] bf16
// (col), c [16 x 8] f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2^x, with subnormal results flushed to 0 (p below 2^-126 rounds to a bf16
// subnormal or 0 either way)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // round to nearest
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Copy rows [row0, row0 + kRowsN) of src [n, D] into shared memory at dst;
// rows >= limit are zero-filled and never read.
template <int D, int kRowsN>
__device__ __forceinline__ void copy_rows(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int limit, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = tid; i < kRowsN * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < limit;
    cp_async16(dst + r * row_bytes(D) + c * 16,
               src + (size_t)(in ? row0 + r : 0) * D + c * 8, in);
  }
}

// This warp's scores against one K tile at kt: s[b][j] is the m16n8 C
// fragment of row block b and keys key0 + 8j .. +7, (Q K^T) * scale, keys
// >= n_valid -inf. Both passes call it, so both compute each score by the
// same instructions. Each K fragment serves the warp's B row blocks.
template <int D, int B>
__device__ __forceinline__ void tile_scores(float (&s)[B][kKeys / 8][4],
                                            const uint32_t (&qf)[B][D / 16][4],
                                            uint32_t kt, int lane, int key0,
                                            int n_valid, float scale) {
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[b][j][e] = 0.f;
  // ldmatrix.x4 over 16 keys x 16 dims: matrices (keys 0-7, dims 0-7),
  // (keys 0-7, dims 8-15), (keys 8-15, dims 0-7), (keys 8-15, dims 8-15)
  const uint32_t lane_off = ((lane & 7) + ((lane >> 4) << 3)) * row_bytes(D) +
                            (((lane >> 3) & 1) << 4);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nn = 0; nn < kKeys / 16; ++nn) {
      uint32_t f[4];
      ldmatrix_x4(f, kt + nn * 16 * row_bytes(D) + kk * 32 + lane_off);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        mma_bf16(s[b][2 * nn], qf[b][kk], f[0], f[1]);
        mma_bf16(s[b][2 * nn + 1], qf[b][kk], f[2], f[3]);
      }
    }
  }
  if (key0 + kKeys <= n_valid) {
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[b][j][e] *= scale;
  } else {  // the last tile
    const int key = key0 + 2 * (lane & 3);
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[b][j][e] = key + 8 * j + (e & 1) < n_valid ? s[b][j][e] * scale
                                                       : -INFINITY;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, int n, int n_valid,
                      int q_tiles, float scale) {
  static_assert(D % 32 == 0 && D <= 128, "head dim must be 32, 64 or 128");
  constexpr int B = blocks(D), kRows = rows(D);
  constexpr int kRow = row_bytes(D);
  constexpr int kTile = kKeys * kRow;  // bytes of one K or V tile
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const uint32_t qs = smem_addr(attn_smem);     // [kRows] Q rows
  const uint32_t ks = qs + kRows * kRow;        // [kStages] K tiles
  const uint32_t vs = ks + kStages * kTile;     // [kStages] V tiles

  const int z = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kRows;
  const size_t base = (size_t)z * n * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w0 = warp * 16 * B;  // this warp's first row in the CTA
  const int key_tiles = (n_valid + kKeys - 1) / kKeys;
  const int steps = 2 * key_tiles;  // pass 1 (K), then pass 2 (K and V)

  auto load_step = [&](int step) {
    const int stage = step % kStages;
    const int key0 = (step < key_tiles ? step : step - key_tiles) * kKeys;
    copy_rows<D, kKeys>(ks + stage * kTile, k + base, key0, n_valid, tid);
    if (step >= key_tiles)
      copy_rows<D, kKeys>(vs + stage * kTile, v + base, key0, n_valid, tid);
  };
  copy_rows<D, kRows>(qs, q + base, q0, n, tid);
#pragma unroll
  for (int step = 0; step < kStages - 1; ++step) {
    if (step < steps) load_step(step);
    cp_async_commit();  // group `step` (group 0 holds Q too)
  }

  uint32_t qf[B][D / 16][4];   // this warp's Q rows, A fragments
  // rows lane/4 and lane/4 + 8 of each block: max m (and m log2 e), sum l,
  // then 1 / l
  float m[B][2], ml[B][2], l[B][2], inv_l[B][2];
  float o[B][D / 8][4];
#pragma unroll
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int r = 0; r < 2; ++r) m[b][r] = -INFINITY, l[b][r] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[b][j][e] = 0.f;
  }

  for (int step = 0; step < steps; ++step) {
    // the stage this copy fills was read in step - 1, behind its barrier
    if (step + kStages - 1 < steps) load_step(step + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of `step` are in
    __syncthreads();               // and every thread's
    if (step == 0) {
      // ldmatrix.x4 over 16 rows x 16 dims: (rows 0-7, dims 0-7), (rows
      // 8-15, dims 0-7), (rows 0-7, dims 8-15), (rows 8-15, dims 8-15)
      const uint32_t a = qs + (w0 + (lane & 15)) * kRow + ((lane >> 4) << 4);
#pragma unroll
      for (int b = 0; b < B; ++b)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldmatrix_x4(qf[b][kk], a + b * 16 * kRow + kk * 32);
    }
    const int stage = step % kStages;
    const bool pass1 = step < key_tiles;
    const int key0 = (pass1 ? step : step - key_tiles) * kKeys;
    float s[B][kKeys / 8][4];
    tile_scores<D, B>(s, qf, ks + stage * kTile, lane, key0, n_valid, scale);
    if (pass1) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[b][j][e]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float mn = fmaxf(m[b][r], mx[r]);  // finite: key 0 is valid
          l[b][r] *= exp2_ftz((m[b][r] - mn) * kLog2e);
          m[b][r] = mn;
          ml[b][r] = mn * kLog2e;
        }
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            l[b][e >> 1] += exp2_ftz(fmaf(s[b][j][e], kLog2e, -ml[b][e >> 1]));
        if (step == key_tiles - 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {  // the row's sum over its four lanes
            l[b][r] += __shfl_xor_sync(0xffffffffu, l[b][r], 1);
            l[b][r] += __shfl_xor_sync(0xffffffffu, l[b][r], 2);
            inv_l[b][r] = 1.f / l[b][r];
          }
        }
      }
    } else {
      // p = exp(s - m) / l rounded to bf16, packed as the PV A fragments,
      // 16 keys at a time: keys 16j .. 16j+15 are the C fragments s[b][2j]
      // and s[b][2j + 1]. ldmatrix.x4.trans over 16 keys x 16 dims of V:
      // (keys 0-7, dims 0-7), (keys 8-15, dims 0-7), (keys 0-7, dims 8-15),
      // (keys 8-15, dims 8-15), each transposed into a B fragment.
      const uint32_t vt = vs + stage * kTile + (lane & 15) * kRow +
                          ((lane >> 4) << 4);
#pragma unroll
      for (int j = 0; j < kKeys / 16; ++j) {
        uint32_t pa[B][4];
#pragma unroll
        for (int b = 0; b < B; ++b)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* c = s[b][2 * j + h];
            const float* mb = ml[b];
            const float* il = inv_l[b];
            pa[b][2 * h] =
                pack_bf16(exp2_ftz(fmaf(c[0], kLog2e, -mb[0])) * il[0],
                          exp2_ftz(fmaf(c[1], kLog2e, -mb[0])) * il[0]);
            pa[b][2 * h + 1] =
                pack_bf16(exp2_ftz(fmaf(c[2], kLog2e, -mb[1])) * il[1],
                          exp2_ftz(fmaf(c[3], kLog2e, -mb[1])) * il[1]);
          }
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t f[4];
          ldmatrix_x4_trans(f, vt + j * 16 * kRow + dd * 32);
#pragma unroll
          for (int b = 0; b < B; ++b) {
            mma_bf16(o[b][2 * dd], pa[b], f[0], f[1]);
            mma_bf16(o[b][2 * dd + 1], pa[b], f[2], f[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // out: round once to bf16, through this warp's own Q rows in shared
  // memory, then 16-byte stores of the rows < n
  unsigned char* rows = attn_smem + w0 * kRow;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      unsigned char* at = rows + (16 * b + g) * kRow + (8 * j + 2 * t) * 2;
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(o[b][j][0], o[b][j][1]);
      *reinterpret_cast<uint32_t*>(at + 8 * kRow) =
          pack_bf16(o[b][j][2], o[b][j][3]);
    }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = lane; i < 16 * B * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = q0 + w0 + r;
    if (row < n)
      *reinterpret_cast<uint4*>(out + base + (size_t)row * D + c * 8) =
          *reinterpret_cast<const uint4*>(rows + r * kRow + c * 16);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int z, int n, int n_valid, float scale,
                   cudaStream_t stream) {
  const int q_tiles = (n + rows(D) - 1) / rows(D);
  constexpr int smem = smem_bytes(D);
  if (smem > 48 * 1024) {  // above the default limit
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  attention_bf16_kernel<D><<<(unsigned)z * q_tiles, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      n, n_valid, q_tiles, scale);
  return cudaGetLastError();
}

cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int z, int n, int d, int n_valid, float scale,
                     cudaStream_t stream) {
  switch (d) {
    case 32: return launch<32>(q, k, v, out, z, n, n_valid, scale, stream);
    case 64: return launch<64>(q, k, v, out, z, n, n_valid, scale, stream);
    case 128: return launch<128>(q, k, v, out, z, n, n_valid, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace vit
}  // namespace dcap

extern "C" int dcap_vit_attention(const void* q, const void* k, const void* v,
                                  void* out, int is_bf16, int z, int n, int d,
                                  int n_valid, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dcap::vit::tc::launch_d(q, k, v, out, z, n, d, n_valid, scale,
                                        st)
              : dcap::vit::launch_d<float>(q, k, v, out, z, n, d, n_valid,
                                           scale, st);
  return static_cast<int>(err);
}
