// MoE row gather for Hopper (sm_90a): CUDA C++ with a plain C entry point.
//
// Replaces the Pallas TPU kernel of mxnet_tpu/ops/pallas/moe_dispatch.py:
// the inner `kernel` (:108) of `_gather_rows_pallas` (:96), launched at
// :139.  MoE dispatch (`_dispatch_kernel`, :160) and combine
// (`_combine_kernel`, :192) are both this one gather.
//
// What it computes, for each output row i of (rows, h):
//   j = idx[i]
//   out[i] = 0                                  where j is outside [0, n)
//   out[i] = src[j]                             with no scale
//   out[i] = (T)((float)src[j] * scale[i])      with an f32 scale
// The TPU kernel reads a zero row that its callers append to src (a
// (T+1, H) copy, jnp.concatenate at :168 and :195); here an index equal to
// n (the callers' sentinel: T for dispatch, E*C for combine) writes zeros
// directly, so no copy of src exists.  Dropped tokens and empty capacity
// slots come out exactly zero whatever their scale.  Without a scale the
// row is copied bit for bit; with one, each element is widened to f32,
// multiplied and rounded to nearest even, as the TPU kernel does.
//
// What bounds it on the H100: bytes at 3.35 TB/s — each kept row read
// once, every output row written once (the indices and scale are 4 B a
// row); no arithmetic to speak of.  At the MoE slice's shapes that is
// 12-28 MB, a few microseconds, so what costs is latency: the launch, the
// dependent trip from an index to its row, and a ragged last wave.
// Design:
// - The launch plan (ops/moe_dispatch.py `_plan`) gives each block a
//   contiguous run of `rows_per_block` rows and sizes the grid to at most
//   one resident wave (MIN_BLOCKS blocks an SM, which __launch_bounds__
//   guarantees), so no block waits for another to finish.
// - A block reads its rows' indices and scales in one coalesced load into
//   shared memory before it touches any row.
// - Each warp keeps DEPTH rows in flight: it issues every load of its
//   DEPTH rows' current column span (PER_LANE pieces a lane each) before
//   it stores any of them.  Loads are read-only and do not allocate in L1
//   (ld.global.nc.L1::no_allocate); stores are evict-first
//   (st.global.cs), so the output, larger than what is left to read, does
//   not push the sources out of L2.
// - Rows move in the widest piece that h * sizeof(T) and both base
//   pointers allow: 16, 8, 4 or 2 bytes (the plan's `piece`).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int WARPS = 8;                 // warps a block
constexpr int THREADS = WARPS * 32;
constexpr int MIN_BLOCKS = 4;            // resident blocks an SM, at least
constexpr int UNITS = 8;                 // pieces a lane holds at once
constexpr int MAX_DEPTH = 4;             // rows a warp keeps in flight
constexpr int CHUNK = THREADS;           // indices a block stages at once

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);      // round to nearest even
}

// Read-only loads that skip L1 and evict-first stores, one per piece size.
// Both are volatile, so every load of a pass stays ahead of its stores.
__device__ __forceinline__ uint4 ld_nc(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 ld_nc(const uint2* p) {
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned ld_nc(const unsigned* p) {
  unsigned v;
  asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];"
               : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned short ld_nc(const unsigned short* p) {
  unsigned short v;
  asm volatile("ld.global.nc.L1::no_allocate.u16 %0, [%1];"
               : "=h"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ void st_cs(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void st_cs(uint2* p, uint2 v) {
  asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};"
               :: "l"(p), "r"(v.x), "r"(v.y) : "memory");
}
__device__ __forceinline__ void st_cs(unsigned* p, unsigned v) {
  asm volatile("st.global.cs.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void st_cs(unsigned short* p, unsigned short v) {
  asm volatile("st.global.cs.u16 [%0], %1;" :: "l"(p), "h"(v) : "memory");
}

// One piece of T, scaled element by element in f32.
template <typename T, typename V>
__device__ __forceinline__ V scale_piece(V v, float s) {
  constexpr int K = sizeof(V) / sizeof(T);
  T e[K];
  memcpy(e, &v, sizeof(V));
#pragma unroll
  for (int k = 0; k < K; ++k) e[k] = from_f<T>(to_f(e[k]) * s);
  memcpy(&v, e, sizeof(V));
  return v;
}

// Rows of `nv` pieces of type V.  Block b owns rows [b * rows_per_block,
// (b + 1) * rows_per_block); warp w takes its DEPTH consecutive rows at
// w * DEPTH, then every WARPS * DEPTH rows after; a lane moves pieces
// lane, lane + 32, ... of each, PER_LANE of them a pass.
template <typename T, typename V, int PER_LANE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gather_rows_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                   const float* __restrict__ scale, T* __restrict__ out,
                   long long n, int rows, int nv, int rows_per_block) {
  constexpr int D = UNITS / PER_LANE < MAX_DEPTH ? UNITS / PER_LANE
                                                 : MAX_DEPTH;
  __shared__ int s_idx[CHUNK];
  __shared__ float s_scale[CHUNK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const V* sv = reinterpret_cast<const V*>(src);
  V* ov = reinterpret_cast<V*>(out);
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int c0 = r0; c0 < r1; c0 += CHUNK) {
    const int cn = min(CHUNK, r1 - c0);
    if (threadIdx.x < cn) {
      s_idx[threadIdx.x] = __ldg(idx + c0 + threadIdx.x);
      s_scale[threadIdx.x] =
          scale != nullptr ? __ldg(scale + c0 + threadIdx.x) : 1.f;
    }
    __syncthreads();
    for (int g = warp * D; g < cn; g += WARPS * D) {
      long long from[D];
      bool live[D];
      float s[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int j = g + d < cn ? s_idx[g + d] : -1;
        live[d] = j >= 0 && (long long)j < n;
        from[d] = live[d] ? (long long)j * nv : 0;
        s[d] = g + d < cn ? s_scale[g + d] : 1.f;
      }
      for (int t = lane; t < nv; t += 32 * PER_LANE) {
        V v[D][PER_LANE];
#pragma unroll
        for (int d = 0; d < D; ++d)
#pragma unroll
          for (int k = 0; k < PER_LANE; ++k) {
            const int c = t + 32 * k;
            v[d][k] = V{};
            if (live[d] && c < nv) v[d][k] = ld_nc(sv + from[d] + c);
          }
#pragma unroll
        for (int d = 0; d < D; ++d)
#pragma unroll
          for (int k = 0; k < PER_LANE; ++k) {
            const int c = t + 32 * k;
            if (g + d < cn && c < nv) {
              V w = v[d][k];
              // a dead row stays +0 whatever its scale's sign
              if (scale != nullptr && live[d]) w = scale_piece<T>(w, s[d]);
              st_cs(ov + (size_t)(c0 + g + d) * nv + c, w);
            }
          }
      }
    }
    __syncthreads();
  }
}

struct Launch {
  const void* src;
  const int* idx;
  const float* scale;
  void* out;
  long long n;
  int rows, nv, rows_per_block, grid;
  cudaStream_t st;
};

template <typename T, typename V>
int launch_piece(const Launch& a, int per_lane) {
#define MXT_GATHER(P)                                                     \
  gather_rows_kernel<T, V, P><<<a.grid, THREADS, 0, a.st>>>(              \
      static_cast<const T*>(a.src), a.idx, a.scale, static_cast<T*>(a.out), \
      a.n, a.rows, a.nv, a.rows_per_block)
  if (per_lane == 1) MXT_GATHER(1);
  else if (per_lane == 2) MXT_GATHER(2);
  else if (per_lane == 4) MXT_GATHER(4);
  else return (int)cudaErrorInvalidValue;
#undef MXT_GATHER
  return 0;
}

template <typename T>
int launch_type(const Launch& a, int piece, int per_lane) {
  if (piece == 16) return launch_piece<T, uint4>(a, per_lane);
  if (piece == 8) return launch_piece<T, uint2>(a, per_lane);
  if (piece == 4) return launch_piece<T, unsigned>(a, per_lane);
  if constexpr (sizeof(T) == 2) {
    if (piece == 2) return launch_piece<T, unsigned short>(a, per_lane);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// out (rows, h) = rows of src (n, h) picked by idx (rows,) int32, zero where
// an index is outside [0, n), times scale (rows,) f32 when scale is not null.
// dtype codes: 0 f32, 1 bf16, 2 f16.  The plan (ops/moe_dispatch.py
// `_plan`): `piece` bytes a load (16, 8, 4 or 2; it must divide h * size
// and both base pointers), `per_lane` pieces a lane a pass (1, 2 or 4),
// `rows_per_block` rows a block over `grid` blocks.  Returns the launch's
// cudaError_t.
extern "C" int mxt_gather_rows(const void* src, const void* idx,
                               const void* scale, void* out, long long n,
                               int rows, int h, int dtype, int piece,
                               int per_lane, int rows_per_block, int grid,
                               void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (rows == 0 || h == 0) return 0;
  if (rows < 0 || h < 0 || n < 0 || grid < 1 || rows_per_block < 1 ||
      (long long)grid * rows_per_block < rows)
    return (int)cudaErrorInvalidValue;
  const int size = dtype == 0 ? 4 : 2;
  const long long bytes = (long long)h * size;
  if ((piece != 16 && piece != 8 && piece != 4 && piece != 2) ||
      piece < size || bytes % piece != 0 || bytes / piece >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(src) % piece != 0 ||
      reinterpret_cast<uintptr_t>(out) % piece != 0)
    return (int)cudaErrorMisalignedAddress;
  const Launch a{src, static_cast<const int*>(idx),
                 static_cast<const float*>(scale), out, n, rows,
                 (int)(bytes / piece), rows_per_block, grid,
                 static_cast<cudaStream_t>(stream)};
  int err;
  if (dtype == 0) err = launch_type<float>(a, piece, per_lane);
  else if (dtype == 1) err = launch_type<__nv_bfloat16>(a, piece, per_lane);
  else if (dtype == 2) err = launch_type<__half>(a, piece, per_lane);
  else return (int)cudaErrorInvalidValue;
  if (err) return err;
  return (int)cudaGetLastError();
}
