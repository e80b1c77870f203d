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
// row); no arithmetic to speak of.  Design, simple first: one warp per
// output row, eight rows to a 256-thread block; each warp loads its own
// index (the TPU kernel prefetched them as scalars) and moves the row in
// 16-byte vectors, neighbouring lanes on neighbouring addresses, when
// h * sizeof(T) is a multiple of 16 and both base pointers are 16-byte
// aligned; otherwise element by element.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int WARPS = 8;  // rows per block

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

// 16 bytes of T, scaled element by element in f32.
template <typename T>
__device__ __forceinline__ uint4 scale_vec(uint4 v, float s) {
  constexpr int K = 16 / sizeof(T);
  T e[K];
  memcpy(e, &v, 16);
#pragma unroll
  for (int k = 0; k < K; ++k) e[k] = from_f<T>(to_f(e[k]) * s);
  memcpy(&v, e, 16);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
gather_rows_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                   const float* __restrict__ scale, T* __restrict__ out,
                   long long n, int rows, int h, int vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int j = idx[row];
  const bool live = j >= 0 && (long long)j < n;
  const float s = scale != nullptr ? scale[row] : 1.f;
  T* o = out + (size_t)row * h;
  const T* r = src + (size_t)(live ? j : 0) * h;
  if (vec) {
    const int nv = h * (int)sizeof(T) / 16;
    uint4* ov = reinterpret_cast<uint4*>(o);
    const uint4* rv = reinterpret_cast<const uint4*>(r);
    for (int c = lane; c < nv; c += 32) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (live) {
        v = rv[c];
        if (scale != nullptr) v = scale_vec<T>(v, s);
      }
      ov[c] = v;
    }
  } else {
    for (int c = lane; c < h; c += 32) {
      T v = from_f<T>(0.f);
      if (live) v = scale != nullptr ? from_f<T>(to_f(r[c]) * s) : r[c];
      o[c] = v;
    }
  }
}

}  // namespace

// out (rows, h) = rows of src (n, h) picked by idx (rows,) int32, zero where
// an index is outside [0, n), times scale (rows,) f32 when scale is not null.
// dtype codes: 0 f32, 1 bf16, 2 f16.  Returns the launch's cudaError_t.
extern "C" int mxt_gather_rows(const void* src, const void* idx,
                               const void* scale, void* out, long long n,
                               int rows, int h, int dtype, void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (rows == 0 || h == 0) return 0;
  if (rows < 0 || h < 0 || n < 0) return (int)cudaErrorInvalidValue;
  const int size = dtype == 0 ? 4 : 2;
  const int vec = ((long long)h * size) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int blocks = (rows + WARPS - 1) / WARPS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const float* sc = static_cast<const float*>(scale);
#define MXT_GATHER(T)                                                   \
  gather_rows_kernel<T><<<blocks, WARPS * 32, 0, st>>>(                 \
      static_cast<const T*>(src), ix, sc, static_cast<T*>(out), n, rows, \
      h, vec)
  if (dtype == 0) MXT_GATHER(float);
  else if (dtype == 1) MXT_GATHER(__nv_bfloat16);
  else if (dtype == 2) MXT_GATHER(__half);
  else return (int)cudaErrorInvalidValue;
#undef MXT_GATHER
  return (int)cudaGetLastError();
}
