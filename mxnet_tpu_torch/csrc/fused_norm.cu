// Fused LayerNorm / RMSNorm (+ residual add) row kernel for Hopper (sm_90a):
// CUDA C++ with a plain C entry point.
//
// Replaces the Pallas TPU kernel of mxnet_tpu/ops/pallas/fused_norm.py:
// `_norm_kernel` (:79), launched by `_norm_pallas` (:164).
//
// What it computes, per row of x (rows, h) in f32, bf16 or f16:
//   s = x (+ residual), in f32; written in x's type when a residual is given
//   LN:  mean = sum(s) * (1/h); c = s - mean; var = sum(c*c) * (1/h);
//        y = c * rsqrt(var + eps) * gamma (+ beta)
//   RMS: ms = sum(s*s) * (1/h);  y = s * rsqrt(ms + eps) * gamma (+ beta)
// Statistics in f32, two-pass (exact mean, then the centred second moment),
// as the TPU kernel computes them; gamma and beta are read in their own
// type (f32, bf16 or f16) and widened; y and s are stored in x's type,
// rounded to nearest even.
//
// What bounds it on the H100: bytes — x (and the residual) read once, y
// (and s) written once, at 3.35 TB/s; a dozen flops per element are far
// below the ridge.  Design, simple first: one block per row, any h (no
// 128-lane padding: threads stride over the row and the ragged end needs
// no mask).  Three passes over the row — sum, centred sum of squares, the
// output — each closed by a deterministic block reduction (warp shuffles,
// then one shared-memory step that every warp reads in the same order).
// Passes 2 and 3 re-read the row, which a block touched microseconds
// earlier, from L1/L2 rather than DRAM; the residual sum is recomputed in
// f32 (bit-identical) instead of being re-read from s.  Scalar loads, no
// vectorisation yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// Sum of v over the block (blockDim.x a multiple of 32, at most 1024).
// Every warp reduces the per-warp partials itself, in the same order, so
// every thread returns the same bits and no broadcast is needed.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  __syncthreads();  // every warp has read red before it is written again
  return t;
}

template <typename T, typename P>
__global__ void __launch_bounds__(512)
norm_kernel(const T* __restrict__ x, const T* __restrict__ res,
            const P* __restrict__ gamma, const P* __restrict__ beta,
            T* __restrict__ y, T* __restrict__ s, int h, float inv_h,
            float eps, int rms) {
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * h;
  const T* xr = x + base;
  const T* rr = res ? res + base : nullptr;
  const int t0 = threadIdx.x, nt = blockDim.x;

  // pass 1: the (residual) sum s, written when a residual is given, and
  // sum(s) for LN or sum(s*s) for RMS
  float acc = 0.f;
  for (int c = t0; c < h; c += nt) {
    float v = to_f(xr[c]);
    if (rr) {
      v += to_f(rr[c]);
      s[base + c] = from_f<T>(v);
    }
    acc += rms ? v * v : v;
  }
  const float first = block_sum(acc, red) * inv_h;

  float mean = 0.f, rstd;
  if (rms) {
    rstd = rsqrtf(first + eps);
  } else {
    // pass 2: the centred second moment about the exact mean
    mean = first;
    float sq = 0.f;
    for (int c = t0; c < h; c += nt) {
      float v = to_f(xr[c]);
      if (rr) v += to_f(rr[c]);
      const float d = v - mean;
      sq += d * d;
    }
    rstd = rsqrtf(block_sum(sq, red) * inv_h + eps);
  }

  // pass 3: the output
  for (int c = t0; c < h; c += nt) {
    float v = to_f(xr[c]);
    if (rr) v += to_f(rr[c]);
    float o = (v - mean) * rstd * to_f(gamma[c]);
    if (beta) o += to_f(beta[c]);
    y[base + c] = from_f<T>(o);
  }
}

template <typename T, typename P>
void launch(const void* x, const void* res, const void* gamma,
            const void* beta, void* y, void* s, int rows, int h, float eps,
            int rms, int threads, cudaStream_t st) {
  norm_kernel<T, P><<<rows, threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const P*>(gamma), static_cast<const P*>(beta),
      static_cast<T*>(y), static_cast<T*>(s), h, (float)(1.0 / h), eps, rms);
}

template <typename T>
int launch_p(int p_dtype, const void* x, const void* res, const void* gamma,
             const void* beta, void* y, void* s, int rows, int h, float eps,
             int rms, int threads, cudaStream_t st) {
  switch (p_dtype) {
    case 0: launch<T, float>(x, res, gamma, beta, y, s, rows, h, eps, rms,
                             threads, st); return 0;
    case 1: launch<T, __nv_bfloat16>(x, res, gamma, beta, y, s, rows, h, eps,
                                     rms, threads, st); return 0;
    case 2: launch<T, __half>(x, res, gamma, beta, y, s, rows, h, eps, rms,
                              threads, st); return 0;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, res (may be null), y, s (null unless res is given): (rows, h) in the
// type x_dtype (0 f32, 1 bf16, 2 f16); gamma, beta (may be null): (h,) in
// p_dtype.  All contiguous.  rms selects RMSNorm.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int mxt_fused_norm(const void* x, const void* res,
                              const void* gamma, const void* beta, void* y,
                              void* s, int rows, int h, int x_dtype,
                              int p_dtype, int rms, float eps, void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (rows == 0) return 0;
  if (h < 1 || (res != nullptr) != (s != nullptr))
    return (int)cudaErrorInvalidValue;
  // about 4 elements per thread, whole warps, at most 512 threads
  int threads = ((h + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (x_dtype) {
    case 0: err = launch_p<float>(p_dtype, x, res, gamma, beta, y, s, rows,
                                  h, eps, rms, threads, st); break;
    case 1: err = launch_p<__nv_bfloat16>(p_dtype, x, res, gamma, beta, y, s,
                                          rows, h, eps, rms, threads, st);
            break;
    case 2: err = launch_p<__half>(p_dtype, x, res, gamma, beta, y, s, rows,
                                   h, eps, rms, threads, st); break;
    default: err = (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}
