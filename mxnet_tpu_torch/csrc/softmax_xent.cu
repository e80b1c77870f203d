// Streaming sparse-label softmax cross-entropy for Hopper (sm_90a): CUDA C++
// with a plain C entry per direction.
//
// Replaces the Pallas TPU kernels of mxnet_tpu/ops/pallas/softmax_xent.py:
//   forward   `_fwd_kernel` (:38), launched by `_xent_fwd` (:95);
//   backward  `_bwd_kernel` (:75), launched by `_xent_bwd` (:127).
//
// What it computes, over logits x (N, V) in f32 or bf16 and int32 labels:
//   forward   lse_i = log sum_v exp(x_iv) and loss_i = lse_i - x_i,label_i,
//             both f32; a label outside [0, V) hits no column, so its loss
//             is lse_i (labels are not clamped, as in the TPU kernel);
//   backward  dx_iv = (exp(x_iv - lse_i) - [v == label_i]) * g_i, written in
//             x's type.
// No f32 (N, V) tensor ever exists: the forward keeps only per-row (max,
// sum-exp) statistics, the backward recomputes softmax from the saved lse.
//
// What bounds it on the H100: the logits' bytes (N * V * itemsize, read once
// forward; read once and dx written once backward) at 3.35 TB/s; the few
// flops per element are far below the ridge.  Design, simple first: the
// forward runs one block per row, each thread keeping an online (max, sum)
// over a strided slice of the row in registers, combined by warp shuffles
// and one shared-memory pass; the backward is one elementwise pass, blocks
// tiling each row.  Any V (the ragged tail needs no padding: threads stride
// to V).  Scalar loads, no vectorisation yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FWD_THREADS = 512;
constexpr int BWD_THREADS = 256;
constexpr int BWD_ITEMS = 8;           // elements per thread of a bwd block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// merge two (max, sum-exp) partials; an empty partial (l == 0) adds nothing
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  const float a = l == 0.f ? 0.f : l * expf(m - mn);
  const float b = l2 == 0.f ? 0.f : l2 * expf(m2 - mn);
  m = mn;
  l = a + b;
}

template <typename T>
__global__ void __launch_bounds__(FWD_THREADS)
xent_fwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                float* __restrict__ loss, float* __restrict__ lse, int V) {
  __shared__ float sm[FWD_THREADS / 32], sl[FWD_THREADS / 32];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const T* xr = x + (size_t)row * V;
  // the running max starts at -FLT_MAX, not -inf, so a -inf logit (a
  // masked column) adds exp(-inf) = 0 even before any finite one: from
  // m = -inf it would add exp(-inf - -inf) = NaN
  float m = -FLT_MAX, l = 0.f;
  for (int c = tid; c < V; c += FWD_THREADS) {
    const float xv = to_f(xr[c]);
    if (xv > m) {
      l = l * expf(m - xv) + 1.f;
      m = xv;
    } else {
      l += expf(xv - m);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    merge(m, l, m2, l2);
  }
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < FWD_THREADS / 32; ++w) merge(m, l, sm[w], sl[w]);
    const int lab = labels[row];
    const float t = (lab >= 0 && lab < V) ? to_f(xr[lab]) : 0.f;
    const float s = m + logf(l);
    lse[row] = s;
    loss[row] = s - t;
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
xent_bwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ g,
                T* __restrict__ dx, int V) {
  const int row = blockIdx.x;
  const float s = lse[row], gr = g[row];
  const int lab = labels[row];
  const size_t base = (size_t)row * V;
  const int c0 = blockIdx.y * (BWD_THREADS * BWD_ITEMS) + threadIdx.x;
#pragma unroll
  for (int it = 0; it < BWD_ITEMS; ++it) {
    const int c = c0 + it * BWD_THREADS;
    if (c < V) {
      const float p = expf(to_f(x[base + c]) - s);
      dx[base + c] = from_f<T>((p - (c == lab ? 1.f : 0.f)) * gr);
    }
  }
}

}  // namespace

// x (N, V) f32 or bf16 (is_bf16), labels (N,) int32, loss and lse (N,) f32.
// All contiguous.  Returns the launch's cudaError_t (0 = launched).
extern "C" int mxt_softmax_xent_fwd(const void* x, const void* labels,
                                    void* loss, void* lse, int N, int V,
                                    int is_bf16, void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (N == 0) return 0;
  if (V < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    xent_fwd_kernel<__nv_bfloat16><<<N, FWD_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(labels),
        static_cast<float*>(loss), static_cast<float*>(lse), V);
  else
    xent_fwd_kernel<float><<<N, FWD_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(labels),
        static_cast<float*>(loss), static_cast<float*>(lse), V);
  return (int)cudaGetLastError();
}

// The backward: lse from the forward, g (N,) f32 the loss cotangent, dx
// (N, V) in x's type.
extern "C" int mxt_softmax_xent_bwd(const void* x, const void* labels,
                                    const void* lse, const void* g, void* dx,
                                    int N, int V, int is_bf16, void* stream) {
  cudaGetLastError();
  if (N == 0 || V == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(N, (V + BWD_THREADS * BWD_ITEMS - 1) / (BWD_THREADS * BWD_ITEMS));
  if (is_bf16)
    xent_bwd_kernel<__nv_bfloat16><<<grid, BWD_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(labels),
        static_cast<const float*>(lse), static_cast<const float*>(g),
        static_cast<__nv_bfloat16*>(dx), V);
  else
    xent_bwd_kernel<float><<<grid, BWD_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(labels),
        static_cast<const float*>(lse), static_cast<const float*>(g),
        static_cast<float*>(dx), V);
  return (int)cudaGetLastError();
}
