// Weight-only int8/int4 dequant-matmul for Hopper (sm_90a), CUDA C++ with a
// plain C entry.
//
// Replaces the Pallas TPU kernel `_qmm_kernel(bits)` launched by `_qmm_pallas`
// (mxnet_tpu/ops/pallas/quantized_matmul.py:262, :305):
//   out (M, N) = x (M, K) @ deq(W)^T,   deq(W)[n, k] = q[n, k] * scale[n]
// with int8 planes q (N, K), or int4 planes packed two per byte (N, ceil(K/2))
// -- byte j holds value 2j in its low nibble and 2j+1 in its high nibble, two's
// complement.  Accumulation is f32; the per-channel scale multiplies the f32
// sum once in the epilogue, so the dense weight never exists in device memory.
//
// What bounds it on the H100: at serving shapes (M = slots or slots * chunk,
// far below the ~295 flop/byte ridge) the weight bytes, N * K * bits / 8, read
// from HBM at 3.35 TB/s.  Design: each block owns a BM x BN output tile and
// loops over K in steps of 64; it stages the x tile and the integer weight
// tile (unpacking nibbles for int4) into shared memory as f32 -- the weight is
// read from HBM at its stored width and converted in registers -- and each
// thread accumulates a TM x TN sub-tile with FMAs.  Ragged M, N and K edges are
// masked to zero.  Small M takes a narrow tile so that more blocks stream the
// weight at once.  Simple first: no cp.async/TMA staging and no tensor cores.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;

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

// value k of weight row `row` (K values; packed rows hold Kp bytes)
template <int BITS>
__device__ __forceinline__ float weight_at(const int8_t* __restrict__ row,
                                           int k) {
  if (BITS == 8) return (float)row[k];
  const int b = row[k >> 1];
  // sign-extend the low nibble; an arithmetic shift gives the high one
  const int v = (k & 1) ? (b >> 4) : ((int)(int8_t)(b << 4) >> 4);
  return (float)v;
}

template <typename T, int BITS, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ scale, T* __restrict__ out, int M, int N,
           int K, int Kp) {
  constexpr int NT = (BM / TM) * (BN / TN);
  __shared__ float xs[BK][BM + 4];   // x tile, k-major
  __shared__ float ws[BK][BN + 1];   // dequant-free weight tile, k-major

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int mm = i / BK, kk = i % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < K) ? to_f(x[(size_t)gm * K + gk]) : 0.f;
    }
    for (int i = tid; i < BN * BK; i += NT) {
      const int nn = i / BK, kk = i % BK;
      const int gn = n0 + nn, gk = k0 + kk;
      ws[kk][nn] = (gn < N && gk < K)
                       ? weight_at<BITS>(q + (size_t)gn * Kp, gk)
                       : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], w[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tx * TN + j;
    if (gn >= N) continue;
    const float s = scale[gn];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty * TM + i;
      if (gm < M) out[(size_t)gm * N + gn] = from_f<T>(acc[i][j] * s);
    }
  }
}

template <typename T, int BITS, int BM, int BN, int TM, int TN>
cudaError_t launch_tile(const void* x, const void* q, const void* scale,
                        void* out, int M, int N, int K, int Kp,
                        cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_kernel<T, BITS, BM, BN, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          static_cast<const T*>(x), static_cast<const int8_t*>(q),
          static_cast<const float*>(scale), static_cast<T*>(out), M, N, K,
          Kp);
  return cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out,
                   int M, int N, int K, cudaStream_t stream) {
  const int Kp = BITS == 4 ? (K + 1) / 2 : K;
  if (M <= 16)
    return launch_tile<T, BITS, 16, 32, 2, 2>(x, q, scale, out, M, N, K, Kp,
                                              stream);
  return launch_tile<T, BITS, 64, 64, 4, 4>(x, q, scale, out, M, N, K, Kp,
                                            stream);
}

}  // namespace

// x (M, K) f32 or bf16 (is_bf16); q int8 (N, K) for bits 8 or packed int4
// (N, ceil(K/2)) for bits 4; scale (N,) f32; out (M, N) in x's type.  All
// contiguous; the caller checks shapes.  Returns the launch's cudaError_t.
extern "C" int mxt_quantized_matmul(const void* x, const void* q,
                                    const void* scale, void* out, int M,
                                    int N, int K, int bits, int is_bf16,
                                    void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (M == 0 || N == 0) return 0;
  if (bits != 4 && bits != 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_bf16)
    e = bits == 8 ? launch<__nv_bfloat16, 8>(x, q, scale, out, M, N, K, s)
                  : launch<__nv_bfloat16, 4>(x, q, scale, out, M, N, K, s);
  else
    e = bits == 8 ? launch<float, 8>(x, q, scale, out, M, N, K, s)
                  : launch<float, 4>(x, q, scale, out, M, N, K, s);
  return (int)e;
}
