// Streaming sparse-label softmax cross-entropy for Hopper (sm_90a): CUDA C++
// with a plain C entry per direction.
//
// Replaces the Pallas TPU kernels of mxnet_tpu/ops/pallas/softmax_xent.py:
//   forward   `_fwd_kernel` (:38), launched by `_xent_fwd` (:95);
//   backward  `_bwd_kernel` (:75), launched by `_xent_bwd` (:127).
//
// What it computes, over logits x (N, V) in f32, bf16 or f16 and int32
// labels:
//   forward   lse_i = log sum_v exp(x_iv) and loss_i = lse_i - x_i,label_i,
//             both f32; a label outside [0, V) hits no column, so its loss
//             is lse_i (labels are not clamped, as in the TPU kernel);
//   backward  dx_iv = (exp(x_iv - lse_i) - [v == label_i]) * g_i, written in
//             x's type (in f16 +-inf past its range, as JAX's cast: a loss
//             scaler must see the overflow).
// No f32 (N, V) tensor ever exists: the forward keeps only per-row (max,
// sum-exp) statistics, the backward recomputes softmax from the saved lse.
//
// What bounds it on the H100: the logits' bytes (N * V * itemsize, read once
// forward; read once and dx written once backward) at 3.35 TB/s; the few
// flops per element are far below the ridge, though the forward's one
// exponential an element runs on the SFUs (16 an SM a clock) at about 45%
// of the byte time in bf16 (f16 moves the same bytes).
//
// Forward design (redesigned for this card; the TPU kernel walks (block_n,
// block_v) tiles with the running max and sum in VMEM scratch across the
// sequential vocabulary axis):
// - Persistent blocks of FWD_THREADS threads stride over the rows (row b,
//   b + grid, ...); the launch plan (ops/softmax_xent.py `_fwd_plan`)
//   sizes the grid to at most one resident wave (FWD_MIN_BLOCKS an SM,
//   guaranteed by __launch_bounds__) with as few rounds of rows as the
//   wave allows, so every block gets the same number of rows, give or
//   take one.
// - A row is read in 16-byte vectors: a scalar head up to the row's first
//   16-byte boundary (rows start at every phase: a bf16 row of 50257
//   starts at row * 100514 bytes), the aligned body, and a scalar tail
//   (`row_split`, mirrored by `_row_split` in Python), read-only and
//   skipping L1.  Each thread has FWD_UNROLL vectors of the next batch in
//   flight while it reduces the current one, and the next row's first
//   batch and scalars are loaded before the current row's block
//   reduction, so the stream does not drain between rows.
// - No branch on the data: a batch takes one max and one rescale of the
//   running sum; exponentials are base 2 (ex2.approx) of differences
//   scaled by log2(e).  A running max of +-inf shifts by 0, as
//   torch.logsumexp does, so a -inf logit (a masked column) adds exactly 0
//   even before any finite one, a row of -inf has lse -inf, and a +inf
//   logit gives lse +inf.
// - The label's logit is read at the row's start, off the stream's path,
//   by the thread that writes the row's results.
// The backward is one elementwise pass, blocks tiling each row.  Any V
// (the ragged tail needs no padding).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int FWD_THREADS = 256;
constexpr int FWD_WARPS = FWD_THREADS / 32;
constexpr int FWD_MIN_BLOCKS = 4;      // resident blocks an SM, at least
constexpr int FWD_UNROLL = 4;          // 16-byte vectors a thread a batch
constexpr int BWD_THREADS = 256;
constexpr int BWD_ITEMS = 8;           // elements per thread of a bwd block
constexpr float LOG2E = 1.4426950408889634f;

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
  return __float2bfloat16(x);
}
// round to nearest even, +-inf past the range (no saturation)
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The shift a running max m gives the sum: m itself, or 0 for +-inf.  A
// running (m, s) holds s = sum of exp(x - shift(m)) over what it has seen.
__device__ __forceinline__ float shift(float m) {
  return fabsf(m) == INFINITY ? 0.f : m;
}

// merge (m2, s2) into (m, s); an empty partial (m = -inf, s = 0) adds 0
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mn = fmaxf(m, m2), c = shift(mn);
  s = s * ex2((m - c) * LOG2E) + s2 * ex2((m2 - c) * LOG2E);
  m = mn;
}

// 16 bytes of logits: element i as a float, the max over a batch of
// vectors (NaN ignored, as fmaxf does), and the bits of a vector of -inf
// (the fill past the row's body, which adds exactly 0).  bf16 and f16 take
// the batch max on packed pairs, so no unpacked copy of the batch stays
// live.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static constexpr unsigned NEG_INF = 0xff800000u;
  __device__ static float elem(const uint4& v, int i) {
    return __uint_as_float(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
  }
  __device__ static float max(const uint4 (&a)[FWD_UNROLL]) {
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < FWD_UNROLL; ++k)
#pragma unroll
      for (int i = 0; i < N; ++i) m = fmaxf(m, elem(a[k], i));
    return m;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static constexpr unsigned NEG_INF = 0xff80ff80u;
  __device__ static unsigned word(const uint4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  __device__ static float elem(const uint4& v, int i) {  // 2j: low half
    const unsigned w = word(v, i >> 1);
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ static float max(const uint4 (&a)[FWD_UNROLL]) {
    __nv_bfloat162 m;
    const unsigned w0 = a[0].x;
    memcpy(&m, &w0, 4);
#pragma unroll
    for (int k = 0; k < FWD_UNROLL; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned w = word(a[k], i);
        __nv_bfloat162 h;
        memcpy(&h, &w, 4);
        m = __hmax2(m, h);
      }
    return fmaxf(__low2float(m), __high2float(m));
  }
};
template <> struct Vec<__half> {
  static constexpr int N = 8;
  static constexpr unsigned NEG_INF = 0xfc00fc00u;
  __device__ static unsigned word(const uint4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  __device__ static float elem(const uint4& v, int i) {  // 2j: low half
    const unsigned w = word(v, i >> 1);
    return __half2float(__ushort_as_half(
        (unsigned short)((i & 1) ? (w >> 16) : (w & 0xffffu))));
  }
  __device__ static float max(const uint4 (&a)[FWD_UNROLL]) {
    __half2 m;
    const unsigned w0 = a[0].x;
    memcpy(&m, &w0, 4);
#pragma unroll
    for (int k = 0; k < FWD_UNROLL; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned w = word(a[k], i);
        __half2 h;
        memcpy(&h, &w, 4);
        m = __hmax2(m, h);
      }
    return fmaxf(__low2float(m), __high2float(m));
  }
};

__device__ __forceinline__ uint4 ld_nc(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// A row's split: `head` scalars up to the first 16-byte boundary (at most
// V), `nvec` aligned 16-byte vectors, then the scalar tail [tail0, V).
template <typename T> struct Row {
  const T* xr;
  const uint4* xv;
  int head, nvec, tail0;
};

template <typename T>
__device__ __forceinline__ Row<T> row_split(const T* x, int row, int V) {
  constexpr int E = 16 / (int)sizeof(T);
  Row<T> r;
  r.xr = x + (size_t)row * V;
  const int phase = (int)(reinterpret_cast<uintptr_t>(r.xr) & 15u);
  r.head = min(V, ((16 - phase) & 15) / (int)sizeof(T));
  r.nvec = (V - r.head) / E;
  r.tail0 = r.head + r.nvec * E;
  r.xv = reinterpret_cast<const uint4*>(r.xr + r.head);
  return r;
}

// Batch b of a thread: vectors (b * FWD_UNROLL + k) * FWD_THREADS + tid.
template <typename T>
__device__ __forceinline__ void load_batch(uint4 (&a)[FWD_UNROLL],
                                           const Row<T>& r, int b) {
  constexpr unsigned F = Vec<T>::NEG_INF;
#pragma unroll
  for (int k = 0; k < FWD_UNROLL; ++k) {
    const int c = (b * FWD_UNROLL + k) * FWD_THREADS + (int)threadIdx.x;
    a[k] = make_uint4(F, F, F, F);
    if (c < r.nvec) a[k] = ld_nc(r.xv + c);
  }
}

// The thread's scalar: threads 0..E-1 read the head, E..2E-1 the tail.
template <typename T>
__device__ __forceinline__ float load_scalar(const Row<T>& r, int V) {
  constexpr int E = 16 / (int)sizeof(T);
  const int tid = threadIdx.x;
  const int c = tid < E ? tid : r.tail0 + tid - E;
  const bool ok = tid < E ? tid < r.head : (tid < 2 * E && c < V);
  return ok ? to_f(__ldg(r.xr + c)) : -INFINITY;
}

template <typename T>
__device__ __forceinline__ void reduce_batch(const uint4 (&a)[FWD_UNROLL],
                                             float& m, float& s) {
  constexpr int E = Vec<T>::N;
  const float mn = fmaxf(m, Vec<T>::max(a)), c = shift(mn);
  float acc[FWD_UNROLL];
#pragma unroll
  for (int k = 0; k < FWD_UNROLL; ++k) {
    acc[k] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i)
      acc[k] += ex2((Vec<T>::elem(a[k], i) - c) * LOG2E);
  }
  s = s * ex2((m - c) * LOG2E) + ((acc[0] + acc[1]) + (acc[2] + acc[3]));
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(FWD_THREADS, FWD_MIN_BLOCKS)
xent_fwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                float* __restrict__ loss, float* __restrict__ lse, int N,
                int V) {
  static_assert(FWD_UNROLL == 4, "reduce_batch sums four partials");
  __shared__ float sm[2][FWD_WARPS], ss[2][FWD_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int row = blockIdx.x;
  if (row >= N) return;
  Row<T> cur = row_split(x, row, V);
  uint4 a[FWD_UNROLL];
  load_batch(a, cur, 0);
  float xs = load_scalar(cur, V);
  int lab = tid == 0 ? __ldg(labels + row) : 0;
  const int per_batch = FWD_UNROLL * FWD_THREADS;
  for (int p = 0;; p ^= 1) {
    // the label's logit, in flight while the row streams
    float t = 0.f;
    if (tid == 0 && lab >= 0 && lab < V) t = to_f(__ldg(cur.xr + lab));
    float m = fmaxf(-INFINITY, xs);          // NaN stays in s, not in m
    float s = ex2((xs - shift(m)) * LOG2E);
    const int nb = (cur.nvec + per_batch - 1) / per_batch;
    for (int b = 0; b < nb; ++b) {
      uint4 nx[FWD_UNROLL];
      load_batch(nx, cur, b + 1);           // all fill past the body
      reduce_batch<T>(a, m, s);
#pragma unroll
      for (int k = 0; k < FWD_UNROLL; ++k) a[k] = nx[k];
    }
    // the next row's first reads go out before this row's reduction
    const int next = row + gridDim.x;
    Row<T> nxt = cur;
    if (next < N) {
      nxt = row_split(x, next, V);
      load_batch(a, nxt, 0);
      xs = load_scalar(nxt, V);
      if (tid == 0) lab = __ldg(labels + next);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      merge(m, s, __shfl_xor_sync(0xffffffffu, m, o),
            __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) {
      sm[p][warp] = m;
      ss[p][warp] = s;
    }
    __syncthreads();   // sm[p] is written again two rows on, past the next
    if (warp == 0) {
      m = lane < FWD_WARPS ? sm[p][lane] : -INFINITY;
      s = lane < FWD_WARPS ? ss[p][lane] : 0.f;
#pragma unroll
      for (int o = FWD_WARPS / 2; o > 0; o >>= 1)
        merge(m, s, __shfl_xor_sync(0xffffffffu, m, o),
              __shfl_xor_sync(0xffffffffu, s, o));
      if (lane == 0) {
        const float l = shift(m) + logf(s);
        lse[row] = l;
        loss[row] = l - t;
      }
    }
    if (next >= N) break;
    row = next;
    cur = nxt;
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

// x (N, V) in the type `dtype` names (0 f32, 1 bf16, 2 f16), labels (N,)
// int32, loss and lse (N,) f32.
// All contiguous.  `grid` is the launch plan's (ops/softmax_xent.py
// `_fwd_plan`): persistent blocks, each taking rows b, b + grid, ...
// Returns the launch's cudaError_t (0 = launched).
extern "C" int mxt_softmax_xent_fwd(const void* x, const void* labels,
                                    void* loss, void* lse, int N, int V,
                                    int dtype, int grid, void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (N == 0) return 0;
  if (V < 1 || grid < 1 || grid > N || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (dtype == 1)
    xent_fwd_kernel<__nv_bfloat16><<<grid, FWD_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), lab, lo, ls, N, V);
  else if (dtype == 2)
    xent_fwd_kernel<__half><<<grid, FWD_THREADS, 0, s>>>(
        static_cast<const __half*>(x), lab, lo, ls, N, V);
  else
    xent_fwd_kernel<float><<<grid, FWD_THREADS, 0, s>>>(
        static_cast<const float*>(x), lab, lo, ls, N, V);
  return (int)cudaGetLastError();
}

// The backward: lse from the forward, g (N,) f32 the loss cotangent, dx
// (N, V) in x's type.
extern "C" int mxt_softmax_xent_bwd(const void* x, const void* labels,
                                    const void* lse, const void* g, void* dx,
                                    int N, int V, int dtype, void* stream) {
  cudaGetLastError();
  if (N == 0 || V == 0) return 0;
  if (dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(N, (V + BWD_THREADS * BWD_ITEMS - 1) / (BWD_THREADS * BWD_ITEMS));
  const int* lab = static_cast<const int*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* gr = static_cast<const float*>(g);
  if (dtype == 1)
    xent_bwd_kernel<__nv_bfloat16><<<grid, BWD_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), lab, ls, gr,
        static_cast<__nv_bfloat16*>(dx), V);
  else if (dtype == 2)
    xent_bwd_kernel<__half><<<grid, BWD_THREADS, 0, s>>>(
        static_cast<const __half*>(x), lab, ls, gr,
        static_cast<__half*>(dx), V);
  else
    xent_bwd_kernel<float><<<grid, BWD_THREADS, 0, s>>>(
        static_cast<const float*>(x), lab, ls, gr, static_cast<float*>(dx),
        V);
  return (int)cudaGetLastError();
}
