// Ragged paged attention for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the Pallas TPU kernel `_make_rpa_kernel` launched by `_rpa_pallas`
// (mxnet_tpu/ops/pallas/paged_attention.py:150, :241): one launch serves a
// mixed continuous-batching step -- slots mid-prefill (a chunk of C query
// tokens) beside slots decoding one token -- attending over a paged K/V pool
// of shape (num_pages, page_size, Hkv, D) through per-slot page tables.
//
// What it computes (the TPU kernel's semantics, not its grid):
//   * GQA fold: the rep = H / Hkv query heads sharing kv head g stack as
//     rows r = (head-in-group) * C + c, so q (B, H, C, D) is read as
//     (B, Hkv, rep*C, D) without a copy; row r sits at position
//     start_pos[b] + r % C.
//   * Scores in f32 with the caller's float scale; a key at position t is
//     kept iff t < ctx_lens[b] and t <= qpos (and t >= qpos - window when a
//     window is given).  Masked scores are MASK_VALUE and their p is forced
//     to exactly 0, so a padded context adds exact zero terms.
//   * Online softmax per row in f32 registers; p is rounded to the pool's
//     type before the P.V product (as the TPU kernel casts p to v's dtype);
//     a row that saw no key (ctx = 0) has l == 0 and writes zeros, not NaN.
//   * Keys at t >= ctx are never read: the walk stops at ctx, so pages with
//     page * page_size >= ctx cost nothing.
//
// What bounds it on the H100: the K/V bytes of the keys below ctx (each key
// row D * itemsize, K and V), read from HBM at 3.35 TB/s; the flops are
// 4 * rows * keys * D, far below the f32 FMA rate at serving shapes.
// Design: one thread block per (slot, kv head, tile of 16 rows), so each K/V
// row is fetched once per kv head and shared by all rep*C query rows of the
// fold; tiles of 32 keys are gathered row by row through the page table into
// shared memory (padded stride, no bank conflicts), so any page size works
// and no contiguous context is ever materialised.  Simple first: no
// cp.async/TMA pipelining and no tensor cores yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float MASK_VALUE = -1e30f;
constexpr int TR = 16;                    // query rows per block
constexpr int TK = 32;                    // keys per tile (one per lane)
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int RPW = TR / WARPS;           // rows owned by each warp
constexpr int MAX_D = 256;
constexpr int DPL = MAX_D / 32;           // head-dim values per lane

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int D) {
  const int ldk = D + 1;
  return sizeof(float) * ((size_t)TR * ldk + 2 * (size_t)TK * ldk + TR * TK);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rpa_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
           const T* __restrict__ vpool, const int* __restrict__ page_tables,
           const int* __restrict__ ctx_lens, const int* __restrict__ start_pos,
           T* __restrict__ out, int Hkv, int C, int D, int ps, int maxp,
           int rows, int window, float scale) {
  extern __shared__ float smem[];
  const int ldk = D + 1;
  float* qs = smem;               // [TR][ldk]   query rows (f32)
  float* ks = qs + TR * ldk;      // [TK][ldk]   key tile
  float* vs = ks + TK * ldk;      // [TK][ldk]   value tile
  float* ss = vs + TK * ldk;      // [TR][TK]    scores, then p

  const int bg = blockIdx.x;      // slot * Hkv + kv head
  const int b = bg / Hkv, g = bg % Hkv;
  const int r0 = blockIdx.y * TR;
  const int nr = min(TR, rows - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ctx = ctx_lens[b];
  const int start = start_pos[b];
  const size_t qbase = ((size_t)bg * rows + r0) * D;

  for (int i = tid; i < TR * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qs[r * ldk + d] = r < nr ? to_f(q[qbase + (size_t)r * D + d]) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int k = 0; k < DPL; ++k) acc[rr][k] = 0.f;
  }

  // every row of the block sits at >= start, so keys below start - window
  // are outside every row's window: skip them outright
  const int t_lo = window >= 0 ? max(0, start - window) : 0;
  for (int t0 = t_lo; t0 < ctx; t0 += TK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < TK * D; i += THREADS) {
      const int j = i / D, d = i % D, t = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (t < ctx) {
        const int page = page_tables[(size_t)b * maxp + t / ps];
        const size_t off = (((size_t)page * ps + t % ps) * Hkv + g) * D + d;
        kv = to_f(kpool[off]);
        vv = to_f(vpool[off]);
      }
      ks[j * ldk + d] = kv;
      vs[j * ldk + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < TR * TK; i += THREADS) {
      const int r = i / TK, j = i % TK, t = t0 + j;
      float s = MASK_VALUE;
      if (r < nr) {
        const int qpos = start + (r0 + r) % C;
        if (t < ctx && t <= qpos && (window < 0 || t >= qpos - window)) {
          float dot = 0.f;
          for (int d = 0; d < D; ++d)
            dot = fmaf(qs[r * ldk + d], ks[j * ldk + d], dot);
          s = dot * scale;
        }
      }
      ss[r * TK + j] = s;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      if (r < nr) {  // warp-uniform
        const float s = ss[r * TK + lane];
        const float m_next = fmaxf(m[rr], warp_max(s));
        // fully-masked entries: exp(MASK - m) must be exactly 0, not 1
        const float p = s > 0.5f * MASK_VALUE ? expf(s - m_next) : 0.f;
        const float alpha = expf(m[rr] - m_next);
        l[rr] = alpha * l[rr] + warp_sum(p);
        m[rr] = m_next;
        ss[r * TK + lane] = to_f(from_f<T>(p));
        __syncwarp();
#pragma unroll
        for (int k = 0; k < DPL; ++k) {
          const int d = lane + 32 * k;
          if (d < D) {
            float a = acc[rr][k] * alpha;
            for (int j = 0; j < TK; ++j)
              a = fmaf(ss[r * TK + j], vs[j * ldk + d], a);
            acc[rr][k] = a;
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    if (r < nr) {
      const float l_safe = l[rr] == 0.f ? 1.f : l[rr];
      const size_t ob = qbase + (size_t)r * D;
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const int d = lane + 32 * k;
        if (d < D) out[ob + d] = from_f<T>(acc[rr][k] / l_safe);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kpool, const void* vpool,
                   const void* page_tables, const void* ctx_lens,
                   const void* start_pos, void* out, int B, int H, int Hkv,
                   int C, int D, int ps, int maxp, int window, float scale,
                   cudaStream_t stream) {
  const int rows = (H / Hkv) * C;
  const size_t smem = smem_bytes(D);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        rpa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(MAX_D));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid(B * Hkv, (rows + TR - 1) / TR);
  rpa_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), static_cast<const int*>(page_tables),
      static_cast<const int*>(ctx_lens), static_cast<const int*>(start_pos),
      static_cast<T*>(out), Hkv, C, D, ps, maxp, rows, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, C, D) and the pools (num_pages, ps, Hkv, D) in one type (f32 or
// bf16, chosen by is_bf16); page_tables (B, maxp), ctx_lens (B,), start_pos
// (B,) int32; out (B, H, C, D) in q's type.  window < 0 means no window.
// All contiguous; the caller checks shapes (H % Hkv == 0, D <= 256).
// Returns the launch's cudaError_t (0 = launched).
extern "C" int mxt_ragged_paged_attention(
    const void* q, const void* kpool, const void* vpool,
    const void* page_tables, const void* ctx_lens, const void* start_pos,
    void* out, int B, int H, int Hkv, int C, int D, int ps, int maxp,
    int window, float scale, int is_bf16, void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (B == 0 || C == 0 || D > MAX_D) return D > MAX_D ? (int)cudaErrorInvalidValue : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(q, kpool, vpool, page_tables, ctx_lens,
                                       start_pos, out, B, H, Hkv, C, D, ps,
                                       maxp, window, scale, s)
              : launch<float>(q, kpool, vpool, page_tables, ctx_lens,
                              start_pos, out, B, H, Hkv, C, D, ps, maxp,
                              window, scale, s);
  return (int)e;
}
