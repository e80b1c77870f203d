// Flash attention, forward and backward, for Hopper (sm_90a): CUDA C++ with a
// plain C entry per direction.
//
// Replaces the Pallas TPU kernels of mxnet_tpu/ops/pallas/flash_attention.py:
//   forward   `_fwd_kernel` (:152), launched by `_flash_fwd` (:284);
//   backward  `_dq_kernel` (:341) and `_dkv_kernel` (:395), launched by
//             `_flash_bwd` (:489, :517).
//
// What it computes (the TPU kernels' semantics, not their grid), over
// q (BH, Lq, D), k/v (BH, Lk, D), BH = batch * heads, in f32 or bf16:
//   * s = (q . k) * scale in f32 (bf16 products accumulate in f32), plus an
//     optional f32 additive bias (Bb, 1|Lq, Lk) with Bb = B (shared by the H
//     heads of a batch row) or B * H; causal keeps key c for row r iff c <= r.
//     A masked or padded score is MASK_VALUE and its p is forced to exactly 0,
//     so a row whose keys are all masked writes zeros with lse = 0 and gets
//     zero gradients (:221-229).
//   * online softmax per row in f32; lse = m + log(l) is written as (BH, Lq)
//     f32, one value per row.
//   * attention-probs dropout from the counter hash `_splitmix32` /
//     `_keep_mask` (:119-145), bit for bit: keyed on the int32 seed, the bh
//     index and the absolute row and column; the normaliser l comes from the
//     undropped p, the kept p is scaled by 1 / (1 - rate) (:202-208), and the
//     backward applies the same mask to dP and to P (:374-376, :426-439).
//   * p (and dS) are rounded to the input type before their products, as the
//     TPU kernels cast them to v's (k's, q's) dtype.
//   * backward by recompute from lse: di = rowsum(dO * O); dQ walks k tiles
//     per q tile; dK/dV walk q tiles per k tile.  No atomics, so the result
//     is deterministic.
//
// What bounds it on the H100: at BERT's shapes (L = 128, D = 64) the work is
// 4 * BH * Lq * Lk * D flops forward (10x backward) against a few MB of
// q/k/v/o, so in bf16 the tensor cores' rate, in f32 the FMA rate.  Design,
// simple first: one block of 256 threads per (bh, 64-row tile); 64-key tiles
// of K and V are staged in shared memory as f32 (padded stride, no bank
// conflicts); each thread owns a 4 x 4 tile of scores and a 4 x D/16 tile of
// the output accumulator in registers, with SIMT FMAs.  Any Lq, Lk (ragged
// tiles are masked) and D <= 128.  No tensor cores, cp.async or TMA yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float MASK_VALUE = -1e30f;
constexpr int BQ = 64;                 // query rows per tile
constexpr int BK = 64;                 // keys per tile
constexpr int THREADS = 256;           // 16 x 16
constexpr int NI = BQ / 16;            // rows per thread
constexpr int NJ = BK / 16;            // score columns per thread
constexpr int MAX_D = 128;
// head-dim columns per thread (NC = 4 for D <= 64, 8 up to MAX_D) is a
// template parameter: a compile-time width keeps the accumulators of a
// D = 64 head in half the registers
constexpr int LDP = BK + 1;            // padded stride of score tiles

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
// round through the storage type, as the TPU kernel's astype does
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}
// `_keep_mask` for one element: the per-(seed, bh) base, then the hash of the
// absolute (row, col); all arithmetic wraps at 32 bits as jnp.uint32 does
__device__ __forceinline__ uint32_t drop_base(uint32_t seed, uint32_t bh) {
  return splitmix32(seed + bh * 0x27D4EB2Fu);
}
__device__ __forceinline__ bool keep(uint32_t base, uint32_t row,
                                     uint32_t col, uint32_t thresh) {
  return splitmix32(row * 0x9E3779B1u + col * 0x85EBCA77u + base) >= thresh;
}

struct Params {
  int H, Lq, Lk, D;
  float scale;
  int causal;
  int bias_mode;      // 0 none, 1 one row (Bb, 1, Lk), 2 per row (Bb, Lq, Lk)
  int bias_per_head;  // Bb == B * H (else B)
  float rate, inv_keep;
  uint32_t thresh;
};

// additive bias at (absolute row r, key c) of head bh
__device__ __forceinline__ float bias_at(const float* __restrict__ bias,
                                         const Params& p, int bh, int r,
                                         int c) {
  const int bb = p.bias_per_head ? bh : bh / p.H;
  if (p.bias_mode == 1) return bias[(size_t)bb * p.Lk + c];
  return bias[((size_t)bb * p.Lq + r) * p.Lk + c];
}

// the masked, biased score of (r, c) from the raw dot product
__device__ __forceinline__ float score(float dot, const float* bias,
                                       const Params& p, int bh, int r,
                                       int c) {
  const bool valid = r < p.Lq && c < p.Lk && (!p.causal || c <= r);
  if (!valid) return MASK_VALUE;
  float s = dot * p.scale;
  if (p.bias_mode) s += bias_at(bias, p, bh, r, c);
  return s;
}

// stage rows [r0, r0 + rows) of a (BH, L, D) tensor into a [rows][D + 1]
// f32 tile, zero past L
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int bh, int r0, int L, int D,
                                          int rows) {
  const int ld = D + 1;
  const size_t base = ((size_t)bh * L + r0) * D;
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = r0 + r < L ? to_f(src[base + (size_t)r * D + d]) : 0.f;
  }
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two staged tiles
__device__ __forceinline__ void tile_dot(float (&s)[NI][NJ], const float* a,
                                         const float* b, int D, int ty,
                                         int tx) {
  const int ld = D + 1;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float av[NI], bv[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) av[i] = a[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = b[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

size_t fwd_smem(int D) {
  return sizeof(float) * (3 * (size_t)BQ * (D + 1) + (size_t)BQ * LDP + 3 * BQ);
}
size_t dq_smem(int D) {
  return sizeof(float) * (4 * (size_t)BQ * (D + 1) + (size_t)BQ * LDP + 2 * BQ);
}
size_t dkv_smem(int D) {
  return sizeof(float) *
         (4 * (size_t)BQ * (D + 1) + 2 * (size_t)BQ * LDP + 2 * BQ);
}

// ---------------------------------------------------------------------------
// forward: one block per (bh, 64-row q tile)
// ---------------------------------------------------------------------------
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const int* __restrict__ seed, T* __restrict__ out,
                 float* __restrict__ lse, Params p) {
  extern __shared__ float smem[];
  const int D = p.D, ld = D + 1;
  float* qs = smem;                  // [BQ][ld]
  float* ks = qs + BQ * ld;          // [BK][ld]
  float* vs = ks + BK * ld;          // [BK][ld]
  float* ps = vs + BK * ld;          // [BQ][LDP] scores, then p
  float* row_m = ps + BQ * LDP;      // [BQ]
  float* row_l = row_m + BQ;         // [BQ]
  float* row_a = row_l + BQ;         // [BQ] rescale of this tile

  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const uint32_t base =
      p.rate > 0.f ? drop_base((uint32_t)seed[0], (uint32_t)bh) : 0u;

  load_tile(qs, q, bh, q0, p.Lq, D, BQ);
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  float acc[NI][NC];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  // causal: keys past the tile's last row are masked for every row
  const int k_end = p.causal ? min(p.Lk, q0 + BQ) : p.Lk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(ks, k, bh, k0, p.Lk, D, BK);
    load_tile(vs, v, bh, k0, p.Lk, D, BK);
    __syncthreads();
    float s[NI][NJ];
    tile_dot(s, qs, ks, D, ty, tx);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        ps[r * LDP + c] = score(s[i][j], bias, p, bh, q0 + r, k0 + c);
      }
    __syncthreads();
    // online softmax: each warp owns 8 rows, a lane two keys of a row
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const float s0 = ps[r * LDP + lane], s1 = ps[r * LDP + lane + 32];
      const float m_prev = row_m[r];
      const float m_next = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      float p0 = s0 > 0.5f * MASK_VALUE ? expf(s0 - m_next) : 0.f;
      float p1 = s1 > 0.5f * MASK_VALUE ? expf(s1 - m_next) : 0.f;
      const float alpha = expf(m_prev - m_next);
      const float l_next = alpha * row_l[r] + warp_sum(p0 + p1);
      if (p.rate > 0.f) {
        const uint32_t row = (uint32_t)(q0 + r);
        p0 = keep(base, row, (uint32_t)(k0 + lane), p.thresh)
                 ? p0 * p.inv_keep : 0.f;
        p1 = keep(base, row, (uint32_t)(k0 + lane + 32), p.thresh)
                 ? p1 * p.inv_keep : 0.f;
      }
      ps[r * LDP + lane] = round_t<T>(p0);
      ps[r * LDP + lane + 32] = round_t<T>(p1);
      if (lane == 0) {
        row_m[r] = m_next;
        row_l[r] = l_next;
        row_a[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float a = row_a[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= a;
    }
    for (int j = 0; j < BK; ++j) {
      float pv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) pv[i] = ps[(ty + 16 * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float vv = vs[j * ld + d];
#pragma unroll
          for (int i = 0; i < NI; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r < p.Lq) {
      const float l = row_l[r];
      const float l_safe = l == 0.f ? 1.f : l;
      const size_t ob = ((size_t)bh * p.Lq + q0 + r) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) out[ob + d] = from_f<T>(acc[i][c] / l_safe);
      }
    }
  }
  if (tid < BQ && q0 + tid < p.Lq) {
    const float l = row_l[tid];
    lse[(size_t)bh * p.Lq + q0 + tid] =
        l == 0.f ? 0.f : row_m[tid] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// backward 1: di = rowsum(dO * O) and dQ, one block per (bh, 64-row q tile)
// ---------------------------------------------------------------------------
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                const int* __restrict__ seed, const T* __restrict__ o,
                const float* __restrict__ lse, const T* __restrict__ dout,
                float* __restrict__ di, T* __restrict__ dq, Params p) {
  extern __shared__ float smem[];
  const int D = p.D, ld = D + 1;
  float* qs = smem;                  // [BQ][ld]
  float* dos = qs + BQ * ld;         // [BQ][ld]
  float* ks = dos + BQ * ld;         // [BK][ld]
  float* vs = ks + BK * ld;          // [BK][ld]
  float* dss = vs + BK * ld;         // [BQ][LDP] dS
  float* row_lse = dss + BQ * LDP;   // [BQ]
  float* row_di = row_lse + BQ;      // [BQ]

  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const uint32_t base =
      p.rate > 0.f ? drop_base((uint32_t)seed[0], (uint32_t)bh) : 0u;

  load_tile(qs, q, bh, q0, p.Lq, D, BQ);
  load_tile(dos, dout, bh, q0, p.Lq, D, BQ);
  __syncthreads();
  // di per row (unchanged by dropout, :332-338), kept for the dK/dV kernel
  for (int rr = 0; rr < BQ / 8; ++rr) {
    const int r = warp * (BQ / 8) + rr;
    const bool live = q0 + r < p.Lq;
    float sum = 0.f;
    if (live) {
      const size_t ob = ((size_t)bh * p.Lq + q0 + r) * D;
      for (int d = lane; d < D; d += 32)
        sum = fmaf(dos[r * ld + d], to_f(o[ob + d]), sum);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      row_di[r] = sum;
      row_lse[r] = live ? lse[(size_t)bh * p.Lq + q0 + r] : 0.f;
      if (live) di[(size_t)bh * p.Lq + q0 + r] = sum;
    }
  }
  float acc[NI][NC];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  const int k_end = p.causal ? min(p.Lk, q0 + BQ) : p.Lk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile(ks, k, bh, k0, p.Lk, D, BK);
    load_tile(vs, v, bh, k0, p.Lk, D, BK);
    __syncthreads();
    float s[NI][NJ], dp[NI][NJ];
    tile_dot(s, qs, ks, D, ty, tx);
    tile_dot(dp, dos, vs, D, ty, tx);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float sv = score(s[i][j], bias, p, bh, q0 + r, k0 + c);
        const float pr = sv > 0.5f * MASK_VALUE ? expf(sv - row_lse[r]) : 0.f;
        float dpv = dp[i][j];
        if (p.rate > 0.f)
          dpv = keep(base, (uint32_t)(q0 + r), (uint32_t)(k0 + c), p.thresh)
                    ? dpv * p.inv_keep : 0.f;
        dss[r * LDP + c] = round_t<T>(pr * (dpv - row_di[r]) * p.scale);
      }
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float dsv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) dsv[i] = dss[(ty + 16 * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float kv = ks[j * ld + d];
#pragma unroll
          for (int i = 0; i < NI; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r < p.Lq) {
      const size_t ob = ((size_t)bh * p.Lq + q0 + r) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) dq[ob + d] = from_f<T>(acc[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward 2: dK and dV, one block per (bh, 64-key tile)
// ---------------------------------------------------------------------------
// two blocks per SM: with D = 128 (NC = 8) the kernel wants 173 registers
// and only one block would fit, leaving the walk over q tiles nothing to
// hide its shared-memory latency behind
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS, 2)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const int* __restrict__ seed, const float* __restrict__ lse,
                 const float* __restrict__ di, const T* __restrict__ dout,
                 T* __restrict__ dk, T* __restrict__ dv, Params p) {
  extern __shared__ float smem[];
  const int D = p.D, ld = D + 1;
  float* ks = smem;                  // [BK][ld]
  float* vs = ks + BK * ld;          // [BK][ld]
  float* qs = vs + BK * ld;          // [BQ][ld]
  float* dos = qs + BQ * ld;         // [BQ][ld]
  float* pds = dos + BQ * ld;        // [BQ][LDP] dropped p
  float* dss = pds + BQ * LDP;       // [BQ][LDP] dS
  float* row_lse = dss + BQ * LDP;   // [BQ]
  float* row_di = row_lse + BQ;      // [BQ]

  const int bh = blockIdx.x, k0 = blockIdx.y * BK;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const uint32_t base =
      p.rate > 0.f ? drop_base((uint32_t)seed[0], (uint32_t)bh) : 0u;

  load_tile(ks, k, bh, k0, p.Lk, D, BK);
  load_tile(vs, v, bh, k0, p.Lk, D, BK);
  // thread (ty, tx) owns key rows ty + 16 i and head-dim columns tx + 16 c
  float acck[NI][NC], accv[NI][NC];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acck[i][c] = accv[i][c] = 0.f;

  // causal: q tiles whose last row is above this key tile see none of it
  const int q_start = p.causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_start; q0 < p.Lq; q0 += BQ) {
    __syncthreads();
    load_tile(qs, q, bh, q0, p.Lq, D, BQ);
    load_tile(dos, dout, bh, q0, p.Lq, D, BQ);
    if (tid < BQ) {
      const bool live = q0 + tid < p.Lq;
      row_lse[tid] = live ? lse[(size_t)bh * p.Lq + q0 + tid] : 0.f;
      row_di[tid] = live ? di[(size_t)bh * p.Lq + q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[NI][NJ], dp[NI][NJ];
    tile_dot(s, qs, ks, D, ty, tx);
    tile_dot(dp, dos, vs, D, ty, tx);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float sv = score(s[i][j], bias, p, bh, q0 + r, k0 + c);
        const float pr = sv > 0.5f * MASK_VALUE ? expf(sv - row_lse[r]) : 0.f;
        float pd = pr, dpv = dp[i][j];
        if (p.rate > 0.f) {
          const bool kp =
              keep(base, (uint32_t)(q0 + r), (uint32_t)(k0 + c), p.thresh);
          pd = kp ? pr * p.inv_keep : 0.f;
          dpv = kp ? dpv * p.inv_keep : 0.f;
        }
        pds[r * LDP + c] = round_t<T>(pd);
        dss[r * LDP + c] = round_t<T>(pr * (dpv - row_di[r]) * p.scale);
      }
    __syncthreads();
    // dV += Pd^T dO and dK += dS^T Q over this tile's q rows
    for (int r = 0; r < BQ; ++r) {
      float pv[NI], dsv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        pv[i] = pds[r * LDP + ty + 16 * i];
        dsv[i] = dss[r * LDP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float dov = dos[r * ld + d], qv = qs[r * ld + d];
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            accv[i][c] = fmaf(pv[i], dov, accv[i][c]);
            acck[i][c] = fmaf(dsv[i], qv, acck[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int j = ty + 16 * i;
    if (k0 + j < p.Lk) {
      const size_t ob = ((size_t)bh * p.Lk + k0 + j) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          dk[ob + d] = from_f<T>(acck[i][c]);
          dv[ob + d] = from_f<T>(accv[i][c]);
        }
      }
    }
  }
}

Params make_params(int H, int Lq, int Lk, int D, float scale, int causal,
                   int bias_mode, int bias_per_head, float rate,
                   float inv_keep, unsigned thresh) {
  Params p;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  p.scale = scale;
  p.causal = causal;
  p.bias_mode = bias_mode;
  p.bias_per_head = bias_per_head;
  p.rate = rate;
  p.inv_keep = inv_keep;
  p.thresh = thresh;
  return p;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

template <typename T, int NC>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* bias, const void* seed, void* out,
                       void* lse, int BH, const Params& p,
                       cudaStream_t stream) {
  static bool attr = false;
  cudaError_t e = allow_smem(flash_fwd_kernel<T, NC>, fwd_smem(MAX_D), attr);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (p.Lq + BQ - 1) / BQ);
  flash_fwd_kernel<T, NC><<<grid, THREADS, fwd_smem(p.D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(seed), static_cast<T*>(out),
      static_cast<float*>(lse), p);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* bias, const void* seed, const void* o,
                       const void* lse, const void* dout, void* di, void* dq,
                       void* dk, void* dv, int BH, const Params& p,
                       cudaStream_t stream) {
  static bool attr_dq = false, attr_dkv = false;
  cudaError_t e = allow_smem(flash_dq_kernel<T, NC>, dq_smem(MAX_D), attr_dq);
  if (e != cudaSuccess) return e;
  e = allow_smem(flash_dkv_kernel<T, NC>, dkv_smem(MAX_D), attr_dkv);
  if (e != cudaSuccess) return e;
  if (p.Lq > 0) {
    dim3 gq(BH, (p.Lq + BQ - 1) / BQ);
    flash_dq_kernel<T, NC><<<gq, THREADS, dq_smem(p.D), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(bias),
        static_cast<const int*>(seed), static_cast<const T*>(o),
        static_cast<const float*>(lse), static_cast<const T*>(dout),
        static_cast<float*>(di), static_cast<T*>(dq), p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (p.Lk == 0) return cudaSuccess;
  // same stream: the dK/dV kernel reads the di the dQ kernel wrote
  dim3 gk(BH, (p.Lk + BK - 1) / BK);
  flash_dkv_kernel<T, NC><<<gk, THREADS, dkv_smem(p.D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(seed), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<const T*>(dout),
      static_cast<T*>(dk), static_cast<T*>(dv), p);
  return cudaGetLastError();
}

}  // namespace

// q (BH, Lq, D), k/v (BH, Lk, D), out (BH, Lq, D) in one type (f32, or bf16
// when is_bf16); lse (BH, Lq) f32; bias f32 (Bb, 1|Lq, Lk) or null
// (bias_mode 0); seed a device int32 (read only when rate > 0).  All
// contiguous; the caller checks shapes (D <= 128).  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int mxt_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* seed, void* out, void* lse, int BH, int H, int Lq, int Lk,
    int D, float scale, int causal, int bias_mode, int bias_per_head,
    float rate, float inv_keep, unsigned thresh, int is_bf16, void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (D > MAX_D || D < 1) return (int)cudaErrorInvalidValue;
  if (BH == 0 || Lq == 0) return 0;
  const Params p = make_params(H, Lq, Lk, D, scale, causal, bias_mode,
                               bias_per_head, rate, inv_keep, thresh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)(D <= 64 ? launch_fwd<__nv_bfloat16, 4>(q, k, v, bias, seed,
                                                         out, lse, BH, p, s)
                         : launch_fwd<__nv_bfloat16, 8>(q, k, v, bias, seed,
                                                         out, lse, BH, p, s));
  return (int)(D <= 64
                   ? launch_fwd<float, 4>(q, k, v, bias, seed, out, lse, BH,
                                          p, s)
                   : launch_fwd<float, 8>(q, k, v, bias, seed, out, lse, BH,
                                          p, s));
}

// The backward of the call above: dout, o in the input type, lse from the
// forward; di (BH, Lq) f32 is scratch; dq/dk/dv like q/k/v.  Launches the
// dQ kernel, then the dK/dV kernel, on `stream`.
extern "C" int mxt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* seed, const void* o, const void* lse, const void* dout,
    void* di, void* dq, void* dk, void* dv, int BH, int H, int Lq, int Lk,
    int D, float scale, int causal, int bias_mode, int bias_per_head,
    float rate, float inv_keep, unsigned thresh, int is_bf16, void* stream) {
  cudaGetLastError();
  if (D > MAX_D || D < 1) return (int)cudaErrorInvalidValue;
  if (BH == 0 || (Lq == 0 && Lk == 0)) return 0;
  const Params p = make_params(H, Lq, Lk, D, scale, causal, bias_mode,
                               bias_per_head, rate, inv_keep, thresh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)(D <= 64
                     ? launch_bwd<__nv_bfloat16, 4>(q, k, v, bias, seed, o,
                                                     lse, dout, di, dq, dk,
                                                     dv, BH, p, s)
                     : launch_bwd<__nv_bfloat16, 8>(q, k, v, bias, seed, o,
                                                     lse, dout, di, dq, dk,
                                                     dv, BH, p, s));
  return (int)(D <= 64 ? launch_bwd<float, 4>(q, k, v, bias, seed, o, lse,
                                              dout, di, dq, dk, dv, BH, p, s)
                       : launch_bwd<float, 8>(q, k, v, bias, seed, o, lse,
                                              dout, di, dq, dk, dv, BH, p, s));
}
