// Flash attention, forward and backward, for Hopper (sm_90a): CUDA C++ with a
// plain C entry per direction.
//
// Replaces the Pallas TPU kernels of mxnet_tpu/ops/pallas/flash_attention.py:
//   forward   `_fwd_kernel` (:152), launched by `_flash_fwd` (:284);
//   backward  `_dq_kernel` (:341) and `_dkv_kernel` (:395), launched by
//             `_flash_bwd` (:489, :517).
//
// What it computes (the TPU kernels' semantics, not their grid), over
// q (BH, Lq, D), k/v (BH, Lk, D), BH = batch * heads, in f32, bf16 or f16:
//   * s = (q . k) * scale in f32 (16-bit products accumulate in f32), plus an
//     optional f32 additive bias (Bb, 1|seg, Lk) with Bb = B (shared by the
//     H heads of a batch row) or B * H.  Row r sits at position r % seg:
//     seg = Lq, or, with grouped K/V (the `rep` query heads sharing a kv
//     head folded onto the row axis, `_eff_qi` :81), the unfolded length.
//     A row at position q sees the keys [q - lo_w, q + hi_w]: causal and a
//     sliding window (`_band_mask` :91) both narrow that band.  A masked or
//     padded score is MASK_VALUE and its p is forced to exactly 0, so a row
//     whose keys are all masked writes zeros with lse = 0 and gets zero
//     gradients (:221-229).  Key tiles outside a q tile's band are never
//     loaded or computed (`_band_block_live` :106): a window costs O(L w).
//   * online softmax per row in f32; lse = m + log(l) is written as (BH, Lq)
//     f32, one value per row.
//   * attention-probs dropout from the counter hash `_splitmix32` /
//     `_keep_mask` (:119-145), bit for bit: keyed on the int32 seed, the bh
//     index and the absolute row and column; the normaliser l comes from the
//     undropped p, the kept p is scaled by 1 / (1 - rate) (:202-208), and the
//     backward applies the same mask to dP and to P (:374-376, :426-439).
//   * p (and dS) are rounded to the input type before their products, as the
//     TPU kernels cast them to v's (k's, q's) dtype.  In f16 a value past
//     its range rounds to +-inf (dS, dQ, dK, dV, O), as JAX's casts do: a
//     loss scaler must see the same overflow, so nothing saturates.
//   * backward by recompute from lse: di = rowsum(dO * O); dQ, dK and dV
//     without float atomics, so the result is deterministic.
//
// What bounds it on the H100: at BERT's shapes (B 64, H 12, L = 128,
// D = 64) the forward does 4 * BH * Lq * Lk * D = 3.2 GFLOP against 50 MB
// of q/k/v/o in bf16 (100 MB in f32): about 0.015 ms of memory traffic
// against 0.003 ms of bf16 tensor-core work (0.019 ms of 3xTF32 products
// in f32), so its floor is bytes (f16 moves bf16's).  What holds it above
// that floor is instruction issue and latency: each score takes a dozen
// scalar instructions (scale, bias, mask, max, exp, sum, dropout hash)
// beside its share of two products, in a dependent chain per warp.  So the
// design reads each operand once and keeps S and P out of memory, keeps
// each score's passes free of branches, and fits as many warps an SM as
// the registers allow.  The backward does 10x the forward's products, so
// in bf16 and f16 the tensor cores' rate, in f32 three TF32 products a
// multiply-add.
//
// Forward (`flash_fwd_kernel`), FlashAttention-2's shape on mma.sync:
// work items of 32, 64 or 128 query rows of a head, one warp per 16 rows,
// the tiles chosen by the host's `_fwd_plan` (the `flash_attention`
// tunable); persistent blocks, as many as fit on the card, walk the items.
// Q is loaded by 16-byte cp.async and, for heads up to 128 wide, kept in
// registers as A fragments for an item's key walk (wider heads read them
// from shared memory at each step: their O alone takes 128 registers a
// lane); K and V stream through a two-stage cp.async ring of 32-, 64- or
// 128-key tiles that runs on across items, so the next item's Q, K and
// V load while this one computes (at L = 128 a head is one or two key
// tiles).  S = Q K^T runs on the tensor cores (bf16 and f16 m16n8k16, f32
// 3xTF32 m16n8k8, f32 accumulation); scale, bias, mask, the online softmax and
// dropout act on the accumulator fragments in registers (row max by two
// quad shuffles), in straight-line passes whose variant (bias mode, a step
// with nothing to mask, dropout) is chosen once a step; p, rounded to the
// input type, feeds O += P V as the A operand straight from the
// accumulators, with V read through ldmatrix.trans.  P never touches
// shared memory, and the ring's handoff is the only block barrier of the
// walk.  No atomics: two calls give the same bits.  wgmma and TMA are left
// out: at these shapes the tensor cores are not the limit.
//
// Backward (`flash_bwd_kernel`), one pass per key tile: a block holds a
// tile of 64 or 128 keys (the host's `_bwd_plan` picks) with K and V in
// shared memory and its dK, dV accumulators in registers, and walks the q
// tiles through a two-stage 16-byte cp.async ring of Q, dO, lse and di.
// Each q tile is five tensor-core products -- S = Q K^T, dP = dO V^T,
// dV += Pd^T dO, dK += dS^T Q, dQ = dS K -- each operand read once: bf16
// and f16 as mma.sync m16n8k16 from ldmatrix fragments with f32
// accumulation, f32 as 3xTF32 m16n8k8 (hi/lo halves of both operands;
// plain TF32 keeps three digits).  P and dS feed dV and dK from
// registers, rounded to the input type; dS goes through shared memory once
// for dQ.  With one key tile (BERT:
// L = 128 in a 128-key tile) the block writes dQ; with more, the key tiles'
// f32 partials are summed in key-tile order by the last block to arrive on
// an integer ticket per (bh, q tile).  A light row pass computes di first,
// so a call is two launches.  A key tile's dK and dV sum over its q
// tiles in the tensor cores' f32 accumulators, whose additions drift by
// about 2^-24 of the sum each (over 8192 rows of Gemma 2B's folded
// heads, 1.4e-4): the host caps the rows a block sums (`_bwd_plan`'s
// q splits) and the splits' partials are summed in order in f32.  Heads
// over 128 wide give each 16 keys two warps, each accumulating dK and dV
// over half the columns (both compute the keys' S and dP).  Any Lq, Lk
// (ragged tiles are masked) and D <= 256 (tiles padded to 64, 128 or 256
// columns).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "mma_sm90.cuh"   // cp.async, ldmatrix, mma.sync, arrive_last

// The input types this library instantiates, a bit per dtype code (1 f32,
// 2 bf16, 4 f16).  The build (mxnet_tpu_torch/kernels `_SPLITS`) compiles
// this source once per type, in parallel, with -DMXT_FLASH_TYPES; an entry
// point given a type its library lacks returns cudaErrorInvalidValue.
#ifndef MXT_FLASH_TYPES
#define MXT_FLASH_TYPES 7
#endif

namespace {

constexpr float MASK_VALUE = -1e30f;
// a band edge that never binds (positions stay below 2^30)
constexpr int NO_EDGE = 1 << 30;
constexpr int MAX_D = 256;
// shared memory a block may use, and an SM holds (H100)
constexpr size_t SMEM_BLOCK = 232448;
constexpr size_t SMEM_SM = 233472;

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
  int seg;            // row r sits at position r % seg
  uint32_t seg_m;     // ceil(2^32 / seg) (2^32 - 1 for seg 1): `pos_of`
  int lo_w, hi_w;     // a row at position q sees keys [q - lo_w, q + hi_w]
  int bias_mode;      // 0 none, 1 one row (Bb, 1, Lk), 2 per row (Bb, seg, Lk)
  int bias_per_head;  // Bb == B * H (else B)
  float rate, inv_keep;
  uint32_t thresh;
};

// row r's position, r % seg, for 0 <= r < 2^31 without a branch: seg_m
// exceeds 2^32 / seg by under 1, so the high half of r * seg_m is the
// quotient or one over (one under for seg 1, whose seg_m is 2^32 - 1), and
// one correction each way fixes the remainder
__device__ __forceinline__ int pos_of(const Params& p, int r) {
  int x = r - p.seg * (int)__umulhi((uint32_t)r, p.seg_m);
  x += x < 0 ? p.seg : 0;
  return x >= p.seg ? x - p.seg : x;
}

// row r's position: pos_of under BAND (a window or the fold), else the
// row itself -- the backward takes BAND as a template argument, so a call
// without either runs none of the band's code
template <bool BAND>
__device__ __forceinline__ int pos_at(const Params& p, int r) {
  if constexpr (BAND)
    return pos_of(p, r);
  else
    return r;
}

// the positions of rows [r0, r0 + n), n >= 1 and r0 < Lq, as a range: the
// rows' own when they stay in one head segment, else every position (a
// range of rows that wraps holds position seg - 1 and position 0)
template <bool BAND>
__device__ __forceinline__ int2 pos_span(const Params& p, int r0, int n) {
  const int p0 = pos_at<BAND>(p, r0);
  const int pe = p0 + min(n, p.Lq - r0) - 1;
  return pe < p.seg ? make_int2(p0, pe) : make_int2(0, p.seg - 1);
}

// the keys [first, last] within [0, Lk) that rows at positions ps may see
// (first > last: none); the bands of consecutive positions overlap, so
// every key tile between first's and last's holds a live key
__device__ __forceinline__ int2 key_span(const Params& p, int2 ps) {
  return make_int2(max(0, ps.x - p.lo_w), min(p.Lk - 1, ps.y + p.hi_w));
}

// ---------------------------------------------------------------------------
// backward: di = rowsum(dO * O) (a row pass), then one pass per key tile
// ---------------------------------------------------------------------------

// the dot product of two 16-byte vectors of T, in f32
__device__ __forceinline__ float dot16(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, x.x * y.x)));
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* a,
                                       const __nv_bfloat16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s = fmaf(__uint_as_float(xs[i] << 16), __uint_as_float(ys[i] << 16), s);
    s = fmaf(__uint_as_float(xs[i] & 0xffff0000u),
             __uint_as_float(ys[i] & 0xffff0000u), s);
  }
  return s;
}
__device__ __forceinline__ float dot16(const __half* a, const __half* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __half2 xh, yh;
    memcpy(&xh, &xs[i], 4);
    memcpy(&yh, &ys[i], 4);
    const float2 xf = __half22float2(xh), yf = __half22float2(yh);
    s = fmaf(xf.x, yf.x, s);
    s = fmaf(xf.y, yf.y, s);
  }
  return s;
}

// di of every row: with vec (rows of whole 16-byte chunks, aligned) 8
// lanes a row and 16-byte loads, else one warp a row
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_di_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ di, int rows, int D, int vec) {
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int lpr = vec ? 8 : 32;  // lanes a row
  const int row = gt / lpr, l = threadIdx.x & (lpr - 1);
  float s = 0.f;
  if (row < rows) {
    const size_t b = (size_t)row * D;
    if (vec) {
      constexpr int EPC = 16 / sizeof(T);
      for (int d0 = l * EPC; d0 < D; d0 += 8 * EPC)
        s += dot16(o + b + d0, dout + b + d0);
    } else {
      for (int d = l; d < D; d += 32)
        s = fmaf(to_f(dout[b + d]), to_f(o[b + d]), s);
    }
  }
  for (int off = lpr / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && l == 0) di[row] = s;
}

// 2^x in one MUFU op (relative error about 2^-22; results below 2^-126
// flush to 0): the backward's exp(s - lse) as 2^((s - lse) log2 e)
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// q rows a step of the walk: 64, or 32 for heads over 64 wide (the dK and
// dV accumulators of a 128-wide head take 128 registers a thread)
template <int DMAX> struct BwdQ {
  static constexpr int v = DMAX <= 64 ? 64 : 32;
};

// The backward's block: BK keys, 16 a warp, with CS warps sharing each 16
// keys -- 2 for heads over 128 wide, each warp accumulating dK and dV over
// DMAX / CS columns (a 256-wide head's would take 256 registers a thread)
// -- and KVB K/V buffers: 2 for 16-bit types (persistent blocks load the next
// item's during this one), 1 for f32, whose tiles fill shared memory.
template <typename T, int DMAX, int BK> struct Bwd {
  static constexpr int CS = DMAX > 128 ? 2 : 1;
  static constexpr int KW = BK / 16, WARPS = KW * CS, THREADS = 32 * WARPS;
  static constexpr int KVB = sizeof(T) == 2 ? 2 : 1;
};

template <typename T, int DMAX, int BK, int KVB>
constexpr size_t bwd_smem() {
  return sizeof(T) * ((size_t)(2 * KVB * BK + 4 * BwdQ<DMAX>::v) *
                          (DMAX + Mma<T>::PAD) +
                      (size_t)BK * (BwdQ<DMAX>::v + Mma<T>::PAD)) +
         sizeof(float) * 6 * BwdQ<DMAX>::v;
}

// rows [r0, r0 + rows) of one head's (L, D) slab into a [rows][ld] tile of
// DMAX columns, zero past L and D: 16-byte cp.async where rows are 16-byte
// multiples on aligned pointers (vec), else plain loads
template <typename T, int DMAX, int THREADS>
__device__ __forceinline__ void stage_rows(T* dst, int ld,
                                           const T* __restrict__ src, int r0,
                                           int L, int D, int rows, bool vec) {
  if (vec) {
    constexpr int EPC = 16 / sizeof(T);
    constexpr int CPR = DMAX / EPC;
    for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
      const int r = i / CPR, d0 = (i % CPR) * EPC;
      const bool live = r0 + r < L && d0 < D;
      cp_async16(dst + r * ld + d0,
                 live ? src + (size_t)(r0 + r) * D + d0 : src, live ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DMAX; i += THREADS) {
      const int r = i / DMAX, d = i % DMAX;
      dst[r * ld + d] = r0 + r < L && d < D ? src[(size_t)(r0 + r) * D + d]
                                            : from_f<T>(0.f);
    }
  }
}

// the inverse of stage_rows: rows [r0, r0 + rows) of a [rows][ld] tile
// to one head's (L, D) slab, rows past L and columns past D left out
template <typename T, int DMAX, int THREADS>
__device__ __forceinline__ void unstage_rows(T* __restrict__ dst,
                                             const T* src, int ld, int r0,
                                             int L, int D, int rows,
                                             bool vec) {
  if (vec) {
    constexpr int EPC = 16 / sizeof(T);
    constexpr int CPR = DMAX / EPC;
    for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
      const int r = i / CPR, d0 = (i % CPR) * EPC;
      if (r0 + r < L && d0 < D)
        *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * D + d0) =
            *reinterpret_cast<const uint4*>(src + r * ld + d0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DMAX; i += THREADS) {
      const int r = i / DMAX, d = i % DMAX;
      if (r0 + r < L && d < D) dst[(size_t)(r0 + r) * D + d] = src[r * ld + d];
    }
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (bh, q tile of BQ rows), one warp per 16 rows
// ---------------------------------------------------------------------------

// A warp's Q tile as A fragments, held in registers for the whole key walk:
// 16-bit as the ldmatrix fragment itself; f32 as the raw values, split into
// TF32 hi and lo at each use (the split fragment takes twice the registers)
template <typename T> struct QFrag {
  typename Mma<T>::A a;
  __device__ __forceinline__ void load(const T* X, int ld, int m0, int k0,
                                       int lane) {
    Mma<T>::a_row(a, X, ld, m0, k0, lane);
  }
  __device__ __forceinline__ typename Mma<T>::A get() const { return a; }
};
template <> struct QFrag<float> {
  float f[4];  // the slots (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  __device__ __forceinline__ void load(const float* X, int ld, int m0,
                                       int k0, int lane) {
    const float* r0 = X + (m0 + (lane >> 2)) * ld + k0 + (lane & 3);
    const float* r8 = r0 + 8 * ld;
    f[0] = r0[0];
    f[1] = r8[0];
    f[2] = r0[4];
    f[3] = r8[4];
  }
  __device__ __forceinline__ Mma<float>::A get() const {
    Mma<float>::A a;
    Mma<float>::set_a(a, f[0], f[1], f[2], f[3]);
    return a;
  }
};

// rows [0, rows) of a warp's [16][LD] staging tile to dst (row stride D),
// columns past D left out: 16-byte stores with vec, else one element a lane
template <typename T, int DMAX, int LD>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const T* stg,
                                           int rows, int D, int lane,
                                           int vec) {
  if (vec) {
    constexpr int EPC = 16 / sizeof(T), CPR = DMAX / EPC;
    for (int i = lane; i < 16 * CPR; i += 32) {
      const int r = i / CPR, d0 = (i % CPR) * EPC;
      if (r < rows && d0 < D)
        *reinterpret_cast<uint4*>(dst + (size_t)r * D + d0) =
            *reinterpret_cast<const uint4*>(stg + r * LD + d0);
    }
  } else {
    for (int i = lane; i < 16 * DMAX; i += 32) {
      const int r = i / DMAX, d = i % DMAX;
      if (r < rows && d < D) dst[(size_t)r * D + d] = stg[r * LD + d];
    }
  }
}

// Scale, bias and mask one step's scores in place (natural-log units) and
// fold their row maxima into mx.  Element (jj, e) is row r0 + 8 (e >> 1),
// key kc + 8 jj + 2 t + (e & 1).  The rows' positions are found here, in
// the steps that need them, not kept across the walk.  MODE is the bias
// mode (0 none, 1 a key row, 2 a row per query position); FULL: the whole
// step lies inside the item's rows and keys and inside every row's band,
// so nothing is masked.  Straight line: bias loads are clamped into range
// and masking is two compares with the row's key range, so no element
// branches (the step's variant is chosen once, outside).
template <int MODE, bool FULL, int NS>
__device__ __forceinline__ void score_step(float (&s)[NS][4],
                                           float (&mx)[2], const Params& p,
                                           const float* __restrict__ bias,
                                           int bb, int r0, int kc, int t) {
  // the rows' positions (a row past Lq: any in range) and each row's keys
  // [klo, khi], its band within [0, Lk), none past Lq
  const int pr[2] = {pos_of(p, min(r0, p.Lq - 1)),
                     pos_of(p, min(r0 + 8, p.Lq - 1))};
  int klo[2], khi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    klo[h] = pr[h] - p.lo_w;
    khi[h] = r0 + 8 * h < p.Lq ? min(p.Lk - 1, pr[h] + p.hi_w) : -1;
  }
  const float* brow[2] = {bias, bias};
  if (MODE == 1) brow[0] = brow[1] = bias + (size_t)bb * p.Lk;
  if (MODE == 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      brow[h] = bias + ((size_t)bb * p.seg + pr[h]) * p.Lk;
  }
  const bool pairs = FULL && !(p.Lk & 1);  // 8-byte aligned key pairs
#pragma unroll
  for (int jj = 0; jj < NS; ++jj) {
    const int c = kc + 8 * jj + 2 * t;
    float b[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    if (MODE != 0) {
#pragma unroll
      for (int h = 0; h < (MODE == 1 ? 1 : 2); ++h) {
        if (pairs) {
          const float2 x = __ldg(reinterpret_cast<const float2*>(brow[h] + c));
          b[h][0] = x.x;
          b[h][1] = x.y;
        } else {
          b[h][0] = __ldg(brow[h] + min(c, p.Lk - 1));
          b[h][1] = __ldg(brow[h] + min(c + 1, p.Lk - 1));
        }
      }
      if (MODE == 1) {
        b[1][0] = b[0][0];
        b[1][1] = b[0][1];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, cc = c + (e & 1);
      float sv = s[jj][e] * p.scale + b[h][e & 1];
      if (!FULL) sv = (cc >= klo[h]) & (cc <= khi[h]) ? sv : MASK_VALUE;
      s[jj][e] = sv;
      mx[h] = fmaxf(mx[h], sv);
    }
  }
}

// p = exp(s - m) in place, exactly 0 where masked, its undropped sum folded
// into l; with DROP, then the dropped, scaled p (`keep` of the element's
// absolute row and key: rkey = row C1 + base, ckey = key C2 of the
// thread's first key)
template <bool DROP, int NS>
__device__ __forceinline__ void softmax_step(float (&s)[NS][4],
                                             float (&l)[2],
                                             const float (&ml)[2],
                                             const uint32_t (&rkey)[2],
                                             uint32_t ckey, const Params& p) {
#pragma unroll
  for (int jj = 0; jj < NS; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float sv = s[jj][e];
      float pr = sv > 0.5f * MASK_VALUE
                     ? exp2_approx(fmaf(sv, LOG2E, -ml[h]))
                     : 0.f;
      l[h] += pr;
      if (DROP) {
        const uint32_t x =
            rkey[h] + ckey + (uint32_t)(8 * jj + (e & 1)) * 0x85EBCA77u;
        pr = splitmix32(x) >= p.thresh ? pr * p.inv_keep : 0.f;
      }
      s[jj][e] = pr;
    }
}

// The forward's tiles: BQ query rows an item (BQ / 16 warps), two Q
// buffers (this item's and the next one's), a two-stage ring of BK-key K
// and V tiles, heads padded to DMAX columns.  As many blocks an SM as the
// shared memory holds, up to 3 for 16-bit 64-wide heads in 4 warps and 2
// otherwise (1 for 8 warps of any other head, whose registers do not fit
// twice): the kernel is bound by issue and latency, and more warps an SM
// hide each warp's dependent chain of products (PERF.md, the flash forward).
// Heads over 128 wide (QSMEM) read Q's fragments from shared memory at
// each step, as a 16 x 256 O accumulator takes 128 registers a lane, and
// walk 32 keys a step (KC) to keep the scores' registers down.
template <typename T, int DMAX, int BQ, int BK> struct Fwd {
  static constexpr int WARPS = BQ / 16, THREADS = 32 * WARPS;
  static constexpr bool QSMEM = DMAX > 128;
  static constexpr int KC = QSMEM ? 32 : 64;   // keys a step of a walk
  static constexpr int LD = DMAX + Mma<T>::PAD;
  static constexpr size_t SMEM = sizeof(T) * (size_t)(2 * BQ + 4 * BK) * LD;
  static constexpr bool FITS = SMEM <= SMEM_BLOCK;
  static constexpr bool NARROW = sizeof(T) == 2 && DMAX == 64;
  static constexpr int MIN_BLOCKS =
      NARROW && THREADS == 128 && 3 * (SMEM + 1024) <= SMEM_SM ? 3
      : 2 * (SMEM + 1024) <= SMEM_SM && (THREADS == 128 || NARROW) ? 2
                                                                 : 1;
};

// Persistent blocks walk work items (bh, q tile of BQ rows), item
// w = bh * nqt + q tile, taking w, w + grid, ...; a warp owns 16 rows of
// the item.  The walk is one stream of (item, key tile) steps through a
// two-stage ring of 16-byte cp.async rows: the step after the current one
// is in flight while it is computed -- the next key tile, or the next
// item's first K/V tile and its Q (into the other Q buffer) -- so one
// item's loads overlap the last one's products.  The ring's handoff is the
// only block barrier.  Each warp walks a key tile in steps of KC = 64
// keys (32 for heads over 128 wide), all in registers: S = Q K^T on the
// tensor cores from Q's fragments (loaded once an item, or each step from
// the Q buffer for heads over 128 wide) and K's fragments; scale, bias
// and mask on the accumulator fragment; the online softmax with the row
// max from two quad shuffles (the row sum stays per thread until the
// item's end); dropout per element on its absolute (row, key); then p,
// rounded to T, is the A operand of O += P V straight from the
// accumulators, with V's fragments from ldmatrix.trans.  An item walks
// only the key tiles its rows' bands reach, a warp only the steps its own
// rows' band reaches, and rows past Lq skip the walk.  The output leaves
// through the item's Q buffer in 16-byte rows.  (Unlike the backward's,
// this kernel is one instantiation for banded and unbanded calls: a
// second, unbanded one spilled more and ran slower on the H100, PERF.md.)
template <typename T, int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(Fwd<T, DMAX, BQ, BK>::THREADS,
                                  Fwd<T, DMAX, BQ, BK>::MIN_BLOCKS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const int* __restrict__ seed, T* __restrict__ out,
                 float* __restrict__ lse, Params p, int nqt, int n_items,
                 int vec) {
  using F = Fwd<T, DMAX, BQ, BK>;
  using M = Mma<T>;
  using A = typename M::A;
  using B = typename M::B;
  constexpr int LD = F::LD, THREADS = F::THREADS;
  constexpr int KC = F::KC;       // keys a step of a warp's walk
  static_assert(BK % KC == 0, "a key tile is whole steps");
  constexpr int NS = KC / 8;      // 8-key n-tiles of a step's scores
  constexpr int ND = DMAX / 8;    // 8-column n-tiles of the output
  constexpr int NQ = DMAX / M::KS;
  extern __shared__ __align__(16) unsigned char fwd_smem_raw[];
  T* qs = reinterpret_cast<T*>(fwd_smem_raw);  // [2][BQ][LD]
  T* ks = qs + 2 * BQ * LD;                    // [2][BK][LD]
  T* vs = ks + 2 * BK * LD;                    // [2][BK][LD]

  const int D = p.D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // an item's key tiles [first, last]: those its rows' bands reach (an item
  // whose rows see no key walks tile 0 and masks it all)
  auto tiles_of = [&](int w) {
    const int2 span = key_span(p, pos_span<true>(p, (w % nqt) * BQ, BQ));
    return span.x <= span.y ? make_int2(span.x / BK, span.y / BK)
                            : make_int2(0, 0);
  };

  // the producer: the next (item, key tile) step to load, its item's key
  // tiles, its item's ordinal in this block's walk (the Q buffer's parity)
  // and its position in the walk (the ring stage's)
  int lw = blockIdx.x, lj = 0, lpos = 0;
  int2 lt = lw < n_items ? tiles_of(lw) : make_int2(0, 0);
  int lkt = lt.x;
  auto issue = [&]() {
    if (lw >= n_items || p.Lk == 0) return;
    const int bh = lw / nqt, q0 = (lw % nqt) * BQ;
    if (lkt == lt.x)
      stage_rows<T, DMAX, THREADS>(qs + (lj & 1) * BQ * LD, LD,
                                   q + (size_t)bh * p.Lq * D, q0, p.Lq, D,
                                   BQ, vec);
    T* kb = ks + (lpos & 1) * BK * LD;
    const T* kh = k + (size_t)bh * p.Lk * D;
    const T* vh = v + (size_t)bh * p.Lk * D;
    stage_rows<T, DMAX, THREADS>(kb, LD, kh, lkt * BK, p.Lk, D, BK, vec);
    stage_rows<T, DMAX, THREADS>(kb + 2 * BK * LD, LD, vh, lkt * BK, p.Lk, D,
                                 BK, vec);
    cp_async_commit();
    ++lpos;
    if (++lkt > lt.y) {
      lw += gridDim.x;
      ++lj;
      if (lw < n_items) lt = tiles_of(lw);
      lkt = lt.x;
    }
  };
  issue();
  issue();

  int pos = 0;  // the walk's position of the step being computed
  for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
    const int bh = w / nqt, q0 = (w % nqt) * BQ;
    const int wr0 = q0 + 16 * warp;   // the warp's first row
    const int r0 = wr0 + g;           // this thread's rows: r0, r0 + 8
    const bool live = wr0 < p.Lq;
    const size_t hq = (size_t)bh * p.Lq;
    const int bb = p.bias_per_head ? bh : bh / p.H;
    const int2 kt_span = tiles_of(w);
    const int kt_last = kt_span.y;
    // the warp's rows' positions: their bands reach keys wps.x - lo_w ..
    // wps.y + hi_w
    const int2 wps = live ? pos_span<true>(p, wr0, 16) : make_int2(0, 0);
    // a row's term of the dropout hash, row * C1 + base (wraps at 32 bits)
    const uint32_t base =
        p.rate > 0.f ? drop_base((uint32_t)seed[0], (uint32_t)bh) : 0u;
    const uint32_t rkey[2] = {(uint32_t)r0 * 0x9E3779B1u + base,
                              (uint32_t)(r0 + 8) * 0x9E3779B1u + base};
    T* qb = qs + (j & 1) * BQ * LD;

    QFrag<T> qf[F::QSMEM ? 1 : NQ];  // unused when Q stays in shared memory
    float o[ND][4];
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    bool first = true;  // the item's first step: load Q's fragments
    for (int kt = kt_span.x; kt <= kt_last; ++kt, ++pos) {
      if (lpos > pos + 1)
        cp_async_wait<1>();  // this step landed; the next may be in flight
      else
        cp_async_wait<0>();
      __syncthreads();
      if constexpr (!F::QSMEM) {
        if (first) {
          first = false;
#pragma unroll
          for (int kk = 0; kk < NQ; ++kk)
            qf[kk].load(qb, LD, 16 * warp, kk * M::KS, lane);
        }
      }
      const T* kb = ks + (pos & 1) * BK * LD;
      const T* vb = kb + 2 * BK * LD;
#pragma unroll
      for (int c0 = 0; c0 < BK; c0 += KC) {
        const int kc = kt * BK + c0;
        if (!live || kc >= p.Lk || kc > wps.y + p.hi_w) break;
        if (kc + KC <= wps.x - p.lo_w) continue;  // below every row's band
        // a step wholly inside the item's rows and keys and inside every
        // row's band needs no mask
        const bool full = kc + KC <= p.Lk && wr0 + 16 <= p.Lq &&
                          kc >= wps.y - p.lo_w &&
                          kc + KC - 1 <= wps.x + p.hi_w;

        // S = Q K^T over the step's 64 keys
        float s[NS][4];
#pragma unroll
        for (int jj = 0; jj < NS; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[jj][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NQ; ++kk) {
          A a;
          if constexpr (F::QSMEM)
            M::a_row(a, qb, LD, 16 * warp, kk * M::KS, lane);
          else
            a = qf[kk].get();
#pragma unroll
          for (int n = 0; n < KC; n += 16) {
            B b[2];
            M::b_nrow(b, kb, LD, c0 + n, kk * M::KS, lane);
            M::mma(s[n / 8], a, b[0]);
            M::mma(s[n / 8 + 1], a, b[1]);
          }
        }

        float mx[2] = {m[0], m[1]};
        switch (p.bias_mode * 2 + (full ? 1 : 0)) {
          case 0:
            score_step<0, false>(s, mx, p, bias, bb, r0, kc, t);
            break;
          case 1:
            score_step<0, true>(s, mx, p, bias, bb, r0, kc, t);
            break;
          case 2:
            score_step<1, false>(s, mx, p, bias, bb, r0, kc, t);
            break;
          case 3:
            score_step<1, true>(s, mx, p, bias, bb, r0, kc, t);
            break;
          case 4:
            score_step<2, false>(s, mx, p, bias, bb, r0, kc, t);
            break;
          default:
            score_step<2, true>(s, mx, p, bias, bb, r0, kc, t);
        }

        // the online softmax: the new row max, then the old sums rescaled
        float ml[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float alpha = exp2_approx((m[h] - mx[h]) * LOG2E);
          m[h] = mx[h];
          ml[h] = mx[h] * LOG2E;
          l[h] *= alpha;
#pragma unroll
          for (int i = 0; i < ND; ++i) {
            o[i][2 * h] *= alpha;
            o[i][2 * h + 1] *= alpha;
          }
        }
        const uint32_t ckey = (uint32_t)(kc + 2 * t) * 0x85EBCA77u;
        if (p.rate > 0.f)
          softmax_step<true>(s, l, ml, rkey, ckey, p);
        else
          softmax_step<false>(s, l, ml, rkey, ckey, p);

        // O += P V, P rounded to T from the accumulators
#pragma unroll
        for (int jj = 0; jj < KC / M::KS; ++jj) {
          A a;
          M::a_acc(a, s, jj);
#pragma unroll
          for (int n = 0; n < DMAX; n += 16) {
            B b[2];
            M::b_krow_acc(b, vb, LD, c0 + jj * M::KS, n, lane);
            M::mma(o[n / 8], a, b[0]);
            M::mma(o[n / 8 + 1], a, b[1]);
          }
        }
      }

      if (kt == kt_last) {
        // O / l and lse = m + log l (0 and zeros for a row with no
        // unmasked key), O through the warp's own rows of the item's Q
        // buffer (read by no other warp, and by this one only at the
        // item's first step), then whole rows of out
        float inv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
          inv[h] = l[h] == 0.f ? 1.f : 1.f / l[h];
          const int r = r0 + 8 * h;
          if (t == 0 && r < p.Lq)
            lse[hq + r] = l[h] == 0.f ? 0.f : m[h] + logf(l[h]);
        }
        if (live) {
          T* stg = qb + 16 * warp * LD;
          if constexpr (F::QSMEM)
            __syncwarp();  // every lane has read its Q rows for this step
#pragma unroll
          for (int i = 0; i < ND; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              M::store2(stg + (g + 8 * h) * LD + 8 * i + 2 * t,
                        o[i][2 * h] * inv[h], o[i][2 * h + 1] * inv[h]);
          __syncwarp();
          store_rows<T, DMAX, LD>(out + (hq + wr0) * D, stg,
                                  min(16, p.Lq - wr0), D, lane, vec);
        }
      }
      __syncthreads();  // every warp is done with this stage (and Q buffer)
      issue();          // the step two ahead, into this stage
    }
  }
  if (p.Lk == 0) {  // no keys: every row is zeros with lse 0
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const int bh = w / nqt, wr0 = (w % nqt) * BQ + 16 * warp;
      for (int i = lane; i < 16 * D; i += 32)
        if (wr0 + i / D < p.Lq)
          out[((size_t)bh * p.Lq + wr0) * D + i] = from_f<T>(0.f);
      if (lane < 16 && wr0 + lane < p.Lq)
        lse[(size_t)bh * p.Lq + wr0 + lane] = 0.f;
    }
  }
}

// One q tile's element pass of the backward: s (S^T) becomes Pd, p
// dropped, and dp (dP^T) becomes dS = P (dP - di) scale.  Element (n-tile
// j, e) is key key_lo + 8 (e >> 1), q row q0 + 8 j + 2 t + (e & 1).  BAND
// (a window, the fold) reads each row's position from pb, where a row past
// Lq holds one no key's band reaches; without it a row's position is the
// row, and the band is causal's or none: the unbanded call pays nothing
// for the band.
template <bool BAND, int NQ>
__device__ __forceinline__ void bwd_probs(
    float (&s)[NQ][4], float (&dp)[NQ][4], const Params& p,
    const float* __restrict__ bias, const float (&kbias)[2], int bb,
    uint32_t base, int q0, int key_lo, int t, const float* lb,
    const float* db, const int* pb) {
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = 8 * j + 2 * t + (e & 1), r = q0 + rl;
      const int c = key_lo + 8 * (e >> 1);
      int pos = r;
      bool valid;
      if constexpr (BAND) {
        pos = pb[rl];
        valid = c < p.Lk && pos >= c - p.hi_w && pos <= c + p.lo_w;
      } else {
        valid = r < p.Lq && c < p.Lk && c <= r + p.hi_w;
      }
      float sv = MASK_VALUE;
      if (valid) {
        sv = s[j][e] * p.scale;
        if (p.bias_mode == 1)
          sv += kbias[e >> 1];
        else if (p.bias_mode == 2)
          sv += bias[((size_t)bb * p.seg + pos) * p.Lk + c];
      }
      const float pr = sv > 0.5f * MASK_VALUE
                           ? exp2_approx((sv - lb[rl]) * LOG2E)
                           : 0.f;
      float pd = pr, dpv = dp[j][e];
      if (p.rate > 0.f) {
        const bool kp = keep(base, (uint32_t)r, (uint32_t)c, p.thresh);
        pd = kp ? pr * p.inv_keep : 0.f;
        dpv = kp ? dpv * p.inv_keep : 0.f;
      }
      s[j][e] = pd;
      dp[j][e] = pr * (dpv - db[rl]) * p.scale;
    }
}

// Blocks walk work items (bh, key tile of BK keys, q split), item
// w = (bh * nk + kt) * nsp + split: a split walks one range of the q tiles
// (all of them for nsp = 1), and with nsp > 1 each writes f32 dK / dV
// partials that the key tile's last split to arrive sums in split order.
// BK / 16 warps, warp w owning keys 16w .. 16w + 15 of the tile (for heads
// over 128 wide twice as many, warp w and w + BK / 16 owning the same keys
// and half the dK and dV columns each).  K and V
// stay in shared memory and dK, dV in registers while the block walks the
// item's q tiles through a two-stage cp.async ring of Q, dO, lse and di.
// A q tile takes five tensor-core products: S^T = K Q^T and dP^T = V dO^T
// (each warp its keys), then on the fragments P, its dropped Pd and
// dS = P (dP - di) scale, then dV += Pd^T dO and dK += dS^T Q with Pd and
// dS straight from registers, then dS^T through shared memory and
// dQ = dS K split over the warps by q rows and head columns.  One key tile
// a head writes dQ; with more, each writes its f32 partial to `ws` and the
// last of the tile's visitors to arrive on the (bh, q tile) ticket sums
// them in key-tile order -- no float atomics, the same bits every call --
// and puts the ticket back to zero.  A block walks only the q tiles whose
// rows' bands reach its key tile (under the fold, one range a head
// segment), so a q tile's visitors are a range of key tiles, the same
// range its ticket counts and its sum runs over.
// With KVB = 2 (16-bit) a block is persistent: it takes items w, w + grid,
// ... and loads the next item's K, V and first q tile into the other
// buffers during the current item's last q tile, so one item's loads and
// stores overlap the other's products (one block an SM: 255 registers a
// thread).  KVB = 1 (f32, whose tiles fill shared memory) launches a block
// an item.  BAND (a window or the fold) is a template argument, so a call
// without them runs no code of theirs.
template <typename T, int DMAX, int BK, int KVB, bool BAND>
__global__ void __launch_bounds__(Bwd<T, DMAX, BK>::THREADS, 1)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const int* __restrict__ seed, const float* __restrict__ lse,
                 const float* __restrict__ di, const T* __restrict__ dout,
                 T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                 float* __restrict__ ws, unsigned int* __restrict__ tickets,
                 float* __restrict__ kvws, unsigned int* __restrict__ kvtickets,
                 Params p, int BH, int nk, int nsp, int vec) {
  using M = Mma<T>;
  using A = typename M::A;
  using B = typename M::B;
  using C = Bwd<T, DMAX, BK>;
  constexpr int BQ = BwdQ<DMAX>::v;
  constexpr int KW = C::KW, WARPS = C::WARPS, THREADS = C::THREADS;
  constexpr int LD = DMAX + M::PAD, LDS = BQ + M::PAD;
  // 8-wide n-tiles of a q tile's row, and of a warp's dK / dV columns
  constexpr int NQ = BQ / 8, DC = DMAX / C::CS, ND = DC / 8;
  // dQ: the warps in an RG x CG grid of 16 q rows x CW head columns,
  // accumulated CWC columns at a time
  constexpr int RG = BQ / 16, CG = WARPS / RG, CW = DMAX / CG;
  constexpr int CWC = CW < 64 ? CW : 64;
  extern __shared__ __align__(16) unsigned char bwd_smem_raw[];
  T* kvs = reinterpret_cast<T*>(bwd_smem_raw);  // [KVB][K, V][BK][LD]
  T* qs = kvs + KVB * 2 * BK * LD;                // [2][BQ][LD]
  T* dos = qs + 2 * BQ * LD;                      // [2][BQ][LD]
  T* dst = dos + 2 * BQ * LD;                     // [BK][LDS] dS^T
  float* lse_s = reinterpret_cast<float*>(dst + BK * LDS);  // [2][BQ]
  float* di_s = lse_s + 2 * BQ;                              // [2][BQ]
  int* pos_s = reinterpret_cast<int*>(di_s + 2 * BQ);        // [2][BQ]

  const int items = BH * nk * nsp, D = p.D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // this warp's 16 keys of the tile and its first dK / dV column
  const int kr0 = (warp % KW) * 16, cb = (warp / KW) * DC;
  const int nqt = (p.Lq + BQ - 1) / BQ;
  // item w is (bh, key tile, q split); split s walks q tiles
  // [s qper, (s + 1) qper)
  const int qper = (nqt + nsp - 1) / nsp;
  auto bh_of = [&](int w) { return w / (nk * nsp); };
  auto kt_of = [&](int w) { return w / nsp % nk; };
  auto q_end = [&](int w) { return min(nqt, (w % nsp + 1) * qper); };

  // the key tiles [first, last] that visit q tile qt: those its rows'
  // bands reach (first > last: none).  The walk below and the dQ merge
  // both read it, so a ticket's count is exactly its visitors
  auto visitors = [&](int qt) {
    const int2 span = key_span(p, pos_span<BAND>(p, qt * BQ, BQ));
    return span.x <= span.y ? make_int2(span.x / BK, span.y / BK)
                            : make_int2(1, 0);
  };
  // the first q tile in [qt, end) that key tile kt visits (end: none);
  // under the fold these are `rep` ranges, one a head segment
  auto next_q = [&](int kt, int qt, int end) {
    for (; qt < end; ++qt) {
      const int2 v = visitors(qt);
      if (v.x <= kt && kt <= v.y) break;
    }
    return qt;
  };
  auto q_first = [&](int w) {
    return next_q(kt_of(w), w % nsp * qper, q_end(w));
  };
  auto stage_kv = [&](int w, int kb) {
    const size_t hk = (size_t)bh_of(w) * p.Lk * D;
    T* kb_s = kvs + kb * 2 * BK * LD;
    stage_rows<T, DMAX, THREADS>(kb_s, LD, k + hk, kt_of(w) * BK, p.Lk, D,
                                 BK, vec);
    stage_rows<T, DMAX, THREADS>(kb_s + BK * LD, LD, v + hk, kt_of(w) * BK,
                                 p.Lk, D, BK, vec);
  };
  auto stage_q = [&](int w, int q0, int buf) {
    const size_t hq = (size_t)bh_of(w) * p.Lq;
    stage_rows<T, DMAX, THREADS>(qs + buf * BQ * LD, LD, q + hq * D, q0,
                                 p.Lq, D, BQ, vec);
    stage_rows<T, DMAX, THREADS>(dos + buf * BQ * LD, LD, dout + hq * D, q0,
                                 p.Lq, D, BQ, vec);
    if (tid < BQ) {  // THREADS >= 128 > BQ
      const bool live = q0 + tid < p.Lq;
      cp_async4(lse_s + buf * BQ + tid, lse + hq + (live ? q0 + tid : 0),
                live ? 4 : 0);
      cp_async4(di_s + buf * BQ + tid, di + hq + (live ? q0 + tid : 0),
                live ? 4 : 0);
      // the row's position; past Lq one that no key's band holds
      if (BAND)
        pos_s[buf * BQ + tid] = live ? pos_of(p, q0 + tid) : -NO_EDGE - 1;
    }
  };

  int it = 0;             // q tiles this block has walked: the ring's step
  bool issued = false;    // this item's loads were issued by the last one
  for (int w = blockIdx.x, j = 0; w < items; w += gridDim.x, ++j) {
    const int bh = bh_of(w), kt = kt_of(w), k0 = kt * BK, qend = q_end(w);
    const int qt_start = q_first(w);
    T* ks = kvs + (j % KVB) * 2 * BK * LD;
    T* vs = ks + BK * LD;
    if (!issued && qt_start < qend) {
      stage_kv(w, j % KVB);
      stage_q(w, qt_start * BQ, it & 1);
      cp_async_commit();
    }
    issued = false;
    const int key_lo = k0 + kr0 + g;  // this thread's keys: key_lo, +8
    const size_t hq = (size_t)bh * p.Lq, hk = (size_t)bh * p.Lk;
    const int bb = p.bias_per_head ? bh : bh / p.H;
    const uint32_t base =
        p.rate > 0.f ? drop_base((uint32_t)seed[0], (uint32_t)bh) : 0u;
    float kbias[2] = {0.f, 0.f};  // the compact padding bias of the keys
    if (p.bias_mode == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (key_lo + 8 * h < p.Lk)
          kbias[h] = bias[(size_t)bb * p.Lk + key_lo + 8 * h];
    }
    float dka[ND][4], dva[ND][4];
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

    for (int qt = qt_start; qt < qend; ++it) {
      const int q0 = qt * BQ, buf = it & 1;
      const int qt_next = next_q(kt, qt + 1, qend);
      cp_async_wait<0>();  // this tile has landed ...
      __syncthreads();     // ... for every thread, and the last one is done
      if (qt_next < qend) {
        stage_q(w, qt_next * BQ, buf ^ 1);
      } else if (KVB == 2) {  // the next item's K, V and first q tile
        const int wn = w + gridDim.x;
        if (wn < items && q_first(wn) < q_end(wn)) {
          const int qn = q_first(wn);
          stage_kv(wn, (j + 1) % KVB);
          stage_q(wn, qn * BQ, buf ^ 1);
          issued = true;
        }
      }
      cp_async_commit();
      const T* qb = qs + buf * BQ * LD;
      const T* dob = dos + buf * BQ * LD;
      const float* lb = lse_s + buf * BQ;
      const float* db = di_s + buf * BQ;

      // S^T = K Q^T and dP^T = V dO^T over this warp's 16 keys
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DMAX; kk += M::KS) {
        A ak, av;
        M::a_row(ak, ks, LD, kr0, kk, lane);
        M::a_row(av, vs, LD, kr0, kk, lane);
#pragma unroll
        for (int n = 0; n < BQ; n += 16) {
          B bq[2], bo[2];
          M::b_nrow(bq, qb, LD, n, kk, lane);
          M::b_nrow(bo, dob, LD, n, kk, lane);
          M::mma(s[n / 8], ak, bq[0]);
          M::mma(s[n / 8 + 1], ak, bq[1]);
          M::mma(dp[n / 8], av, bo[0]);
          M::mma(dp[n / 8 + 1], av, bo[1]);
        }
      }

      // on the fragments: s becomes Pd (p dropped), dp becomes dS
      bwd_probs<BAND>(s, dp, p, bias, kbias, bb, base, q0, key_lo, t, lb,
                      db, pos_s + buf * BQ);

      // dV += Pd^T dO and dK += dS^T Q, the A operands from registers
#pragma unroll
      for (int j = 0; j < BQ / M::KS; ++j) {
        A ap, as;
        M::a_acc(ap, s, j);
        M::a_acc(as, dp, j);
#pragma unroll
        for (int n = 0; n < DC; n += 16) {
          B bo[2], bq[2];
          M::b_krow_acc(bo, dob, LD, j * M::KS, cb + n, lane);
          M::b_krow_acc(bq, qb, LD, j * M::KS, cb + n, lane);
          M::mma(dva[n / 8], ap, bo[0]);
          M::mma(dva[n / 8 + 1], ap, bo[1]);
          M::mma(dka[n / 8], as, bq[0]);
          M::mma(dka[n / 8 + 1], as, bq[1]);
        }
      }

      // dS^T to shared memory in the input type (the rounding dK's A had),
      // by one warp of the keys' CS
      if (warp < KW) {
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          M::store2(dst + (kr0 + g) * LDS + 8 * j + 2 * t, dp[j][0],
                    dp[j][1]);
          M::store2(dst + (kr0 + g + 8) * LDS + 8 * j + 2 * t, dp[j][2],
                    dp[j][3]);
        }
      }
      __syncthreads();

      // dQ (BQ x DMAX) = dS K over the tile's keys: warp (rg, cg) owns rows
      // 16 rg.. and columns cg CW.., CWC of them at a time; key steps wholly
      // past Lk are skipped.  Fragment (i, e): q row 16 rg + g + 8 (e >> 1),
      // column c0 + 8 i + 2 t + (e & 1).  With one key tile the rows go
      // through this q tile's Q buffer (read by no one now; the next tile's
      // loads go there only after the loop's first barrier), then to dq
      const int rg = warp % RG, cg = warp / RG;
      float* part =
          nk == 1 ? nullptr : ws + ((size_t)kt * BH + bh) * p.Lq * D;
      T* stg = qs + buf * BQ * LD;
#pragma unroll
      for (int cc = 0; cc < CW; cc += CWC) {
        const int c0 = cg * CW + cc;
        float dqa[CWC / 8][4];
#pragma unroll
        for (int i = 0; i < CWC / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) dqa[i][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BK; kk += M::KS) {
          if (k0 + kk >= p.Lk) break;
          A a;
          M::a_trans(a, dst, LDS, 16 * rg, kk, lane);
#pragma unroll
          for (int n = 0; n < CWC; n += 16) {
            B b[2];
            M::b_krow(b, ks, LD, kk, c0 + n, lane);
            M::mma(dqa[n / 8], a, b[0]);
            M::mma(dqa[n / 8 + 1], a, b[1]);
          }
        }
        if (part) {  // f32 partials, two columns a store
#pragma unroll
          for (int i = 0; i < CWC / 8; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = q0 + 16 * rg + g + 8 * h;
              const int d = c0 + 8 * i + 2 * t;
              if (r >= p.Lq || d >= D) continue;
              float* w = part + (size_t)r * D + d;
              if (d + 1 < D && !(D & 1)) {
                *reinterpret_cast<float2*>(w) =
                    make_float2(dqa[i][2 * h], dqa[i][2 * h + 1]);
              } else {
                w[0] = dqa[i][2 * h];
                if (d + 1 < D) w[1] = dqa[i][2 * h + 1];
              }
            }
        } else {
#pragma unroll
          for (int i = 0; i < CWC / 8; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              M::store2(stg + (16 * rg + g + 8 * h) * LD + c0 + 8 * i + 2 * t,
                        dqa[i][2 * h], dqa[i][2 * h + 1]);
        }
      }
      if (!part) {
        __syncthreads();
        unstage_rows<T, DMAX, THREADS>(dq + hq * D, stg, LD, q0, p.Lq, D, BQ,
                                       vec);
      } else {
        // the key tiles that visit this q tile, in order: vis.x .. vis.y
        const int2 vis = visitors(qt);
        unsigned int* ticket = tickets + (size_t)bh * nqt + qt;
        if (arrive_last(ticket, vis.y - vis.x + 1)) {
          const int n = min(BQ, p.Lq - q0) * D;
          const size_t off = (size_t)q0 * D;
          for (int i = tid; i < n; i += THREADS) {
            float sum = 0.f;
            for (int u = vis.x; u <= vis.y; ++u)  // key-tile order
              sum += __ldcg(ws + ((size_t)u * BH + bh) * p.Lq * D + off + i);
            dq[hq * D + off + i] = from_f<T>(sum);
          }
          if (tid == 0) *ticket = 0u;
        }
      }
      qt = qt_next;
    }
    __syncthreads();  // every warp is done with this item's K and V

    // fragment (i, e) of dK and dV is key kr0 + g + 8 (e >> 1) of the
    // tile, column cb + 8 i + 2 t + (e & 1); keys no q row saw (causal, a
    // window) get zeros
    if (nsp == 1) {
      // through the item's K and V tiles, then whole rows
#pragma unroll
      for (int i = 0; i < ND; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off = (kr0 + g + 8 * h) * LD + cb + 8 * i + 2 * t;
          M::store2(ks + off, dka[i][2 * h], dka[i][2 * h + 1]);
          M::store2(vs + off, dva[i][2 * h], dva[i][2 * h + 1]);
        }
      __syncthreads();
      unstage_rows<T, DMAX, THREADS>(dk + hk * D, ks, LD, k0, p.Lk, D, BK,
                                     vec);
      unstage_rows<T, DMAX, THREADS>(dv + hk * D, vs, LD, k0, p.Lk, D, BK,
                                     vec);
    } else {
      // this split's f32 partials ([BK][D] of dK, then of dV); the last
      // of the key tile's nsp splits to arrive sums them in split order
      // -- no float atomics, the same bits every call -- and puts the
      // ticket back to zero
      const size_t pitch = (size_t)2 * BK * D;
      float* const tile_ws = kvws + (size_t)(bh * nk + kt) * nsp * pitch;
      float* const pk = tile_ws + (w % nsp) * pitch;
#pragma unroll
      for (int i = 0; i < ND; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = kr0 + g + 8 * h, d = cb + 8 * i + 2 * t;
          if (k0 + r >= p.Lk || d >= D) continue;
          float* wk = pk + (size_t)r * D + d;
          float* wv = wk + BK * D;
          if (d + 1 < D && !(D & 1)) {
            *reinterpret_cast<float2*>(wk) =
                make_float2(dka[i][2 * h], dka[i][2 * h + 1]);
            *reinterpret_cast<float2*>(wv) =
                make_float2(dva[i][2 * h], dva[i][2 * h + 1]);
          } else {
            wk[0] = dka[i][2 * h];
            wv[0] = dva[i][2 * h];
            if (d + 1 < D) {
              wk[1] = dka[i][2 * h + 1];
              wv[1] = dva[i][2 * h + 1];
            }
          }
        }
      unsigned int* ticket = kvtickets + (size_t)bh * nk + kt;
      if (arrive_last(ticket, nsp)) {
        const int n = min(BK, p.Lk - k0) * D;
        const size_t off = (hk + k0) * D;
        for (int i = tid; i < n; i += THREADS) {
          float sk = 0.f, sv = 0.f;
          for (int u = 0; u < nsp; ++u) {  // split order
            sk += __ldcg(tile_ws + u * pitch + i);
            sv += __ldcg(tile_ws + u * pitch + BK * D + i);
          }
          dk[off + i] = from_f<T>(sk);
          dv[off + i] = from_f<T>(sv);
        }
        if (tid == 0) *ticket = 0u;
      }
    }
  }
  cp_async_wait<0>();
}

// causal keeps keys up to the row's position; a window of w keys
// [q - w, q], or [q - w, q + w] when symmetric and not causal (JAX's
// `_band_mask`); window < 0: none
Params make_params(int H, int Lq, int Lk, int D, float scale, int causal,
                   int window, int window_symmetric, int seg, int bias_mode,
                   int bias_per_head, float rate, float inv_keep,
                   unsigned thresh) {
  Params p;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  p.scale = scale;
  p.seg = seg;
  p.seg_m = seg == 1 ? 0xFFFFFFFFu
                     : (uint32_t)(((1ull << 32) + seg - 1) / (unsigned)seg);
  const int w = window >= 0 && window < NO_EDGE ? window : NO_EDGE;
  p.lo_w = w;
  p.hi_w = causal || (window >= 0 && !window_symmetric) ? 0 : w;
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

struct FwdArgs {
  const void *q, *k, *v, *bias, *seed;
  void *out, *lse;
  int BH, grid, vec;
};

// the card's SM count, read once per device
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev] > 0 ? counts[dev] : 132;
}

// grid <= 0: one block for each that fits on the card at once (the
// kernel's occupancy times the SMs), at most one an item
template <typename T, int DMAX, int BQ, int BK>
cudaError_t launch_fwd(const FwdArgs& a, const Params& p,
                       cudaStream_t stream) {
  using F = Fwd<T, DMAX, BQ, BK>;
  if constexpr (!F::FITS) {
    return cudaErrorInvalidValue;  // the tiles exceed a block's shared memory
  } else {
    static bool attr = false;
    static int per_sm = 0;
    cudaError_t e = allow_smem(flash_fwd_kernel<T, DMAX, BQ, BK>, F::SMEM,
                               attr);
    if (e != cudaSuccess) return e;
    if (per_sm == 0) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, flash_fwd_kernel<T, DMAX, BQ, BK>, F::THREADS, F::SMEM);
      if (e != cudaSuccess) return e;
      per_sm = per_sm > 0 ? per_sm : 1;
    }
    const int nqt = (p.Lq + BQ - 1) / BQ;
    const long items = (long)a.BH * nqt;
    if (items > 0x7fffffff) return cudaErrorInvalidValue;
    long grid = a.grid > 0 ? a.grid : (long)per_sm * sm_count();
    grid = grid < items ? grid : items;
    flash_fwd_kernel<T, DMAX, BQ, BK>
        <<<(unsigned)grid, F::THREADS, F::SMEM, stream>>>(
            static_cast<const T*>(a.q), static_cast<const T*>(a.k),
            static_cast<const T*>(a.v), static_cast<const float*>(a.bias),
            static_cast<const int*>(a.seed), static_cast<T*>(a.out),
            static_cast<float*>(a.lse), p, nqt, (int)items, a.vec);
    return cudaGetLastError();
  }
}

// heads over 64 wide take 64-row items; over 128 wide, the one pair of
// tiles that fits a block's shared memory: 64 x 64 in 16 bits, 32 x 32
// in f32 (`_fwd_plan`)
template <typename T, int DMAX>
cudaError_t launch_fwd_q(const FwdArgs& a, const Params& p, int bq, int bk,
                         cudaStream_t s) {
  if constexpr (DMAX > 128) {
    if constexpr (sizeof(T) == 2)
      return bq == 64 && bk == 64 ? launch_fwd<T, DMAX, 64, 64>(a, p, s)
                                  : cudaErrorInvalidValue;
    else
      return bq == 32 && bk == 32 ? launch_fwd<T, DMAX, 32, 32>(a, p, s)
                                  : cudaErrorInvalidValue;
  } else {
    if (bq == 32 || bk == 32) return cudaErrorInvalidValue;
    if (bq == 64)
      return bk == 64 ? launch_fwd<T, DMAX, 64, 64>(a, p, s)
                      : launch_fwd<T, DMAX, 64, 128>(a, p, s);
    if constexpr (DMAX > 64) {
      return cudaErrorInvalidValue;
    } else {
      return bk == 64 ? launch_fwd<T, DMAX, 128, 64>(a, p, s)
                      : launch_fwd<T, DMAX, 128, 128>(a, p, s);
    }
  }
}

template <typename T>
cudaError_t launch_fwd_d(const FwdArgs& a, const Params& p, int bq, int bk,
                         cudaStream_t s) {
  return p.D <= 64    ? launch_fwd_q<T, 64>(a, p, bq, bk, s)
         : p.D <= 128 ? launch_fwd_q<T, 128>(a, p, bq, bk, s)
                      : launch_fwd_q<T, 256>(a, p, bq, bk, s);
}

struct BwdArgs {
  const void *q, *k, *v, *bias, *seed, *o, *lse, *dout;
  void *di, *dq, *dk, *dv, *ws, *tickets, *kvws, *kvtickets;
  int BH, nk, nsp, grid, vec;
};

// the di row pass, then the key-tile kernel, on one stream (in order);
// 16-bit types keep two K/V buffers (persistent blocks), f32 one
template <typename T, int DMAX, int BK, bool BAND>
cudaError_t launch_bwd(const BwdArgs& a, const Params& p,
                       cudaStream_t stream) {
  using C = Bwd<T, DMAX, BK>;
  constexpr int KVB = C::KVB;
  constexpr size_t smem = bwd_smem<T, DMAX, BK, KVB>();
  static_assert(smem <= SMEM_BLOCK, "the tiles fit a block");
  static bool attr = false;
  cudaError_t e =
      allow_smem(flash_bwd_kernel<T, DMAX, BK, KVB, BAND>, smem, attr);
  if (e != cudaSuccess) return e;
  const int rows = a.BH * p.Lq;
  const int rows_a_block = a.vec ? 32 : 8;
  flash_bwd_di_kernel<T><<<(rows + rows_a_block - 1) / rows_a_block, 256, 0,
                           stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<float*>(a.di), rows, p.D, a.vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_kernel<T, DMAX, BK, KVB, BAND>
      <<<a.grid, C::THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.bias),
      static_cast<const int*>(a.seed), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.di), static_cast<const T*>(a.dout),
      static_cast<T*>(a.dq), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<float*>(a.ws), static_cast<unsigned int*>(a.tickets),
      static_cast<float*>(a.kvws), static_cast<unsigned int*>(a.kvtickets),
      p, a.BH, a.nk, a.nsp, a.vec);
  return cudaGetLastError();
}

template <typename T, bool BAND>
cudaError_t launch_bwd_b(const BwdArgs& a, const Params& p, int bk,
                         cudaStream_t s) {
  if (bk == 32 && p.D <= 128) return cudaErrorInvalidValue;
  if (p.D <= 64)
    return bk == 64 ? launch_bwd<T, 64, 64, BAND>(a, p, s)
                    : launch_bwd<T, 64, 128, BAND>(a, p, s);
  if (p.D <= 128)
    return bk == 64 ? launch_bwd<T, 128, 64, BAND>(a, p, s)
                    : launch_bwd<T, 128, 128, BAND>(a, p, s);
  // over 128 wide, the key tile that fits a block's shared memory: 64 keys
  // in 16 bits, 32 in f32
  if constexpr (sizeof(T) == 2)
    return bk == 64 ? launch_bwd<T, 256, 64, BAND>(a, p, s)
                    : cudaErrorInvalidValue;
  else
    return bk == 32 ? launch_bwd<T, 256, 32, BAND>(a, p, s)
                    : cudaErrorInvalidValue;
}

// a window or the fold: the band's instantiation
template <typename T>
cudaError_t launch_bwd_d(const BwdArgs& a, const Params& p, int bk,
                         cudaStream_t s) {
  return p.seg != p.Lq || p.lo_w < NO_EDGE
             ? launch_bwd_b<T, true>(a, p, bk, s)
             : launch_bwd_b<T, false>(a, p, bk, s);
}

}  // namespace

// q (BH, Lq, D), k/v (BH, Lk, D), out (BH, Lq, D) in one type, `dtype`
// (0 f32, 1 bf16, 2 f16); lse (BH, Lq) f32; bias f32 (Bb, 1|seg, Lk) or null
// (bias_mode 0); seed a device int32 (read only when rate > 0).  Row r sits
// at position r % seg (seg divides Lq: the unfolded length under grouped
// K/V, else Lq); window >= 0 keeps the band `make_params` describes.  All
// contiguous; the caller checks shapes (D <= 256).  bq (32, 64 or 128) is
// the query rows a work item, bk (32, 64 or 128) the keys a stage of the
// K/V ring (heads over 64 wide take bq = 64, f32 ones also bk = 64; over
// 128 wide bf16 and f16 take 64 x 64, f32 32 x 32); `grid`
// persistent blocks walk the B * H * ceil(Lq / bq) items (<= 0: as many
// as fit on the card at once).  Launches on `stream`;
// returns the launch's cudaError_t (0 = launched).
extern "C" int mxt_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* seed, void* out, void* lse, int BH, int H, int Lq, int Lk,
    int D, float scale, int causal, int window, int window_symmetric,
    int seg, int bias_mode, int bias_per_head, float rate, float inv_keep,
    unsigned thresh, int dtype, int bq, int bk, int grid, void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (D > MAX_D || D < 1 || (bq != 32 && bq != 64 && bq != 128) ||
      (bk != 32 && bk != 64 && bk != 128) || seg < 1 || Lq % seg ||
      Lq >= NO_EDGE || dtype < 0 || dtype > 2 ||
      !((MXT_FLASH_TYPES >> dtype) & 1))
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Lq == 0) return 0;
  const Params p =
      make_params(H, Lq, Lk, D, scale, causal, window, window_symmetric, seg,
                  bias_mode, bias_per_head, rate, inv_keep, thresh);
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.seed = seed;
  a.out = out;
  a.lse = lse;
  a.BH = BH;
  a.grid = grid;
  // 16-byte loads and stores need rows of whole 16-byte chunks on aligned
  // pointers
  a.vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) &&
          (D * (dtype ? 2 : 4)) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
#if MXT_FLASH_TYPES & 1
    case 0:
      return (int)launch_fwd_d<float>(a, p, bq, bk, s);
#endif
#if MXT_FLASH_TYPES & 2
    case 1:
      return (int)launch_fwd_d<__nv_bfloat16>(a, p, bq, bk, s);
#endif
#if MXT_FLASH_TYPES & 4
    case 2:
      return (int)launch_fwd_d<__half>(a, p, bq, bk, s);
#endif
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The backward of the call above: dout, o in the input type, lse from the
// forward; di (BH, Lq) f32 is scratch; dq/dk/dv like q/k/v (rows of dq
// that no key tile visits -- positions past Lk - 1 + window -- are left
// as they were: the caller zeroes dq where a window leaves such rows).
// bk is the key tile (64 or 128; over 128 wide 64 in bf16 and f16, 32 in
// f32), so nk = ceil(Lk / bk) key tiles a head; each key tile's q tiles are cut
// into nsp splits of ceil(q tiles / nsp) (the host keeps a split's rows
// few enough that the tensor cores' f32 accumulation of dK and dV stays
// within 1e-4), so BH * nk * nsp work items, walked by `grid` blocks
// (16-bit: persistent blocks, any grid; f32: grid = BH * nk * nsp).  With
// nk > 1, ws holds nk * BH * Lq * D f32 dQ partials and tickets one zeroed
// uint32 per (bh, q tile) -- q tiles of 64 rows for D <= 64, else 32; with
// nsp > 1, kvws holds BH * nk * nsp * 2 * bk * D f32 dK / dV partials and
// kvtickets one zeroed uint32 per (bh, key tile); all tickets are left
// zeroed.  Launches the di row pass, then the key-tile kernel, on
// `stream`.  Returns the launches' cudaError_t.
extern "C" int mxt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* seed, const void* o, const void* lse, const void* dout,
    void* di, void* dq, void* dk, void* dv, void* ws, void* tickets,
    void* kvws, void* kvtickets, int nsp, int BH,
    int H, int Lq, int Lk, int D, float scale, int causal, int window,
    int window_symmetric, int seg, int bias_mode, int bias_per_head,
    float rate, float inv_keep, unsigned thresh, int dtype, int bk,
    int grid, void* stream) {
  cudaGetLastError();
  if (D > MAX_D || D < 1 || (bk != 32 && bk != 64 && bk != 128) ||
      grid < 1 || seg < 1 || Lq % seg || Lq >= NO_EDGE || dtype < 0 ||
      dtype > 2 || !((MXT_FLASH_TYPES >> dtype) & 1))
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Lq == 0 || Lk == 0) return 0;
  const int nk = (Lk + bk - 1) / bk;
  if (nsp < 1 || (nk > 1 && (ws == nullptr || tickets == nullptr)) ||
      (nsp > 1 && (kvws == nullptr || kvtickets == nullptr)) ||
      (long)BH * nk * nsp > 0x7fffffff ||
      (dtype == 0 && grid != BH * nk * nsp))
    return (int)cudaErrorInvalidValue;
  const Params p =
      make_params(H, Lq, Lk, D, scale, causal, window, window_symmetric, seg,
                  bias_mode, bias_per_head, rate, inv_keep, thresh);
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.seed = seed;
  a.o = o;
  a.lse = lse;
  a.dout = dout;
  a.di = di;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.ws = ws;
  a.tickets = tickets;
  a.kvws = kvws;
  a.kvtickets = kvtickets;
  a.nsp = nsp;
  a.BH = BH;
  a.nk = nk;
  a.grid = grid;
  // 16-byte loads and stores need rows of whole 16-byte chunks on aligned
  // pointers
  a.vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) &&
          aligned16(dout) && aligned16(dq) && aligned16(dk) &&
          aligned16(dv) && (D * (dtype ? 2 : 4)) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
#if MXT_FLASH_TYPES & 1
    case 0:
      return (int)launch_bwd_d<float>(a, p, bk, s);
#endif
#if MXT_FLASH_TYPES & 2
    case 1:
      return (int)launch_bwd_d<__nv_bfloat16>(a, p, bk, s);
#endif
#if MXT_FLASH_TYPES & 4
    case 2:
      return (int)launch_bwd_d<__half>(a, p, bk, s);
#endif
    default:
      return (int)cudaErrorInvalidValue;
  }
}
