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
//     window is given); a dropped key's p is exactly 0.
//   * Online softmax per row in f32; p is rounded to the query's type before
//     the P.V product (the pool's type, as the TPU kernel casts p to v's
//     dtype, except for f32 queries over a bf16 pool below); a row that
//     saw no key has l == 0 and writes zeros, not NaN.
//   * Keys at t >= ctx are never read.
//   * Queries, output and the arithmetic take the query's type; the pool may
//     be bf16 or f16 under f32 queries (a bf16 or f16 model's serving step,
//     whose activations are f32 after the first LayerNorm's f32 gain): K/V
//     rows load as 16-bit values and widen to f32 in registers, and
//     everything else is the f32 route's, as the plain version casts the
//     gathered pool to f32.  f16 queries over an f16 pool (JAX's kernel on
//     f16 inputs) take the bf16 route's code with f16 tiles and products.
//   * The int8 variant (an int8 pool, `ServeConfig(kv_dtype="int8")`, under
//     f32 or bf16 queries): each stored vector t of kv head g is k_t =
//     sk_t * kq_t (and v_t = sv_t * vq_t), int8 rows with one f32 scale a
//     row in scale planes (num_pages, ps, Hkv).  The scales factor out of
//     both products: s_t = (q . kq_t) * sk_t * scale, and
//     out = sum_t (p_t sv_t) vq_t / sum_t p_t.  So the rows stay int8 from
//     HBM to the products (D bytes a row, not 4D) and no dequantized row is
//     written anywhere; int8 values are exact in bf16 and in TF32, so the
//     products are the float variants' with an int8 tile widened as its
//     fragments load.  The TPU kernel refuses such pools (the JAX package
//     dequantizes the gathered context in its reference instead).
//
// What bounds it on the H100: the K/V bytes of the keys below ctx, read
// from HBM at 3.35 TB/s (int8: D + 4 bytes a row with its scale, against
// 4D in f32); at serving shapes that is a few MB a call, so
// what the kernel has to beat is latency: enough blocks, and enough bytes
// in flight in each, to cover the trip to HBM.
//
// Design (flash-decoding).  The grid is (slot * kv head) x (row tile) x
// (key split): each split covers `span` keys, a whole number of pages, that
// the host's plan (`_plan` in ops/paged_attention.py) sizes from the table's
// capacity so that the grid fills the card.  A split wholly at or above ctx,
// or below the window's floor, exits at once.  Inside a block each warp
// walks its own 16-key tiles (tile i goes to warp i % warps) through a ring
// of two stages in shared memory, filled by cp.async copies of whole K and
// V rows (16-byte pieces, or 8, 4, 2 or 1 where a row's bytes are not a
// multiple of 16: bf16 D = 100, f32 D = 18, int8 D = 72 or 25), each row
// zero-filled past D to a multiple of 16 columns, an int8 row's two scales
// copied beside it, with one page-table read per key row; the
// next tile's copies
// fly while this one computes, and warps never wait on each other until the
// block merges their (m, l, acc) states in warp order.  Two compute variants:
//   * few rows (rep * C < 16: decode): q is staged once in f32; two lanes
//     score a key, each over half of D, then the warp's online softmax; in
//     P.V each lane owns D / 32 columns.  Every live row is a real row.
//   * tile (rows >= 16: prefill chunks, GQA folds): 16 rows a block, S = Q
//     K^T and O += P V as mma.sync products -- bf16 m16n8k16, and for f32
//     3xTF32 m16n8k8 (hi/lo halves of both operands, about 2^-20 relative
//     error a product) -- with P fed from the score fragments in registers.
// A (slot, head) whose keys lie in one split writes `out` from that block.
// With more, each live split writes its f32 partial (m, l, acc per row) to
// `ws`, and the last block to arrive on the (slot * kv head, row tile)
// ticket merges them in split order and puts the ticket back to zero: no
// float atomics, the same bits every call.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"   // cp.async, ldmatrix, mma.sync, Mma, arrive_last

// The `types` this library instantiates, a bit per code (below, at the
// entry).  The build (mxnet_tpu_torch/kernels `SPLITS`) compiles this
// source twice in parallel with -DMXT_RPA_TYPES: the f32-query types and
// the 16-bit-query types; an entry given a type its library lacks returns
// cudaErrorInvalidValue.
#ifndef MXT_RPA_TYPES
#define MXT_RPA_TYPES 127
#endif

namespace {

constexpr int TK = 16;           // keys a warp takes a step of its walk
constexpr int TILE_ROWS = 16;    // rows of the tile variant (one mma M)
constexpr int MAX_WARPS = 4;
constexpr int MAX_D = 256;
constexpr int MAX_SPLITS = 128;  // splits' weights fit the merge area
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);  // nearest even; +-inf past the range
}

// 16 bytes of a row in shared memory as floats
__device__ __forceinline__ void load16(float (&f)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load16(float (&f)[8],
                                       const __nv_bfloat16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void load16(float (&f)[8], const __half* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __half22float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void load16(float (&f)[16], const int8_t* p) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = static_cast<float>(static_cast<int8_t>(w[i >> 2] >> (8 * (i & 3))));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

struct Params {
  const float* ksc;       // int8 pools: (num_pages, ps, Hkv) f32 scales
  const float* vsc;
  const int* pt;          // (B, maxp) page tables
  const int* ctx;         // (B,) context lengths
  const int* start;       // (B,) first chunk position
  float* ws;              // f32 partials: per row acc[D], m, l, 2 pad
  unsigned int* tickets;  // one per (slot * kv head, row tile), zeroed
  int Hkv, C, D, ps, maxp, rows, window;
  int kpiece, qpiece;     // bytes a copy of a pool row / a query row
  float scale;
  int row_tile, row_tiles, span, nsplit;
};

// Shared-memory layout of one instantiation: q, then each warp's ring of
// two stages of K and V rows ([warp][stage][K, V][TK][LD]), followed for an
// int8 pool by the rows' scales ([stage][K, V][TK] f32); the block's merge
// area ([warp][RT][DMAX] acc, then [warp][RT][m, l]) reuses the rings.
// Rows are padded so that neither variant's reads conflict on banks: 32
// bytes where two lanes read a key's halves, 16 where ldmatrix reads rows.
// TQ is the query's type, TP the pool's.
template <typename TQ, typename TP, int DMAX, int RB> struct Cfg {
  static constexpr bool TILE = RB == TILE_ROWS;
  static constexpr bool Q8 = sizeof(TP) == 1;
  static constexpr int LD = DMAX + (TILE ? 16 : 32) / (int)sizeof(TP);
  static constexpr int LDQ = TILE ? DMAX + 16 / (int)sizeof(TQ) : DMAX;
  static constexpr size_t QBYTES =
      TILE ? (size_t)TILE_ROWS * LDQ * sizeof(TQ) : (size_t)RB * DMAX * 4;
  static constexpr size_t KV = (size_t)2 * 2 * TK * LD * sizeof(TP);
  static constexpr size_t RING = KV + (Q8 ? (size_t)2 * 2 * TK * 4 : 0);
  static size_t smem(int warps) {
    const size_t ring = warps * RING;
    const size_t merge = (size_t)warps * RB * (DMAX + 2) * 4;
    return QBYTES + (ring > merge ? ring : merge);
  }
};

// The first `bytes` bytes of a row at src into dst, then zeros up to
// `padded` bytes (D rounded up to 16 elements), in pieces of `piece` bytes
// -- 16, 8 or 4 by cp.async, 2 (a bf16 row of odd D) or 1 (an int8 row of
// odd D) by plain copies --
// pieces i0, i0 + step, ...; the row's bytes are a multiple of the piece,
// so a piece is wholly in the row or wholly past it.  bytes 0: all zeros,
// src not read.
__device__ __forceinline__ void copy_row(void* dst, const void* src,
                                         int bytes, int padded, int piece,
                                         int i0, int step) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  for (int off = i0 * piece; off < padded; off += step * piece) {
    const bool live = off < bytes;
    const char* from = live ? s + off : s;
    switch (piece) {
      case 16: cp_async16(d + off, from, live ? 16 : 0); break;
      case 8: cp_async8(d + off, from, live ? 8 : 0); break;
      case 4: cp_async4(d + off, from, live ? 4 : 0); break;
      case 2:
        *reinterpret_cast<uint16_t*>(d + off) =
            live ? *reinterpret_cast<const uint16_t*>(from) : uint16_t(0);
        break;
      default: d[off] = live ? *from : 0;
    }
  }
}

// This lane's key t (row j = lane / 2 of a tile) of kv head g, in page
// `page`, into one stage: two lanes a key row, zero past D to a multiple
// of 16 columns; for an int8 pool the even lane also copies the row's K
// scale and the odd lane its V scale into `scl` ([K, V][TK]).  A key that
// is not live is zero-filled and not read.
template <typename T, int LD>
__device__ __forceinline__ void load_tile(T* ks, T* vs, float* scl,
                                          const T* __restrict__ kp,
                                          const T* __restrict__ vp,
                                          const Params& p, int g, int t,
                                          int page, bool live, int lane) {
  const int j = lane >> 1;
  const size_t vec = live ? ((size_t)page * p.ps + t % p.ps) * p.Hkv + g : 0;
  const size_t row = vec * p.D;
  const int bytes = live ? p.D * (int)sizeof(T) : 0;
  const int padded = ((p.D + 15) & ~15) * (int)sizeof(T);
  copy_row(ks + j * LD, kp + row, bytes, padded, p.kpiece, lane & 1, 2);
  copy_row(vs + j * LD, vp + row, bytes, padded, p.kpiece, lane & 1, 2);
  if constexpr (sizeof(T) == 1)
    cp_async4(scl + (lane & 1) * TK + j, ((lane & 1) ? p.vsc : p.ksc) + vec,
              live ? 4 : 0);
}

__device__ __forceinline__ bool keep(int t, int ke, int qpos, int window) {
  return t < ke && t <= qpos && (window < 0 || t >= qpos - window);
}

// One 16-key tile of the few-rows variant: lanes 2j and 2j + 1 score key j
// over alternate 16-byte chunks of D for each row, the warp's online
// softmax, then P.V with lane owning columns lane + 32 k.
template <typename TQ, typename TP, int DMAX, int RB>
__device__ __forceinline__ void few_step(
    const float* qf, const TP* ks, const TP* vs, const float* scl,
    const Params& p, int R, int t0, int ke, const int (&qpos)[RB],
    float (&m)[RB], float (&l)[RB], float (&acc)[RB][DMAX / 32], int lane) {
  using C = Cfg<TQ, TP, DMAX, RB>;
  constexpr int EPC = 16 / sizeof(TP);
  const int j = lane >> 1, t = t0 + j;
  const TP* kr = ks + j * C::LD;
  float s[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) s[r] = 0.f;
  for (int c = lane & 1; c * EPC < p.D; c += 2) {
    float kf[EPC];
    load16(kf, kr + c * EPC);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < R) {
        const float* qr = qf + r * DMAX + c * EPC;
#pragma unroll
        for (int e = 0; e < EPC; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + e);
          s[r] = fmaf(qv.x, kf[e], s[r]);
          s[r] = fmaf(qv.y, kf[e + 1], s[r]);
          s[r] = fmaf(qv.z, kf[e + 2], s[r]);
          s[r] = fmaf(qv.w, kf[e + 3], s[r]);
        }
      }
    }
  }
  float pr[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    pr[r] = 0.f;
    if (r >= R) continue;
    float sv = s[r] + __shfl_xor_sync(FULL, s[r], 1);
    const bool ok = keep(t, ke, qpos[r], p.window);
    if constexpr (C::Q8) sv *= scl[j];  // the key's scale
    sv = ok ? sv * p.scale : -INFINITY;
    float mx = sv;
#pragma unroll
    for (int o = 16; o >= 2; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    const float mn = fmaxf(m[r], mx);
    if (mn == -INFINITY) continue;  // warp-uniform: no key of row r yet
    const float alpha = expf(m[r] - mn);
    const float pe = ok ? expf(sv - mn) : 0.f;
    float sum = pe;  // each key once: the lanes of a pair hold the same p
#pragma unroll
    for (int o = 16; o >= 2; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    l[r] = l[r] * alpha + sum;
    m[r] = mn;
    pr[r] = to_f(from_f<TQ>(pe));
    if constexpr (C::Q8) pr[r] *= scl[TK + j];  // the value's scale
#pragma unroll
    for (int k = 0; k < DMAX / 32; ++k) acc[r][k] *= alpha;
  }
#pragma unroll 4
  for (int jj = 0; jj < TK; ++jj) {
    float vv[DMAX / 32];
    const TP* vr = vs + jj * C::LD;
#pragma unroll
    for (int k = 0; k < DMAX / 32; ++k) {
      const int d = lane + 32 * k;
      vv[k] = d < p.D ? to_f(vr[d]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < R) {
        const float pj = __shfl_sync(FULL, pr[r], 2 * jj);
#pragma unroll
        for (int k = 0; k < DMAX / 32; ++k)
          acc[r][k] = fmaf(pj, vv[k], acc[r][k]);
      }
    }
  }
}

// One 16-key tile of the tile variant for the block's 16 rows: S = Q K^T
// on the tensor cores, the online softmax on the fragments (lane holds rows
// g and g + 8), then O += P V with P from the score fragments (times each
// key's V scale for an int8 pool, after the row sums took P alone).
template <typename TQ, typename TP, int DMAX>
__device__ __forceinline__ void tile_step(const TQ* qt, const TP* ks,
                                          const TP* vs, const float* scl,
                                          const Params& p,
                                          int R, int t0, int ke,
                                          const int (&qpos)[2], float (&m)[2],
                                          float (&l)[2],
                                          float (&acc)[DMAX / 8][4],
                                          int lane) {
  using M = Mma<TQ>;
  using C = Cfg<TQ, TP, DMAX, TILE_ROWS>;
  const int g = lane >> 2, t4 = lane & 3;
  float sc[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DMAX / M::KS; ++kk) {
    if (kk * M::KS < p.D) {
      typename M::A a;
      typename M::B b[2];
      M::a_row(a, qt, C::LDQ, 0, kk * M::KS, lane);
      M::b_nrow(b, ks, C::LD, 0, kk * M::KS, lane);
      M::mma(sc[0], a, b[0]);
      M::mma(sc[1], a, b[1]);
    }
  }
  // element e of n-tile n: row g + 8 (e >> 1), key 8 n + 2 t4 + (e & 1)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, j = 8 * n + 2 * t4 + (e & 1), t = t0 + j;
      const bool ok = g + 8 * h < R && keep(t, ke, qpos[h], p.window);
      if constexpr (C::Q8) sc[n][e] *= scl[j];  // the key's scale
      sc[n][e] = ok ? sc[n][e] * p.scale : -INFINITY;
      mx[h] = fmaxf(mx[h], sc[n][e]);
    }
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
    const float mn = fmaxf(m[h], mx[h]);
    alpha[h] = mn == -INFINITY ? 1.f : expf(m[h] - mn);
    m[h] = mn;
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float pe =
          sc[n][e] == -INFINITY ? 0.f : expf(sc[n][e] - m[h]);
      rs[h] += pe;
      sc[n][e] = pe;
      if constexpr (C::Q8) sc[n][e] *= scl[TK + 8 * n + 2 * t4 + (e & 1)];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[h] += __shfl_xor_sync(FULL, rs[h], 1);
    rs[h] += __shfl_xor_sync(FULL, rs[h], 2);
    l[h] = l[h] * alpha[h] + rs[h];
  }
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
  // P (rounded to bf16 by a_acc for bf16 queries) times V, TK / KS key
  // steps; a bf16 V under f32 queries widens as it loads
#pragma unroll
  for (int j = 0; j < TK / M::KS; ++j) {
    typename M::A a;
    M::a_acc(a, sc, j);
#pragma unroll
    for (int n = 0; n < DMAX / 16; ++n) {
      if (16 * n < p.D) {
        typename M::B b[2];
        M::b_krow_acc(b, vs, C::LD, j * M::KS, 16 * n, lane);
        M::mma(acc[2 * n], a, b[0]);
        M::mma(acc[2 * n + 1], a, b[1]);
      }
    }
  }
}

template <typename TQ, typename TP, int DMAX, int RB>
__global__ void __launch_bounds__(32 * MAX_WARPS)
rpa_split_kernel(const TQ* __restrict__ q, const TP* __restrict__ kp,
                 const TP* __restrict__ vp, TQ* __restrict__ out, Params p) {
  using C = Cfg<TQ, TP, DMAX, RB>;
  constexpr bool TILE = C::TILE;
  extern __shared__ __align__(16) unsigned char rpa_smem[];
  const int nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bg = blockIdx.x, rt = blockIdx.y, split = blockIdx.z;
  const int b = bg / p.Hkv, g = bg - b * p.Hkv;
  const int r0 = rt * p.row_tile;
  const int R = min(p.row_tile, p.rows - r0);
  const int D = p.D;
  const int* ptab = p.pt + (size_t)b * p.maxp;
  // this lane's first key if the split starts at its first key, and its
  // page id, read beside ctx and start so the first copies wait on one trip
  const int t_spec = split * p.span + warp * TK + (lane >> 1);
  const int pg_spec = t_spec < p.maxp * p.ps ? ptab[t_spec / p.ps] : 0;
  const int start = p.start[b];
  // the keys any row of this slot keeps: [lo, kend)
  const int kend = min(min(p.ctx[b], p.maxp * p.ps), start + p.C);
  const int lo = p.window >= 0 ? max(0, start - p.window) : 0;
  const int s_lo = lo / p.span;
  const int n_live = kend > lo ? (kend - 1) / p.span - s_lo + 1 : 0;
  const size_t obase = ((size_t)bg * p.rows + r0) * D;
  if (n_live == 0) {  // no key for any row: split 0 writes zeros
    if (split == 0)
      for (int r = warp; r < R; r += nw)
        for (int d = lane; d < D; d += 32)
          out[obase + (size_t)r * D + d] = from_f<TQ>(0.f);
    return;
  }
  if (split < s_lo || split >= s_lo + n_live) return;
  const int kb = max(split * p.span, lo);
  const int ke = min((split + 1) * p.span, kend);

  // [stage][K, V][TK][LD], then (int8) the scales [stage][K, V][TK]
  unsigned char* wring = rpa_smem + C::QBYTES + (size_t)warp * C::RING;
  TP* ring = reinterpret_cast<TP*>(wring);
  float* sring = reinterpret_cast<float*>(wring + C::KV);
  const int ntiles = (ke - kb + TK - 1) / TK;
  const int cnt = warp < ntiles ? (ntiles - 1 - warp) / nw + 1 : 0;
  if (cnt > 0) {
    const int t = kb + warp * TK + (lane >> 1);
    const bool live = t < ke;
    const int page =
        !live ? 0 : t == t_spec ? pg_spec : ptab[t / p.ps];
    load_tile<TP, C::LD>(ring, ring + TK * C::LD, sring, kp, vp, p, g, t,
                         page, live, lane);
  }
  cp_async_commit();

  // stage q's rows while the first tile flies
  const TQ* qg = q + obase;
  if constexpr (TILE) {
    TQ* qt = reinterpret_cast<TQ*>(rpa_smem);
    const int padded = ((D + 15) & ~15) * (int)sizeof(TQ);
    for (int r = warp; r < TILE_ROWS; r += nw)
      copy_row(qt + r * C::LDQ, qg + (size_t)(r < R ? r : 0) * D,
               r < R ? D * (int)sizeof(TQ) : 0, padded, p.qpiece, lane, 32);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    float* qf = reinterpret_cast<float*>(rpa_smem);
    for (int r = warp; r < RB; r += nw)
      for (int d = lane; d < DMAX; d += 32)
        qf[r * DMAX + d] = r < R && d < D ? to_f(qg[(size_t)r * D + d]) : 0.f;
  }
  __syncthreads();

  // each warp's walk: tiles warp, warp + nw, ... through its ring
  constexpr int NR = TILE ? 2 : RB;          // rows of this lane's state
  constexpr int NA = TILE ? DMAX / 8 : RB;   // accumulator rows
  constexpr int NC = TILE ? 4 : DMAX / 32;   // and columns
  int qpos[NR];
  float m[NR], l[NR], acc[NA][NC];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = TILE ? (lane >> 2) + 8 * i : i;
    qpos[i] = start + (r0 + r) % p.C;
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[i][k] = 0.f;
  for (int i = 0; i < cnt; ++i) {
    TP* ks = ring + (i & 1) * 2 * TK * C::LD;
    const float* scl = sring + (i & 1) * 2 * TK;
    if (i + 1 < cnt) {
      const int nxs = (i + 1) & 1;
      TP* nx = ring + nxs * 2 * TK * C::LD;
      const int t = kb + (warp + (i + 1) * nw) * TK + (lane >> 1);
      const bool live = t < ke;
      load_tile<TP, C::LD>(nx, nx + TK * C::LD, sring + nxs * 2 * TK, kp,
                           vp, p, g, t, live ? ptab[t / p.ps] : 0, live,
                           lane);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int t0 = kb + (warp + i * nw) * TK;
    if constexpr (TILE)
      tile_step<TQ, TP, DMAX>(reinterpret_cast<const TQ*>(rpa_smem), ks,
                              ks + TK * C::LD, scl, p, R, t0, ke, qpos, m, l,
                              acc, lane);
    else
      few_step<TQ, TP, DMAX, RB>(reinterpret_cast<const float*>(rpa_smem),
                                 ks, ks + TK * C::LD, scl, p, R, t0, ke, qpos,
                                 m, l, acc, lane);
    __syncwarp();  // this stage's readers are done before it is refilled
  }
  cp_async_wait<0>();

  // the warps' states into the merge area (over the rings)
  __syncthreads();
  float* am = reinterpret_cast<float*>(rpa_smem + C::QBYTES);
  float* ml = am + (size_t)nw * RB * DMAX;
  if constexpr (TILE) {
    const int gr = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = gr + 8 * h;
      float* ar = am + ((size_t)warp * RB + r) * DMAX;
#pragma unroll
      for (int n = 0; n < DMAX / 8; ++n)
        if (8 * n < D) {
          ar[8 * n + 2 * t4] = acc[n][2 * h];
          ar[8 * n + 2 * t4 + 1] = acc[n][2 * h + 1];
        }
      if (t4 == 0) {
        ml[(warp * RB + r) * 2] = m[h];
        ml[(warp * RB + r) * 2 + 1] = l[h];
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < R) {
        float* ar = am + ((size_t)warp * RB + r) * DMAX;
#pragma unroll
        for (int k = 0; k < DMAX / 32; ++k)
          if (lane + 32 * k < D) ar[lane + 32 * k] = acc[r][k];
        if (lane == 0) {
          ml[(warp * RB + r) * 2] = m[r];
          ml[(warp * RB + r) * 2 + 1] = l[r];
        }
      }
    }
  }
  __syncthreads();

  // the block's rows, warps merged in order: `out` when this is the only
  // live split, else this split's partial
  const bool direct = n_live == 1;
  const int grp = bg * p.row_tiles + rt;
  // a partial row: acc[D4], m, l, two floats of pad (16-byte rows)
  const int D4 = (D + 3) & ~3;
  const size_t prow = D4 + 4;
  float* part =
      p.ws + ((size_t)grp * p.nsplit + split) * p.row_tile * prow;
  for (int r = warp; r < R; r += nw) {
    float mm = -INFINITY;
    for (int w = 0; w < nw; ++w) mm = fmaxf(mm, ml[(w * RB + r) * 2]);
    float wt[MAX_WARPS], ll = 0.f;
#pragma unroll
    for (int w = 0; w < MAX_WARPS; ++w) {
      wt[w] = 0.f;
      if (w < nw) {
        const float mw = ml[(w * RB + r) * 2];
        wt[w] = mw == -INFINITY ? 0.f : expf(mw - mm);
        ll = fmaf(wt[w], ml[(w * RB + r) * 2 + 1], ll);
      }
    }
    for (int d = lane; d < D; d += 32) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < MAX_WARPS; ++w)
        if (wt[w] != 0.f)
          a = fmaf(wt[w], am[((size_t)w * RB + r) * DMAX + d], a);
      if (direct)
        out[obase + (size_t)r * D + d] = from_f<TQ>(ll == 0.f ? 0.f : a / ll);
      else
        part[r * prow + d] = a;
    }
    if (!direct && lane == 0) {
      part[r * prow + D4] = mm;
      part[r * prow + D4 + 1] = ll;
    }
  }
  if (direct || !arrive_last(p.tickets + grp, n_live)) return;

  // the last block to arrive: each row's split weights into shared
  // memory (over the merge area, which every warp has left), then the
  // live splits' partials summed in split order, 16 bytes a load
  const float* p0 =
      p.ws + ((size_t)grp * p.nsplit + s_lo) * p.row_tile * prow;
  const size_t sstride = (size_t)p.row_tile * prow;
  float* wts = reinterpret_cast<float*>(rpa_smem + C::QBYTES);  // [R][n]
  float* lsum = wts + R * n_live;                                // [R]
  for (int r = warp; r < R; r += nw) {
    const float* pr = p0 + r * prow + D4;
    float mm = -INFINITY;
    for (int s = lane; s < n_live; s += 32)
      mm = fmaxf(mm, __ldcg(pr + s * sstride));
    mm = warp_max(mm);
    float ll = 0.f;
    for (int s = lane; s < n_live; s += 32) {
      const float ms = __ldcg(pr + s * sstride);
      const float w = ms == -INFINITY ? 0.f : expf(ms - mm);
      wts[r * n_live + s] = w;
      ll = fmaf(w, __ldcg(pr + s * sstride + 1), ll);
    }
    ll = warp_sum(ll);
    if (lane == 0) lsum[r] = ll;
  }
  __syncthreads();
  const int nv = D4 / 4;
  for (int v = threadIdx.x; v < R * nv; v += blockDim.x) {
    const int r = v / nv, d = (v - r * nv) * 4;
    const float* pr = p0 + r * prow + d;
    const float* wr = wts + r * n_live;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int s = 0; s < n_live; ++s) {
      const float w = wr[s];
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(pr + s * sstride));
      a[0] = fmaf(w, x.x, a[0]);
      a[1] = fmaf(w, x.y, a[1]);
      a[2] = fmaf(w, x.z, a[2]);
      a[3] = fmaf(w, x.w, a[3]);
    }
    const float ll = lsum[r];
    TQ* o = out + obase + (size_t)r * D + d;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < D) o[e] = from_f<TQ>(ll == 0.f ? 0.f : a[e] / ll);
  }
  if (threadIdx.x == 0) p.tickets[grp] = 0u;
}

template <typename TQ, typename TP, int DMAX, int RB>
cudaError_t launch(const void* q, const void* kp, const void* vp, void* out,
                   const Params& p, int B, int warps, cudaStream_t stream) {
  using C = Cfg<TQ, TP, DMAX, RB>;
  const size_t smem = C::smem(warps);
  // the last block keeps each row's split weights over the rings
  if ((size_t)RB * (p.nsplit + 1) * 4 > smem - C::QBYTES)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    // opt in once per device, to the most this instantiation has asked
    static size_t opted[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (smem > opted[dev]) {
      e = cudaFuncSetAttribute(rpa_split_kernel<TQ, TP, DMAX, RB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return e;
      opted[dev] = smem;
    }
  }
  dim3 grid(B * p.Hkv, p.row_tiles, p.nsplit);
  rpa_split_kernel<TQ, TP, DMAX, RB><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), static_cast<TQ*>(out), p);
  return cudaGetLastError();
}

template <typename TQ, typename TP, int DMAX>
cudaError_t launch_rows(int rb, const void* q, const void* kp,
                        const void* vp, void* out, const Params& p, int B,
                        int warps, cudaStream_t s) {
  switch (rb) {
    case 1: return launch<TQ, TP, DMAX, 1>(q, kp, vp, out, p, B, warps, s);
    case 4: return launch<TQ, TP, DMAX, 4>(q, kp, vp, out, p, B, warps, s);
    case 15: return launch<TQ, TP, DMAX, 15>(q, kp, vp, out, p, B, warps, s);
    default:
      return launch<TQ, TP, DMAX, TILE_ROWS>(q, kp, vp, out, p, B, warps, s);
  }
}

template <typename TQ, typename TP>
cudaError_t launch_type(int D, int rb, const void* q, const void* kp,
                        const void* vp, void* out, const Params& p, int B,
                        int warps, cudaStream_t s) {
  if (D <= 64)
    return launch_rows<TQ, TP, 64>(rb, q, kp, vp, out, p, B, warps, s);
  if (D <= 128)
    return launch_rows<TQ, TP, 128>(rb, q, kp, vp, out, p, B, warps, s);
  return launch_rows<TQ, TP, 256>(rb, q, kp, vp, out, p, B, warps, s);
}

}  // namespace

// q (B, H, C, D) and the pools (num_pages, ps, Hkv, D), 16-byte aligned, in
// the types `types` names: 0 both f32, 1 both bf16, 2 f32 q over bf16
// pools, 3 f32 q over int8 pools, 4 bf16 q over int8 pools, whose f32
// scale planes k_scales / v_scales (num_pages, ps, Hkv) are given (null
// otherwise), 5 f32 q over f16 pools, 6 both f16; page_tables (B, maxp),
// ctx_lens (B,), start_pos (B,) int32; out (B, H, C, D) in q's type; all
// contiguous.  window < 0 means no window.  The launch plan: `tile` (the
// tensor-core variant, row_tile 16) or the few-rows variant (row_tile =
// rows < 16); `span` keys a split (a multiple of ps), `nsplit` splits,
// `warps` (1-4) a block; with nsplit (at most 128) > 1, `ws` holds B * Hkv
// * row tiles * nsplit * row_tile * (D4 + 4) floats (D4: D rounded up to
// 4), 16-byte aligned, and `tickets` B * Hkv * row tiles zeroed counters
// (left zeroed).  Any D up to 256.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int mxt_ragged_paged_attention(
    const void* q, const void* kpool, const void* vpool, const void* k_scales,
    const void* v_scales, const void* page_tables, const void* ctx_lens,
    const void* start_pos,
    void* out, int B, int H, int Hkv, int C, int D, int ps, int maxp,
    int window, float scale, int types, int tile, int row_tile, int span,
    int nsplit, int warps, void* ws, void* tickets, void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (B == 0 || C == 0) return 0;
  const int rows = (H / Hkv) * C;
  // the int8 variant's types, and the bytes of a pool and a query element
  const bool int8_pool = types == 3 || types == 4;
  const int pool_bytes = types == 0 ? 4 : int8_pool ? 1 : 2;
  const int q_bytes = types == 1 || types == 4 || types == 6 ? 2 : 4;
  if (D > MAX_D || D < 1 || warps < 1 || warps > MAX_WARPS || ps < 1 ||
      span < 1 || span % ps || nsplit < 1 || nsplit > MAX_SPLITS ||
      row_tile < 1 ||
      (tile ? row_tile != TILE_ROWS : row_tile > 15 || row_tile < rows) ||
      (nsplit > 1 && (ws == nullptr || tickets == nullptr)) || types < 0 ||
      types > 6 || !((MXT_RPA_TYPES >> types) & 1) ||
      (int8_pool && (k_scales == nullptr || v_scales == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.ksc = static_cast<const float*>(k_scales);
  p.vsc = static_cast<const float*>(v_scales);
  p.pt = static_cast<const int*>(page_tables);
  p.ctx = static_cast<const int*>(ctx_lens);
  p.start = static_cast<const int*>(start_pos);
  p.ws = static_cast<float*>(ws);
  p.tickets = static_cast<unsigned int*>(tickets);
  p.Hkv = Hkv;
  p.C = C;
  p.D = D;
  p.ps = ps;
  p.maxp = maxp;
  p.rows = rows;
  p.window = window;
  // the largest copy that divides a row's bytes (the pointers are 16-byte
  // aligned, so every row starts on such a boundary)
  auto piece = [](int bytes) {
    return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4
           : bytes % 2 == 0 ? 2 : 1;
  };
  p.kpiece = piece(D * pool_bytes);
  p.qpiece = piece(D * q_bytes);
  p.scale = scale;
  p.row_tile = row_tile;
  p.row_tiles = (rows + row_tile - 1) / row_tile;
  p.span = span;
  p.nsplit = nsplit;
  const int rb = tile ? TILE_ROWS : row_tile <= 1 ? 1 : row_tile <= 4 ? 4 : 15;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (types) {
#if MXT_RPA_TYPES & 1
    case 0:
      return (int)launch_type<float, float>(D, rb, q, kpool, vpool, out, p,
                                            B, warps, s);
#endif
#if MXT_RPA_TYPES & 2
    case 1:
      return (int)launch_type<__nv_bfloat16, __nv_bfloat16>(
          D, rb, q, kpool, vpool, out, p, B, warps, s);
#endif
#if MXT_RPA_TYPES & 4
    case 2:
      return (int)launch_type<float, __nv_bfloat16>(D, rb, q, kpool, vpool,
                                                    out, p, B, warps, s);
#endif
#if MXT_RPA_TYPES & 8
    case 3:
      return (int)launch_type<float, int8_t>(D, rb, q, kpool, vpool, out, p,
                                             B, warps, s);
#endif
#if MXT_RPA_TYPES & 16
    case 4:
      return (int)launch_type<__nv_bfloat16, int8_t>(D, rb, q, kpool, vpool,
                                                     out, p, B, warps, s);
#endif
#if MXT_RPA_TYPES & 32
    case 5:
      return (int)launch_type<float, __half>(D, rb, q, kpool, vpool, out, p,
                                             B, warps, s);
#endif
#if MXT_RPA_TYPES & 64
    case 6:
      return (int)launch_type<__half, __half>(D, rb, q, kpool, vpool, out, p,
                                              B, warps, s);
#endif
    default:
      return (int)cudaErrorInvalidValue;
  }
}
