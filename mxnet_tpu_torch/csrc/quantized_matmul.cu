// Weight-only int8/int4 dequant-matmul (K2) for Hopper (sm_90a), CUDA C++
// with a plain C entry.
//
// Replaces the Pallas TPU kernel `_qmm_kernel(bits)` launched by `_qmm_pallas`
// (mxnet_tpu/ops/pallas/quantized_matmul.py:262, :341):
//   out (M, N) = x (M, K) @ deq(W)^T,   deq(W)[n, k] = q[n, k] * scale[n]
// with int8 planes q (N, K), or int4 planes packed two per byte (N, ceil(K/2))
// -- byte j holds value 2j in its low nibble and 2j+1 in its high nibble, two's
// complement.  Accumulation is f32; the per-channel scale multiplies the f32
// sum once in the epilogue, so the dense weight never exists in device memory.
// x is f32, bf16 or f16; out has x's type.
//
// What bounds it on the H100, and what the design does about it.  The host
// picks one of two variants and a split-K factor (`_plan` in
// ops/quantized_matmul.py) and passes them in.
//
// * Small M (M <= 16, the decode step's slots): bound by the weight bytes,
//   N * K * bits / 8 read once from HBM at 3.35 TB/s -- (2304, 768) int8 is
//   1.77 MB, 0.53 us -- so the kernel is a stream.  A block owns 8 output
//   channels and one K-chunk; half a warp (16 lanes) walks one weight row,
//   each lane loading 16 bytes (16 int8 or 32 int4 values) at a time,
//   neighbouring lanes on neighbouring bytes, all its loads issued before any
//   product.  The block stages its chunk of x in shared memory once, with
//   vector loads, in a lane-interleaved layout that makes each lane's 16-byte
//   reads conflict-free; all 8 channels reuse it.  The 16 lanes of a row
//   reduce by warp shuffle.  The grid splits K until it holds several blocks
//   per SM (N = 768 alone gives only 96 blocks of 8 channels).
// * Large M (the prefill chunk's M = 8 slots x 16 = 128): bytes and, for f32
//   x, the tensor cores' TF32 rate taken twice a product (half of 495
//   TFLOP/s dense: (128, 3072, 768) is 0.60 GFLOP, 2.4 us, against 1.3 us of
//   bytes).  A 64 x 64 output tile per block of 4
//   warps, K in steps of 32; x and weight tiles arrive by 16-byte cp.async
//   into a three-stage ring in shared memory and the weight is converted
//   to the operand type in registers.  An int8 or int4 value is exact in bf16
//   (8 significant bits), in f16 and in TF32 (11), so: bf16 or f16 x runs
//   mma.sync m16n8k16 in its own type with f32 accumulation, every product
//   exact; f32 x is split into
//   hi + lo, both TF32, and runs two m16n8k8 TF32 mma.syncs a tile (relative
//   error about 2^-22; plain TF32 would keep three digits).  The grid splits
//   K wherever the tile grid is under one wave.
//
// Split K never uses float atomics: each split writes its partial tile to a
// workspace, and the last block of an output tile to arrive (an integer
// ticket, as fused_optimizer.cu reduces LAMB's norms) sums the partials in
// split order and writes out -- two calls give the same bits.  The ticket
// counters start at zero and the last block puts its counter back to zero;
// the wrapper keeps one set a stream, so concurrent launches never share.
// Rows or pointers that are not 16-byte aligned (K = 33, an odd packed int4
// width) take scalar loads instead of the vector ones; ragged M, N and K
// edges are masked to zero.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "mma_sm90.cuh"   // cp.async, mma.sync, pack2, mma16, arrive_last

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
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);  // nearest even; +-inf past the range
}

// four consecutive x values (8 bytes of a 16-bit type) as floats: bf16 is
// the top half of an f32, f16 is not, so each type widens its own way
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* src) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 widen4(const __half* src) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 widen4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
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

// signed byte e (0..3) and signed nibble i (0..7) of a 32-bit word
__device__ __forceinline__ float byte_of(uint32_t w, int e) {
  return (float)((int)(w << (24 - 8 * e)) >> 24);
}
__device__ __forceinline__ float nibble_of(uint32_t w, int i) {
  return (float)((int)(w << (28 - 4 * i)) >> 28);
}

// ---------------------------------------------------------------------------
// small M: the streaming kernel
// ---------------------------------------------------------------------------

constexpr int SM_THREADS = 128;
constexpr int SM_LPR = 16;                          // lanes per weight row
constexpr int SM_ROWS = SM_THREADS / SM_LPR;        // 8 channels a block
constexpr int SM_UNROLL = 4;                        // 16-byte loads in flight

// x chunk (MT x kc, f32) in shared memory.  With VEC, value k of the chunk,
// k = SPAN*s + VPL*l + 4*j + e (lane l of the row, its j-th group of four),
// sits at word SPAN*s + 4*SM_LPR*j + 4*l + e: for each j the 16 lanes read
// 16 consecutive float4s.  Without VEC the layout is plain.
template <typename T, int BITS, int MT, bool VEC>
__global__ void __launch_bounds__(SM_THREADS, 5)
qmm_small(const T* __restrict__ x, const int8_t* __restrict__ q,
          const float* __restrict__ scale, T* __restrict__ out,
          float* __restrict__ ws, unsigned int* __restrict__ counters, int M,
          int N, int K, int Kp, int kc) {
  extern __shared__ float4 xs4[];
  float* xs = reinterpret_cast<float*>(xs4);
  constexpr int VPL = BITS == 8 ? 16 : 32;          // values a 16-byte load
  constexpr int SPAN = SM_LPR * VPL;
  const int S = gridDim.y, s = blockIdx.y;
  const int k0 = s * kc;
  const int klen = min(kc, K - k0);
  const int tid = threadIdx.x, l = tid & (SM_LPR - 1);
  const int row = blockIdx.x * SM_ROWS + tid / SM_LPR;

  // the first SM_UNROLL weight vectors of this lane are in flight before x
  // is staged, so the two trips to memory overlap
  const bool live = row < N && klen > 0;
  const int8_t* wrow = q + (size_t)min(row, N - 1) * Kp;
  const int4* wv = reinterpret_cast<const int4*>(wrow + k0 * BITS / 8);
  const int nvec = VEC && live ? (klen * BITS / 8 + 15) / 16 : 0;
  int4 w[SM_UNROLL];
#pragma unroll
  for (int u = 0; u < SM_UNROLL; ++u) {
    const int v = u * SM_LPR + l;
    w[u] = v < nvec ? __ldg(wv + v) : make_int4(0, 0, 0, 0);
  }

  // stage x[:, k0 : k0 + kc) (zero past M and K); unrolled, so a thread's
  // loads are in flight together
  if (VEC) {
    const int c4 = kc / 4;
#pragma unroll 8
    for (int i = tid; i < MT * c4; i += SM_THREADS) {
      const int m = i / c4, k = 4 * (i - m * c4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M && k < klen) {
        v = widen4(x + (size_t)m * K + k0 + k);
      }
      const int sp = k / SPAN, r = k - sp * SPAN;
      const int ll = r / VPL, j = (r - ll * VPL) / 4;
      xs4[(m * kc + sp * SPAN + 4 * SM_LPR * j + 4 * ll) / 4] = v;
    }
  } else {
#pragma unroll 8
    for (int i = tid; i < MT * kc; i += SM_THREADS) {
      const int m = i / kc, k = i - m * kc;
      xs[i] = (m < M && k < klen) ? to_f(x[(size_t)m * K + k0 + k]) : 0.f;
    }
  }
  __syncthreads();

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  if (VEC) {
    for (int v0 = 0; v0 < nvec; v0 += SM_LPR * SM_UNROLL) {
#pragma unroll
      for (int u = 0; u < SM_UNROLL; ++u) {
        const int v = v0 + u * SM_LPR + l;
        if (v >= nvec) break;
        const int base = (v / SM_LPR) * SPAN + 4 * l;
        const uint32_t wd[4] = {(uint32_t)w[u].x, (uint32_t)w[u].y,
                                (uint32_t)w[u].z, (uint32_t)w[u].w};
#pragma unroll
        for (int j = 0; j < VPL / 4; ++j) {
          float f[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            f[e] = BITS == 8 ? byte_of(wd[j], e)
                             : nibble_of(wd[j / 2], 4 * (j & 1) + e);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float4 xv = xs4[(m * kc + base + 4 * SM_LPR * j) / 4];
            acc[m] = fmaf(f[0], xv.x, acc[m]);
            acc[m] = fmaf(f[1], xv.y, acc[m]);
            acc[m] = fmaf(f[2], xv.z, acc[m]);
            acc[m] = fmaf(f[3], xv.w, acc[m]);
          }
        }
      }
      // the next batch (long chunks only: the planned splits need one)
#pragma unroll
      for (int u = 0; u < SM_UNROLL; ++u) {
        const int v = v0 + (SM_UNROLL + u) * SM_LPR + l;
        w[u] = v < nvec ? __ldg(wv + v) : make_int4(0, 0, 0, 0);
      }
    }
  } else if (live) {
#pragma unroll 4
    for (int k = l; k < klen; k += SM_LPR) {
      const float wk = weight_at<BITS>(wrow, k0 + k);
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m] = fmaf(wk, xs[m * kc + k], acc[m]);
    }
  }

  // the 16 lanes of a row (half a warp) reduce; lane m then holds row m
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int off = SM_LPR / 2; off > 0; off >>= 1)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
  }
  float mine = 0.f;
#pragma unroll
  for (int m = 0; m < MT; ++m)
    if (m == l) mine = acc[m];
  const bool owner = row < N && l < M;

  if (S == 1) {
    if (owner) out[(size_t)l * N + row] = from_f<T>(mine * scale[row]);
    return;
  }
  if (owner) ws[((size_t)s * M + l) * N + row] = mine;
  if (!arrive_last(counters + blockIdx.x, S)) return;
  for (int i = tid; i < SM_ROWS * M; i += SM_THREADS) {
    const int m = i / SM_ROWS, n = blockIdx.x * SM_ROWS + (i - m * SM_ROWS);
    if (n >= N) continue;
    float sum = 0.f;
#pragma unroll 4
    for (int t = 0; t < S; ++t)  // split order: the same bits every call
      sum += __ldcg(ws + ((size_t)t * M + m) * N + n);
    out[(size_t)m * N + n] = from_f<T>(sum * scale[n]);
  }
  if (tid == 0) counters[blockIdx.x] = 0u;
}

// ---------------------------------------------------------------------------
// large M: the tensor-core tile kernel
// ---------------------------------------------------------------------------

constexpr int LG_BM = 64, LG_BN = 64, LG_BK = 32, LG_THREADS = 128;
constexpr int LG_STAGES = 3;   // tiles in the ring: two loads in flight
constexpr int LG_BS = 48;    // weight tile row stride, bytes (conflict-free)

// x tile row stride in elements: f32 36 words, bf16 and f16 20 words --
// the fragment reads of a warp then hit 32 distinct banks
template <typename T> struct XStride { static constexpr int v = 36; };
template <> struct XStride<__nv_bfloat16> { static constexpr int v = 40; };
template <> struct XStride<__half> { static constexpr int v = 40; };

// weight values k and k+1 of a row of the smem tile (k even), as a pair of
// the 16-bit x type T (exact: |value| <= 127 has 7 significant bits)
template <typename T, int BITS>
__device__ __forceinline__ uint32_t w_pair(const int8_t* r, int k) {
  float a, b;
  if (BITS == 8) {
    const int h = *reinterpret_cast<const int16_t*>(r + k);
    a = (float)(int8_t)(h & 0xff);
    b = (float)(h >> 8);
  } else {
    const int v = r[k >> 1];
    a = (float)((int)(int8_t)(v << 4) >> 4);
    b = (float)(v >> 4);
  }
  return pack2<T>(a, b);  // .x (low half) = k
}

// weight value k of a row of the smem tile, as TF32 (exact)
template <int BITS>
__device__ __forceinline__ uint32_t w_tf32(const int8_t* r, int k) {
  float f;
  if (BITS == 8) {
    f = (float)r[k];
  } else {
    const int v = r[k >> 1];
    f = (float)((k & 1) ? (v >> 4) : ((int)(int8_t)(v << 4) >> 4));
  }
  return __float_as_uint(f);
}

template <typename T, int BITS, bool ALIGNED>
__global__ void __launch_bounds__(LG_THREADS)
qmm_large(const T* __restrict__ x, const int8_t* __restrict__ q,
          const float* __restrict__ scale, T* __restrict__ out,
          float* __restrict__ ws, unsigned int* __restrict__ counters, int M,
          int N, int K, int Kp, int kc) {
  constexpr int XS = XStride<T>::v;
  constexpr bool B16 = sizeof(T) == 2;   // bf16 or f16 x
  constexpr int WB = LG_BK * BITS / 8;             // weight bytes a tile row
  __shared__ __align__(16) T xs[LG_STAGES][LG_BM][XS];
  __shared__ __align__(16) int8_t wsm[LG_STAGES][LG_BN][LG_BS];

  const int S = gridDim.z, s = blockIdx.z;
  const int n0 = blockIdx.x * LG_BN, m0 = blockIdx.y * LG_BM;
  const int k0 = s * kc;
  const int klen = max(0, min(kc, K - k0));
  const int nk = (klen + LG_BK - 1) / LG_BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  auto load_tile = [&](int kt, int buf) {
    const int kb = k0 + kt * LG_BK;                 // first value
    if (ALIGNED) {
      constexpr int XC = LG_BK * (int)sizeof(T) / 16;   // chunks a row
      for (int i = tid; i < LG_BM * XC; i += LG_THREADS) {
        const int r = i / XC, c = i - r * XC;
        const int gm = m0 + r, gk = kb + c * (16 / (int)sizeof(T));
        const int bytes =
            gm < M ? max(0, min(16, (K - gk) * (int)sizeof(T))) : 0;
        const T* src = bytes > 0 ? x + (size_t)gm * K + gk : x;
        cp_async16(&xs[buf][r][c * (16 / (int)sizeof(T))], src, bytes);
      }
      constexpr int WC = WB / 16;
      for (int i = tid; i < LG_BN * WC; i += LG_THREADS) {
        const int r = i / WC, c = i - r * WC;
        const int gn = n0 + r, gb = kb * BITS / 8 + c * 16;
        const int bytes = gn < N ? max(0, min(16, Kp - gb)) : 0;
        const int8_t* src = bytes > 0 ? q + (size_t)gn * Kp + gb : q;
        cp_async16(&wsm[buf][r][c * 16], src, bytes);
      }
    } else {
      for (int i = tid; i < LG_BM * LG_BK; i += LG_THREADS) {
        const int r = i / LG_BK, c = i - r * LG_BK;
        const int gm = m0 + r, gk = kb + c;
        xs[buf][r][c] = (gm < M && gk < K) ? x[(size_t)gm * K + gk]
                                           : from_f<T>(0.f);
      }
      for (int i = tid; i < LG_BN * WB; i += LG_THREADS) {
        const int r = i / WB, c = i - r * WB;
        const int gn = n0 + r, gb = kb * BITS / 8 + c;
        wsm[buf][r][c] = (gn < N && gb < Kp) ? q[(size_t)gn * Kp + gb] : 0;
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

#pragma unroll
  for (int st = 0; st < LG_STAGES - 1; ++st) {
    if (st < nk) load_tile(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt % LG_STAGES;
    cp_async_wait<LG_STAGES - 2>();   // tile kt has landed
    __syncthreads();                  // ... for every thread; and tile
                                      // kt - 1's buffer is free again
    if (kt + LG_STAGES - 1 < nk)
      load_tile(kt + LG_STAGES - 1, (kt + LG_STAGES - 1) % LG_STAGES);
    cp_async_commit();
    if constexpr (B16) {
#pragma unroll
      for (int kk = 0; kk < LG_BK; kk += 16) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const T* r0 = &xs[buf][wm + mt * 16 + g][kk + 2 * t];
          const T* r8 = r0 + 8 * XS;
          a[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(r8);
          a[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
          a[mt][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int8_t* wr = wsm[buf][wn + nt * 8 + g];
          b[nt][0] = w_pair<T, BITS>(wr, kk + 2 * t);
          b[nt][1] = w_pair<T, BITS>(wr, kk + 2 * t + 8);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma16<T>(acc[mt][nt], a[mt], b[nt]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < LG_BK; kk += 8) {
        uint32_t hi[2][4], lo[2][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wm + mt * 16 + g;
          const float f[4] = {to_f(xs[buf][r][kk + t]),
                              to_f(xs[buf][r + 8][kk + t]),
                              to_f(xs[buf][r][kk + t + 4]),
                              to_f(xs[buf][r + 8][kk + t + 4])};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            hi[mt][i] = to_tf32(f[i]);
            lo[mt][i] = to_tf32(f[i] - __uint_as_float(hi[mt][i]));
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int8_t* wr = wsm[buf][wn + nt * 8 + g];
          b[nt][0] = w_tf32<BITS>(wr, kk + t);
          b[nt][1] = w_tf32<BITS>(wr, kk + t + 4);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_tf32(acc[mt][nt], lo[mt], b[nt]);
            mma_tf32(acc[mt][nt], hi[mt], b[nt]);
          }
      }
    }
  }
  cp_async_wait<0>();

  // fragment (mt, nt, i): row wm + 16 mt + g + 8 (i >> 1), col wn + 8 nt +
  // 2 t + (i & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gm = m0 + wm + mt * 16 + g + 8 * (i >> 1);
        const int gn = n0 + wn + nt * 8 + 2 * t + (i & 1);
        if (gm >= M || gn >= N) continue;
        if (S == 1)
          out[(size_t)gm * N + gn] = from_f<T>(acc[mt][nt][i] * scale[gn]);
        else
          ws[((size_t)s * M + gm) * N + gn] = acc[mt][nt][i];
      }
  if (S == 1) return;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (!arrive_last(counters + tile, S)) return;
  // each thread sums 32 outputs, all 32 loads of a split in flight at once
  constexpr int PER = LG_BM * LG_BN / LG_THREADS;
  float sum[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) sum[e] = 0.f;
  for (int u = 0; u < S; ++u) {     // split order: the same bits every call
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * LG_THREADS;
      const int gm = m0 + i / LG_BN, gn = n0 + i % LG_BN;
      if (gm < M && gn < N)
        sum[e] += __ldcg(ws + ((size_t)u * M + gm) * N + gn);
    }
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = tid + e * LG_THREADS;
    const int gm = m0 + i / LG_BN, gn = n0 + i % LG_BN;
    if (gm < M && gn < N)
      out[(size_t)gm * N + gn] = from_f<T>(sum[e] * scale[gn]);
  }
  if (tid == 0) counters[tile] = 0u;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// the small variant's x chunk: dynamic shared memory beside the static
// ticket flag stays under the 48 KB a launch gets without opting in
constexpr int SMEM_LIMIT = 40 * 1024;

struct Args {
  const void* x;
  const void* q;
  const float* scale;
  void* out;
  float* ws;
  unsigned int* counters;
  int M, N, K, Kp, kc, S;
  bool aligned;
};

template <typename T, int BITS, int MT, bool VEC>
cudaError_t small_mt(const Args& a, cudaStream_t st) {
  const size_t smem = (size_t)MT * a.kc * sizeof(float);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  dim3 grid((a.N + SM_ROWS - 1) / SM_ROWS, a.S);
  qmm_small<T, BITS, MT, VEC><<<grid, SM_THREADS, smem, st>>>(
      static_cast<const T*>(a.x), static_cast<const int8_t*>(a.q), a.scale,
      static_cast<T*>(a.out), a.ws, a.counters, a.M, a.N, a.K, a.Kp, a.kc);
  return cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t launch_small(const Args& a, cudaStream_t st) {
  // the vector path needs 16-byte aligned weight rows and x rows
  const int granule = SM_LPR * (BITS == 8 ? 16 : 32);
  if (a.M > 16 || a.kc % granule) return cudaErrorInvalidValue;
  const bool vec = a.aligned;
  if (a.M <= 8)
    return vec ? small_mt<T, BITS, 8, true>(a, st)
               : small_mt<T, BITS, 8, false>(a, st);
  return vec ? small_mt<T, BITS, 16, true>(a, st)
             : small_mt<T, BITS, 16, false>(a, st);
}

template <typename T, int BITS>
cudaError_t launch_large(const Args& a, cudaStream_t st) {
  if (a.kc % LG_BK) return cudaErrorInvalidValue;
  dim3 grid((a.N + LG_BN - 1) / LG_BN, (a.M + LG_BM - 1) / LG_BM, a.S);
  auto* kern = a.aligned ? qmm_large<T, BITS, true> : qmm_large<T, BITS, false>;
  kern<<<grid, LG_THREADS, 0, st>>>(
      static_cast<const T*>(a.x), static_cast<const int8_t*>(a.q), a.scale,
      static_cast<T*>(a.out), a.ws, a.counters, a.M, a.N, a.K, a.Kp, a.kc);
  return cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t launch(const Args& a, int variant, cudaStream_t st) {
  return variant == 0 ? launch_small<T, BITS>(a, st)
                      : launch_large<T, BITS>(a, st);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x (M, K) in the type `x_dtype` names (0 f32, 1 bf16, 2 f16, as
// ops/fused_norm.py numbers them); q int8 (N, K) for bits 8 or packed int4
// (N, ceil(K/2)) for bits 4; scale (N,) f32; out (M, N) in x's type.  All
// contiguous; the caller checks shapes.  variant 0 is the small-M stream
// (M <= 16), 1 the tensor-core tile kernel; kc is the K values a split
// covers (a multiple of 256 int8 / 512 int4 values for variant 0, of 32 for
// variant 1), so splits = ceil(K / kc).  With more than one split, ws holds
// splits * M * N f32 partials and counters one zeroed uint32 per output tile
// (ceil(N / 8) for variant 0, ceil(M / 64) * ceil(N / 64) for variant 1),
// left zeroed.  Returns the launch's cudaError_t.
extern "C" int mxt_quantized_matmul(const void* x, const void* q,
                                    const void* scale, void* out, int M,
                                    int N, int K, int bits, int x_dtype,
                                    int variant, int kc, void* ws,
                                    void* counters, void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (M == 0 || N == 0) return 0;
  if ((bits != 4 && bits != 8) || (variant != 0 && variant != 1) ||
      kc <= 0 || x_dtype < 0 || x_dtype > 2)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.q = q;
  a.scale = static_cast<const float*>(scale);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<unsigned int*>(counters);
  a.M = M;
  a.N = N;
  a.K = K;
  a.Kp = bits == 4 ? (K + 1) / 2 : K;
  a.kc = kc;
  a.S = K > 0 ? (K + kc - 1) / kc : 1;
  if (a.S > 1 && (ws == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  // 16-byte vectors need aligned weight rows and x rows (8 values a row of
  // 16-bit x is 16 bytes; the small variant stages four at a time)
  a.aligned = aligned16(x) && aligned16(q) && a.Kp % 16 == 0 && K % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_dtype == 1)
    e = bits == 8 ? launch<__nv_bfloat16, 8>(a, variant, s)
                  : launch<__nv_bfloat16, 4>(a, variant, s);
  else if (x_dtype == 2)
    e = bits == 8 ? launch<__half, 8>(a, variant, s)
                  : launch<__half, 4>(a, variant, s);
  else
    e = bits == 8 ? launch<float, 8>(a, variant, s)
                  : launch<float, 4>(a, variant, s);
  return (int)e;
}
