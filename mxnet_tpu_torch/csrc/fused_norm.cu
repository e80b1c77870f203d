// Fused LayerNorm / RMSNorm (+ residual add) row kernel for Hopper (sm_90a):
// CUDA C++ with a plain C entry point.
//
// Replaces the Pallas TPU kernel of mxnet_tpu/ops/pallas/fused_norm.py:
// `_norm_kernel` (:79), launched by `_norm_pallas` (:128, `pallas_call` at
// :164).
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
// below the ridge.  At BERT's (8192, 768) in bf16 that is ~7.5 us, so what
// matters is keeping enough 16-byte loads in flight and nothing dependent
// on shared memory or barriers between a row's load and its store.
//
// Design.  The row is read from DRAM once and held in registers, as it
// was loaded (a 16-bit row in half the registers of a widened one), through
// both statistics passes and the output pass.  The host plans the launch
// (`ops/fused_norm.py` `_plan`) and picks one of two variants of this one
// kernel:
// - "warp" (rows of at most 32 elements a lane): a group of `lanes` lanes
//   of one warp (32 for BERT's 768; fewer for narrow rows) owns whole rows;
//   the statistics are reduced with xor shuffles inside the group only, no
//   shared memory and no __syncthreads.  gamma and beta are loaded into
//   registers once per thread and reused for every row the group takes.
//   A block takes `block_rows` consecutive rows (JAX's tunable), each of
//   its groups every (groups a block)-th of them.  With 16-bit rows in
//   16-byte loads a group loads its next row before it reduces this one,
//   so two rows' loads are in flight (bf16 (8192, 768) LayerNorm on an
//   H100, `chip_smoke.py` k5: 0.0203 -> 0.0182 ms; f32 rows would give up
//   the registers of a second block an SM and run slower, so they keep
//   one).
// - "block" (wider rows, e.g. 16384): the whole block shares one row, each
//   thread holding up to 32 of its elements; the reductions end in one
//   shared-memory step that every warp reads in the same order.  Persistent
//   blocks walk the rows.  Rows wider than 512 threads x 32 elements are
//   cut into tiles that each pass reads again (from L2): the only variant
//   that re-reads.
// Loads and stores are 16 bytes a lane where the row's bytes and the base
// pointers allow it, else one element (the planned narrow variant of the
// same kernel: a view at an odd storage offset, h * itemsize % 16 != 0).
// Each thread sums its elements in a fixed order and the shuffle / block
// trees are fixed, so two calls give the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// raw bits of a stored element, and its widening / rounding
template <typename T> struct Tr;
template <> struct Tr<float> {
  using R = unsigned;
  static __device__ __forceinline__ float f(R r) { return __uint_as_float(r); }
  static __device__ __forceinline__ R r(float x) { return __float_as_uint(x); }
};
template <> struct Tr<__nv_bfloat16> {
  using R = unsigned short;
  static __device__ __forceinline__ float f(R r) {
    return __uint_as_float((unsigned)r << 16);
  }
  static __device__ __forceinline__ R r(float x) {
    return __bfloat16_as_ushort(__float2bfloat16(x));  // nearest even
  }
};
template <> struct Tr<__half> {
  using R = unsigned short;
  static __device__ __forceinline__ float f(R r) {
    return __half2float(__ushort_as_half(r));
  }
  static __device__ __forceinline__ R r(float x) {
    return __half_as_ushort(__float2half(x));          // nearest even
  }
};

template <typename T, int VW>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  using R = typename Tr<T>::R;
  R* q = reinterpret_cast<R*>(p);
  if constexpr (VW * sizeof(R) == 16) {
    union { uint4 u; R r[VW]; } b;
#pragma unroll
    for (int j = 0; j < VW; ++j) b.r[j] = Tr<T>::r(f[j]);
    *reinterpret_cast<uint4*>(q) = b.u;
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j) q[j] = Tr<T>::r(f[j]);
  }
}

// VW consecutive parameters from element e of p, in p's type (0 f32,
// 1 bf16, 2 f16): 16-byte loads where they fit and the address is aligned,
// else one element at a time; the branches are uniform over the grid
template <int VW>
__device__ __forceinline__ void load_param(const void* p, int dt, int e,
                                           float* f) {
  if (dt == 0) {
    const float* q = static_cast<const float*>(p) + e;
    if constexpr (VW % 4 == 0) {
      if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) {
#pragma unroll
        for (int i = 0; i < VW / 4; ++i) {
          const float4 t = reinterpret_cast<const float4*>(q)[i];
          f[4 * i] = t.x;
          f[4 * i + 1] = t.y;
          f[4 * i + 2] = t.z;
          f[4 * i + 3] = t.w;
        }
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < VW; ++j) f[j] = q[j];
    return;
  }
  const unsigned short* q = static_cast<const unsigned short*>(p) + e;
  unsigned short r[VW];
  if constexpr (VW == 8) {
    if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) {
      union { uint4 u; unsigned short r[8]; } b;
      b.u = *reinterpret_cast<const uint4*>(q);
#pragma unroll
      for (int j = 0; j < 8; ++j) r[j] = b.r[j];
    } else {
#pragma unroll
      for (int j = 0; j < VW; ++j) r[j] = q[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j) r[j] = q[j];
  }
#pragma unroll
  for (int j = 0; j < VW; ++j)
    f[j] = dt == 1 ? Tr<__nv_bfloat16>::f(r[j]) : Tr<__half>::f(r[j]);
}

// One thread's slice of a row as it was loaded: a cell a vector (16 bytes
// as loaded, so a bf16 vector of 8 takes 4 registers, or one element).
// Elements are widened to f32 where they are used, so a 16-bit row costs
// half the registers a widened one would, which leaves room for the next
// row's loads.
template <typename T, int VW, int E>
struct Slice {
  using R = typename Tr<T>::R;
  static constexpr bool WIDE = VW * (int)sizeof(R) == 16;
  typename std::conditional<WIDE, uint4, R>::type c[E / VW];

  __device__ __forceinline__ void load(int k, const T* p) {
    if constexpr (WIDE) c[k] = *reinterpret_cast<const uint4*>(p);
    else c[k] = *reinterpret_cast<const R*>(p);
  }
  __device__ __forceinline__ float get(int k, int j) const {
    if constexpr (WIDE) {
      union { uint4 u; R r[VW]; } b;
      b.u = c[k];
      return Tr<T>::f(b.r[j]);
    } else {
      return Tr<T>::f(c[k]);
    }
  }
};

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

// Sum of v over an aligned group of `lanes` lanes (a power of two up to
// 32); every lane of the warp takes part, and every lane of a group ends
// with the same bits (a butterfly: each pair adds the same two values).
__device__ __forceinline__ float group_sum(float v, int lanes) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < lanes) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void *x, *res, *gamma, *beta;
  void *y, *s;
  long long rows;
  int h, p_dtype, rms;
  float inv_h, eps;
  int lanes;       // "warp": lanes a row (1-32); "block": the block's threads
  int nv;          // vectors a thread holds in one tile
  int tiles;       // passes of a thread over its vectors (1: in registers)
  int block_rows;  // "warp": rows a block
};

// One kernel, two variants (see the file's comment).  E: the most elements
// a thread holds (registers); VW: elements a load.
template <typename T, int VW, int E, bool BLOCK>
__global__ void __launch_bounds__(BLOCK ? 512 : 256)
norm_kernel(const Args a) {
  using Sl = Slice<T, VW, E>;
  constexpr int NVM = E / VW;
  // two rows in flight where a row as loaded takes half the registers of
  // a widened one (16-bit rows in 16-byte cells); f32 rows would spend the
  // registers that hold a second block on the SM
  constexpr bool PREFETCH = !BLOCK && Sl::WIDE && sizeof(T) == 2;
  __shared__ float red[32];
  const int h = a.h, nvec = h / VW, tid = threadIdx.x;
  const int lanes = a.lanes, nv = a.nv;
  const int sl = BLOCK ? tid : (tid & 31) & (lanes - 1);
  const int tile_q = lanes * nv;          // vectors of the row a tile
  const bool has_res = a.res != nullptr, has_beta = a.beta != nullptr;
  const T* __restrict__ X = static_cast<const T*>(a.x);
  const T* __restrict__ RS = static_cast<const T*>(a.res);
  T* __restrict__ Y = static_cast<T*>(a.y);
  T* __restrict__ S = static_cast<T*>(a.s);

  auto qof = [&](int t, int k) { return t * tile_q + k * lanes + sl; };
  auto valid = [&](bool active, int t, int k) {
    return active && k < nv && qof(t, k) < nvec;
  };

  // gamma and beta of this thread's elements, held across rows ("warp")
  float gam[BLOCK ? 1 : E], bet[BLOCK ? 1 : E];
  if constexpr (!BLOCK) {
#pragma unroll
    for (int k = 0; k < NVM; ++k) {
#pragma unroll
      for (int j = 0; j < VW; ++j) gam[k * VW + j] = bet[k * VW + j] = 0.f;
      if (valid(true, 0, k)) {
        load_param<VW>(a.gamma, a.p_dtype, qof(0, k) * VW, gam + k * VW);
        if (has_beta)
          load_param<VW>(a.beta, a.p_dtype, qof(0, k) * VW, bet + k * VW);
      }
    }
  }

  auto reduce = [&](float v) {
    if constexpr (BLOCK) return block_sum(v, red);
    else return group_sum(v, lanes);
  };
  // tile t of row r (x, and the residual) as loaded
  auto load = [&](Sl& xs, Sl& rs, long long r, int t, bool active) {
    const size_t base = (size_t)r * h;
#pragma unroll
    for (int k = 0; k < NVM; ++k) {
      if (!valid(active, t, k)) continue;
      const size_t at = base + (size_t)qof(t, k) * VW;
      xs.load(k, X + at);
      if (has_res) rs.load(k, RS + at);
    }
  };
  // s = x (+ residual) of vector k, element j, in f32
  auto val = [&](const Sl& xs, const Sl& rs, int k, int j) {
    const float v = xs.get(k, j);
    return has_res ? v + rs.get(k, j) : v;
  };

  // row r, its tile 0 (the whole row when tiles == 1) already in xs, rs;
  // `active` false only for a "warp" group past its block's rows (it
  // still joins its warp's shuffles)
  auto row = [&](Sl& xs, Sl& rs, long long r, bool active) {
    const size_t base = (size_t)r * h;
    // pass 1: s (written with a residual) and sum(s) or sum(s*s)
    float acc = 0.f;
    for (int t = 0; t < a.tiles; ++t) {
      if (t > 0) load(xs, rs, r, t, active);
#pragma unroll
      for (int k = 0; k < NVM; ++k) {
        if (!valid(active, t, k)) continue;
        float v[VW];
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          v[j] = val(xs, rs, k, j);
          acc += a.rms ? v[j] * v[j] : v[j];
        }
        if (has_res)
          store_vec<T, VW>(S + base + (size_t)qof(t, k) * VW, v);
      }
    }
    const float first = reduce(acc) * a.inv_h;
    float mean = 0.f, rstd;
    if (a.rms) {
      rstd = rsqrtf(first + a.eps);
    } else {
      // pass 2: the centred second moment about the exact mean
      mean = first;
      float sq = 0.f;
      for (int t = 0; t < a.tiles; ++t) {
        if (a.tiles > 1) load(xs, rs, r, t, active);
#pragma unroll
        for (int k = 0; k < NVM; ++k) {
          if (!valid(active, t, k)) continue;
#pragma unroll
          for (int j = 0; j < VW; ++j) {
            const float d = val(xs, rs, k, j) - mean;
            sq += d * d;
          }
        }
      }
      rstd = rsqrtf(reduce(sq) * a.inv_h + a.eps);
    }
    // pass 3: the output
    for (int t = 0; t < a.tiles; ++t) {
      if (a.tiles > 1) load(xs, rs, r, t, active);
#pragma unroll
      for (int k = 0; k < NVM; ++k) {
        if (!valid(active, t, k)) continue;
        const int q = qof(t, k);
        float g[VW], b[VW], o[VW];
        if constexpr (BLOCK) {
          load_param<VW>(a.gamma, a.p_dtype, q * VW, g);
          if (has_beta) load_param<VW>(a.beta, a.p_dtype, q * VW, b);
        } else {
#pragma unroll
          for (int j = 0; j < VW; ++j) {
            g[j] = gam[k * VW + j];
            b[j] = bet[k * VW + j];
          }
        }
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          o[j] = (val(xs, rs, k, j) - mean) * rstd * g[j];
          if (has_beta) o[j] += b[j];
        }
        store_vec<T, VW>(Y + base + (size_t)q * VW, o);
      }
    }
  };

  if constexpr (BLOCK) {
    for (long long r = blockIdx.x; r < a.rows; r += gridDim.x) {
      Sl xs, rs;
      load(xs, rs, r, 0, true);
      row(xs, rs, r, true);
    }
  } else {
    const int warp = tid >> 5, gpw = 32 / lanes, gl = (tid & 31) / lanes;
    const int groups = (int)(blockDim.x >> 5) * gpw;
    const long long b0 = (long long)blockIdx.x * a.block_rows;
    const long long end = b0 + a.block_rows < a.rows ? b0 + a.block_rows
                                                     : a.rows;
    // the warp's first row a round is the same for its every lane, so the
    // loop (and every shuffle in it) is uniform over the warp
    long long rw = b0 + (long long)warp * gpw;
    if constexpr (!PREFETCH) {
      for (; rw < end; rw += groups) {
        const long long r = rw + gl;
        Sl xs, rs;
        load(xs, rs, r, 0, r < end);
        row(xs, rs, r, r < end);
      }
    } else {
      // 16-bit rows: the next round's row is loaded before this round's
      // reductions
      if (rw >= end) return;
      long long r = rw + gl;
      bool act = r < end;
      Sl xs, rs;
      load(xs, rs, r, 0, act);
      for (;;) {
        const long long rn = rw + groups;
        const bool more = rn < end;
        const long long r2 = rn + gl;
        const bool act2 = more && r2 < end;
        Sl xn, rn_;
        if (more) load(xn, rn_, r2, 0, act2);
        row(xs, rs, r, act);
        if (!more) break;
        xs = xn;
        rs = rn_;
        rw = rn;
        r = r2;
        act = act2;
      }
    }
  }
}

template <typename T, int VW, int E, bool BLOCK>
cudaError_t launch(const Args& a, int threads, int grid, cudaStream_t st) {
  norm_kernel<T, VW, E, BLOCK><<<grid, threads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int VW>
cudaError_t launch_e(const Args& a, int block, int elems, int threads,
                     int grid, cudaStream_t st) {
  if (block) {
    if (elems == 32) return launch<T, VW, 32, true>(a, threads, grid, st);
    return cudaErrorInvalidValue;
  }
  switch (elems) {
    case 8: return launch<T, VW, 8, false>(a, threads, grid, st);
    case 16: return launch<T, VW, 16, false>(a, threads, grid, st);
    case 24: return launch<T, VW, 24, false>(a, threads, grid, st);
    case 32: return launch<T, VW, 32, false>(a, threads, grid, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_t(const Args& a, int block, int vec, int elems,
                     int threads, int grid, cudaStream_t st) {
  constexpr int WIDE = 16 / (int)sizeof(T);
  if (vec == WIDE)
    return launch_e<T, WIDE>(a, block, elems, threads, grid, st);
  if (vec == 1) return launch_e<T, 1>(a, block, elems, threads, grid, st);
  return cudaErrorInvalidValue;
}

bool misaligned(const void* p) {
  return p != nullptr && (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

}  // namespace

// x, res (may be null), y, s (null unless res is given): (rows, h) in the
// type x_dtype (0 f32, 1 bf16, 2 f16); gamma, beta (may be null): (h,) in
// p_dtype.  All contiguous.  rms selects RMSNorm.  The launch plan of
// `_plan` (ops/fused_norm.py): variant 0 "warp" / 1 "block", threads a
// block, lanes a row (the block's threads for "block"), vec elements a
// load (16 bytes, or 1), nv vectors a thread a tile, elems registers a
// thread (the template), tiles a row, block_rows rows a block ("warp") and
// the grid.  A plan that does not cover the row, or 16-byte loads from a
// pointer that is not 16-byte aligned, is refused.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int mxt_fused_norm(const void* x, const void* res,
                              const void* gamma, const void* beta, void* y,
                              void* s, long long rows, int h, int x_dtype,
                              int p_dtype, int rms, float eps, int variant,
                              int threads, int lanes, int vec, int nv,
                              int elems, int tiles, int block_rows, int grid,
                              void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (rows == 0) return 0;
  const int item = x_dtype == 0 ? 4 : 2;
  const bool block = variant == 1;
  if (h < 1 || rows < 0 || (res != nullptr) != (s != nullptr) ||
      x_dtype < 0 || x_dtype > 2 || p_dtype < 0 || p_dtype > 2 ||
      variant < 0 || variant > 1 || vec < 1 || h % vec != 0 || nv < 1 ||
      nv * vec > elems || tiles < 1 || grid < 1 || threads < 32 ||
      threads % 32 != 0 || threads > (block ? 512 : 256))
    return (int)cudaErrorInvalidValue;
  if (vec > 1 && (vec * item != 16 || misaligned(x) || misaligned(res) ||
                  misaligned(y) || misaligned(s)))
    return (int)cudaErrorInvalidValue;
  if (block) {
    if (lanes != threads || (long long)tiles * threads * nv * vec < h)
      return (int)cudaErrorInvalidValue;
  } else {
    if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
        tiles != 1 || (long long)lanes * nv * vec < h || block_rows < 1 ||
        (long long)grid * block_rows < rows)
      return (int)cudaErrorInvalidValue;
  }
  Args a{x, res, gamma, beta, y, s, rows, h, p_dtype, rms,
         (float)(1.0 / h), eps, lanes, nv, tiles, block_rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (x_dtype) {
    case 0: err = launch_t<float>(a, block, vec, elems, threads, grid, st);
            break;
    case 1: err = launch_t<__nv_bfloat16>(a, block, vec, elems, threads,
                                          grid, st);
            break;
    default: err = launch_t<__half>(a, block, vec, elems, threads, grid, st);
  }
  return (int)err;
}
